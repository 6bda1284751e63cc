"""Atomic, async checkpoints of trees of tensors (the port of
`repro.checkpoint.checkpointer`), in the JAX package's on-disk format:

    <dir>/step_<N>/manifest.json      leaf count, crc32 per leaf, extra keys
    <dir>/step_<N>/leaf_<i>.npy       one numpy file per leaf
    <dir>/LATEST                      the newest step (written last)

so that each package restores the other's checkpoints.

  * Leaf order: NamedTuples in field order, tuples and lists in order,
    dicts by sorted key, ``None`` no leaf; anything else is a leaf. This
    is the order `jax.tree.flatten` gives, so leaf i means the same thing
    on both sides. The manifest's ``treedef`` string is informational;
    neither side parses it.
  * Leaves are written as the numpy arrays they are on the host: tensors
    in their own dtype. A caller that must match the JAX package's dtype
    hands the leaf over in it (`Simulator.save` writes the threefry key
    as the JAX package's two uint32 words, `rng.key_data`).
  * Atomic: a step is staged under ``.tmp_step_*`` and renamed when
    complete, LATEST is replaced after the rename, stale staging
    directories of a crashed writer are swept by the next save, and
    ``keep_last`` prunes old steps.
  * Verified: each leaf's crc32 is recorded; `restore` raises
    `CheckpointCorruption` on a mismatch, and `restore_latest` prunes a
    corrupt step and falls back to the newest intact one.
  * `restore` rebuilds the template's structure. A template tensor gets a
    tensor on its device and in its dtype (an exact widening only, such
    as the key's uint32 to int64); any other template leaf gets the
    numpy array.
  * Sharded leaves (DTensors, an LM mesh): every rank of the mesh calls
    `save` / `save_async` (the leaves are gathered to their full tensors,
    a collective), and the mesh's first rank alone writes, once per
    checkpoint: the files hold the JAX tree, whatever the mesh. A DTensor
    template leaf is restored into its placements, each rank keeping its
    shard of the full leaf.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

log = logging.getLogger("repro_torch.checkpoint")


class CheckpointCorruption(RuntimeError):
    """A step directory whose leaf bytes no longer match the checksums its
    manifest recorded at save time (torn write, bit rot, tampering).
    Raised by `restore`; `restore_latest` falls back past it."""


def _flatten(tree):
    """(leaves, treedef string) in `jax.tree.flatten`'s order."""
    leaves = []

    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (tuple, list)):
            inner = ", ".join(walk(v) for v in t)
            if hasattr(t, "_fields"):
                return f"{type(t).__name__}({inner})"
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def _unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves`` (an iterator)."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        vals = [_unflatten(v, leaves) for v in template]
        if hasattr(template, "_fields"):
            return type(template)(*vals)
        return type(template)(vals)
    return next(leaves)


def _full(leaves):
    """The leaves with each DTensor gathered to its full tensor (a
    collective: every rank of its mesh calls this in the same order), and
    whether this rank writes them: the first rank of the mesh does, and
    every rank does where no leaf is sharded."""
    from torch.distributed.tensor import DTensor
    writes = True
    out = []
    for v in leaves:
        if isinstance(v, DTensor):
            writes = writes and (torch.distributed.get_rank()
                                 == int(v.device_mesh.mesh.flatten()[0]))
            v = v.full_tensor()
        out.append(v)
    return out, writes


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a tensor is copied to the host)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A host copy that no later in-place update of ``leaf`` can reach."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _leaf_checksum(arr: np.ndarray) -> str:
    """crc32 over the raw leaf bytes (dtype and shape are covered by the
    npy header and the template's shape check)."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}"


def _step_id(name: str) -> int | None:
    """step_<N> -> N; None for anything else (tmp dirs, stray files)."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def _sweep_stale_tmp(ckpt_dir: str):
    """Remove `.tmp_step_*` staging dirs orphaned by a crash mid-save
    (saves within a process are serialised, so any found at the start of
    a save belong to a writer that died)."""
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _io_pool() -> ThreadPoolExecutor:
    """Threads for the leaves' file I/O and checksums: numpy's file reads
    and writes and zlib's crc32 release the GIL, so the leaves of a large
    tree move in parallel."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _write(ckpt_dir: str, step: int, leaves, treedef: str, keep_last: int,
           extra_meta: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)

    def write_leaf(i, arr):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        return _leaf_checksum(arr)

    with _io_pool() as pool:
        checksums = list(pool.map(write_leaf, range(len(leaves)), leaves))
    meta = dict(extra_meta or {})
    meta.update({"step": step, "n_leaves": len(leaves),
                 "checksums": checksums, "treedef": treedef,
                 "time": time.time()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, ".LATEST_tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, ".LATEST_tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree, keep_last: int = 3,
         extra_meta: dict | None = None) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir``; returns the step
    directory. ``extra_meta`` (JSON-serialisable) is merged into the
    manifest (`Simulator.save` records the plane layout's tag); the
    reserved keys (step, n_leaves, checksums, treedef, time) win over
    it."""
    leaves, treedef = _flatten(tree)
    leaves, writes = _full(leaves)
    if not writes:
        return os.path.join(ckpt_dir, f"step_{step}")
    return _write(ckpt_dir, step, [_host(v) for v in leaves], treedef,
                  keep_last, extra_meta)


def _prune(ckpt_dir: str, keep_last: int):
    steps = sorted(s for s in map(_step_id, os.listdir(ckpt_dir))
                   if s is not None)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously; write to disk in a
    background thread.

    A failed background save is never lost silently: its exception is
    kept and raised by the next `wait()` or `save_async()`."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def _write(self, step: int, leaves, treedef: str):
        try:
            _write(self.ckpt_dir, step, leaves, treedef, self.keep_last,
                   None)
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            self._exc = e

    def save_async(self, step: int, tree):
        """Wait for the previous write (raising its error), copy every leaf
        of ``tree`` to the host, then write them in the background: a run
        that updates the tensors in place afterwards cannot reach the
        checkpoint in flight."""
        self.wait()
        leaves, treedef = _flatten(tree)
        leaves, writes = _full(leaves)
        if not writes:
            return
        host = [_snapshot(v) for v in leaves]
        self._thread = threading.Thread(
            target=self._write, args=(step, host, treedef),
            daemon=True)
        self._thread.start()

    def wait(self):
        """Join the background write; raise its error, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _is_complete(ckpt_dir: str, step: int) -> bool:
    """A step dir is restorable iff its manifest parses and every leaf file
    it promises exists."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        return all(os.path.exists(os.path.join(d, f"leaf_{i}.npy"))
                   for i in range(int(meta["n_leaves"])))
    except (OSError, ValueError, KeyError):
        return False


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete step, or None. LATEST is only a hint: if it is
    missing, corrupt, or points at an incomplete or pruned step, the
    newest complete step directory is taken."""
    if not os.path.isdir(ckpt_dir):
        return None
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            s = int(f.read().strip())
        if _is_complete(ckpt_dir, s):
            return s
    except (OSError, ValueError):
        pass
    steps = sorted((s for s in map(_step_id, os.listdir(ckpt_dir))
                    if s is not None), reverse=True)
    for s in steps:
        if _is_complete(ckpt_dir, s):
            return s
    return None


def manifest(ckpt_dir: str, step: int) -> dict | None:
    """The step's manifest (with any extra_meta recorded at save time, such
    as the plane layout's tag), or None if it has no parseable one."""
    try:
        with open(os.path.join(ckpt_dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _place(i: int, arr: np.ndarray, tmpl):
    """Leaf i as the template wants it: a tensor template gets a tensor on
    its device and in its dtype (an exact widening only), a DTensor
    template its placements; any other gets the numpy array."""
    if not torch.is_tensor(tmpl):
        return arr
    want = torch.empty((), dtype=tmpl.dtype).numpy().dtype
    if arr.dtype != want:
        if not np.can_cast(arr.dtype, want, "safe"):
            raise ValueError(f"leaf {i}: checkpoint dtype {arr.dtype} does "
                             f"not widen to the template's {tmpl.dtype}")
        arr = arr.astype(want)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    from torch.distributed.tensor import DTensor
    if isinstance(tmpl, DTensor):
        from repro_torch.models.sharding import shard_tensor
        return shard_tensor(torch.from_numpy(arr), tmpl.device_mesh,
                            tmpl.placements)
    return torch.from_numpy(arr).to(tmpl.device)


def restore(ckpt_dir: str, step: int, template, migrate=None):
    """Restore step ``step`` into the structure of ``template`` (its leaves'
    values are placeholders; their shapes are checked, and tensors say
    where and in which dtype each leaf goes, `_place`).

    A manifest with checksums (every save writes them) is verified, and a
    mismatch raises `CheckpointCorruption`; a checksum-less manifest loads
    unverified. ``migrate`` (optional) is applied as
    migrate(loaded_leaf, template_leaf) -> leaf before the shape check:
    the hook the layout shims (`migrate_flat_planes`) plug into."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    leaves, _ = _flatten(template)
    meta = manifest(ckpt_dir, step)
    n_have = (meta or {}).get("n_leaves")
    if n_have is not None and int(n_have) != len(leaves):
        raise ValueError(
            f"step {step}: checkpoint has {n_have} leaves, template wants "
            f"{len(leaves)} (older-format checkpoint? see restore_network)")
    with _io_pool() as pool:
        out = list(pool.map(np.load, [os.path.join(d, f"leaf_{i}.npy")
                                      for i in range(len(leaves))]))
        sums = (meta or {}).get("checksums")
        if sums is not None:
            got = list(pool.map(_leaf_checksum, out[:len(sums)]))
            bad = [i for i, c in enumerate(got) if c != sums[i]]
            if bad:
                raise CheckpointCorruption(
                    f"step {step}: leaf checksum mismatch at {bad} "
                    f"(torn write or bit rot under {d})")
    if migrate is not None:
        out = [migrate(a, t) for a, t in zip(out, leaves)]
    for i, (a, t) in enumerate(zip(out, leaves)):
        want = getattr(t, "shape", None)
        if want is not None and tuple(a.shape) != tuple(want):
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape} != "
                             f"template {tuple(want)}")
    return _unflatten(template, iter(_place(i, a, t) for i, (a, t)
                                     in enumerate(zip(out, leaves))))


def migrate_flat_planes(leaf, template_leaf):
    """Layout shim: batched (H, R, ...) leaves -> flat (H*R, ...).

    Checkpoints of the JAX package's pre-engine runtime stored the HCU
    state batched: ij planes (H, R, C), i-vectors (H, R). The flat layout
    merges the two leading axes (a row-major reshape, the same values). A
    leaf is migrated iff it has exactly one more leading axis than the
    template wants and folding its first two axes gives the template's
    shape; every other leaf passes through, so the shim is safe to apply
    always."""
    want = getattr(template_leaf, "shape", None)
    if want is None:
        return leaf
    want = tuple(want)
    have = tuple(leaf.shape)
    if have != want and len(have) == len(want) + 1 and len(have) >= 2 \
            and (have[0] * have[1],) + have[2:] == want:
        return leaf.reshape(want)
    return leaf


def restore_network(ckpt_dir: str, step: int, template):
    """Restore a `NetworkState`, with the JAX package's two legacy shims:

    * layout: batched (H, R, C) checkpoints load into a flat template
      (`migrate_flat_planes`);
    * counters: checkpoints from before ``drops_route`` are one trailing
      leaf short (the field was appended last); the counter is restored
      as 0, since older route drops were counted in ``drops_fire``.
    """
    meta = manifest(ckpt_dir, step)
    tmpl_route = getattr(template, "drops_route", None)
    if meta is not None and tmpl_route is not None and \
            int(meta.get("n_leaves", -1)) == len(_flatten(template)[0]) - 1:
        old = restore(ckpt_dir, step, template._replace(drops_route=None),
                      migrate=migrate_flat_planes)
        return old._replace(drops_route=torch.zeros_like(tmpl_route)
                            if torch.is_tensor(tmpl_route)
                            else np.zeros_like(np.asarray(tmpl_route)))
    return restore(ckpt_dir, step, template, migrate=migrate_flat_planes)


def restore_latest(ckpt_dir: str, template, *, prune_corrupt: bool = True):
    """Restore the newest verified checkpoint: (tree, step), or
    (None, None) when there is none.

    A step whose checksums fail is pruned (deleted) and the next-newest
    complete step is tried, so a torn or bit-rotted save costs one
    checkpoint interval, never the run. ``prune_corrupt=False`` re-raises
    `CheckpointCorruption` instead and leaves the step in place."""
    while True:
        s = latest_step(ckpt_dir)
        if s is None:
            return None, None
        try:
            return restore(ckpt_dir, s, template), s
        except CheckpointCorruption as e:
            if not prune_corrupt:
                raise
            log.warning("pruning corrupt checkpoint step_%d: %s", s, e)
            # not ignore_errors: a step that cannot be removed would be
            # handed straight back by latest_step
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"))
