"""Parameter / batch / cache PartitionSpecs for the LM meshes (the port of
`repro.launch.shardings`), and their DTensor placements.

Rules (the JAX package's baseline):
  params : TP over "model" — attention qkv/o projections, MLP in/out, vocab;
           EP over "model" for MoE expert stacks; tiny/odd tensors replicate.
           DP axes never shard params (pure replication) — optimizer state
           can additionally be ZeRO-sharded over "data" (opt_specs(zero=True)).
  batch  : tokens over ("pod","data").
  cache  : decode KV caches shard batch over ("pod","data") and kv-heads over
           "model" when divisible; long-context (batch=1) shards the SEQUENCE
           dim over ("pod","data") instead.

Every candidate axis is divisibility-checked against the mesh and dropped to
replication when it doesn't divide — specs are always valid for the mesh.

The spec functions take trees in the JAX package's structure (nested dicts,
lists, NamedTuples; None no leaf), whose leaves are anything with
``shape`` (tensors, meta tensors): `repro_torch.convert.lm_tree` gives the
parameter tree, `launch.shapes.cache_tree` the cache tree. A mesh is a
DeviceMesh or anything with ``axis_names`` and ``shape``
(`models.sharding.mesh_axes`). The port keeps each layer's parameters
apart where the JAX package stacks them along the repeats:
`layer_specs` maps a stacked leaf's spec to its layers (the repeat entry
dropped), and `shard_params` turns the model's parameters into DTensors of
those placements.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.convert import _key_parts, lm_leaf_groups, lm_tree
from repro_torch.models.base import ArchConfig
from repro_torch.models.sharding import P, mesh_axes, placements, shard_tensor
from repro_torch.train.optimizer import AdamWState

__all__ = ["DP", "TP", "P", "batch_specs", "cache_specs", "layer_cache_specs",
           "layer_specs", "opt_specs", "param_spec", "param_specs",
           "placements", "shape_tree", "shard_batch", "shard_caches",
           "shard_params", "shard_tensor"]

# logical mesh axis groups
DP = ("pod", "data")
TP = ("model",)


def _axis_size(mesh, axes) -> int:
    m = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        if a in m.axis_names:
            n *= m.shape[a]
    return n


def _present(mesh, axes):
    names = mesh_axes(mesh).axis_names
    axes = tuple(a for a in (axes if isinstance(axes, tuple) else (axes,))
                 if a in names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _checked(mesh, dim: int, axes):
    """Axes if they divide `dim`, else None (replicate)."""
    a = _present(mesh, axes)
    if a is None or dim % _axis_size(mesh, axes) != 0:
        return None
    return a


def param_spec(path: str, leaf, cfg: ArchConfig, mesh) -> P:
    """Spec for one parameter, keyed by its tree path (joined key names)."""
    nd = len(leaf.shape)
    name = path.split("/")[-1]

    def at(pos, dim_axes):  # spec with mesh axes at dim `pos` (may be None)
        spec = [None] * nd
        spec[pos] = _checked(mesh, leaf.shape[pos], dim_axes)
        return P(*spec)

    if name == "embed":
        return at(0, TP)                       # vocab-sharded embedding
    if name in ("lm_head", "pos_embed"):
        return at(nd - 1, TP)
    if "ffn" in path and name in ("wi", "wg", "wo") and nd >= 3 \
            and cfg.n_experts and "shared" not in path:
        return at(nd - 3, TP)                  # EP: expert dim over model
    if name in ("wq", "wk", "wv", "wi", "wg", "up", "in_proj", "w",
                "router", "vision_proj", "frame_proj"):
        return at(nd - 1, TP)                  # column-parallel
    if name in ("wo", "down", "out_proj"):
        return at(nd - 2, TP)                  # row-parallel
    if name in ("bq", "bk", "bv", "norm_w", "b"):
        return at(nd - 1, TP)
    return P()                                 # norms, gates, scalars, conv


# ------------------------------ trees ----------------------------------------

def _items(t):
    """A tree node's children as (path part, child), in `jax.tree.flatten`'s
    order; None for a leaf."""
    if isinstance(t, dict):
        return [(str(k), t[k]) for k in sorted(t)]
    if isinstance(t, (tuple, list)) and not isinstance(t, P):
        if hasattr(t, "_fields"):
            return list(zip(t._fields, t))
        return [(str(i), v) for i, v in enumerate(t)]
    return None


def tree_map_with_path(fn, tree, *rest, path=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf,
    *the same leaf of each of rest)``; ``path`` the tuple of path parts
    (dict keys, list indices, NamedTuple field names). None stays None."""
    if tree is None:
        return None
    items = _items(tree)
    if items is None:
        return fn(path, tree, *rest)
    subs = [[r[k] if isinstance(r, dict) else r[i] for r in rest]
            for i, (k, _) in enumerate(items)]
    if isinstance(tree, dict):
        out = {k: tree_map_with_path(fn, v, *s, path=path + (k,))
               for (k, v), s in zip(items, subs)}
        return {k: out[k] for k in tree}
    vals = [tree_map_with_path(fn, v, *s, path=path + (k,))
            for (k, v), s in zip(items, subs)]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _fsdp_extend(s: P, leaf, mesh, threshold: int) -> P:
    nd = len(leaf.shape)
    if nd < 1 or math.prod(leaf.shape) * 4 < threshold:
        return s
    entries = list(s) + [None] * (nd - len(s))
    for i in sorted(range(nd), key=lambda i: -leaf.shape[i]):
        if entries[i] is None:
            a = _checked(mesh, leaf.shape[i], DP)
            if a is not None:
                entries[i] = a
                break
    return P(*entries)


def param_specs(params, cfg: ArchConfig, mesh, *,
                fsdp_threshold_bytes: int | None = None):
    """Tree of `P` congruent with ``params`` (the JAX package's tree).

    With fsdp_threshold_bytes set, parameters larger than the threshold are
    ADDITIONALLY sharded over the "data" axes on their largest unsharded dim
    (FSDP / ZeRO-3): gathered at use, gradients reduce-scattered."""
    def one(path, leaf):
        s = param_spec("/".join(path), leaf, cfg, mesh)
        if fsdp_threshold_bytes is not None:
            s = _fsdp_extend(s, leaf, mesh, fsdp_threshold_bytes)
        return s
    return tree_map_with_path(one, params)


def opt_specs(params_specs, zero: bool = False, mesh=None, params=None):
    """Optimizer-state specs: mirror params; with zero=True, additionally
    shard replicated moments over "data" on their largest divisible dim
    (ZeRO-2-style)."""
    def zero_extend(_, spec: P, leaf):
        nd = len(leaf.shape)
        if not zero or mesh is None or nd == 0:
            return spec
        entries = list(spec) + [None] * (nd - len(spec))
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        if "data" in used:          # already FSDP-sharded over data
            return P(*entries)
        for i in sorted(range(nd), key=lambda i: -leaf.shape[i]):
            if entries[i] is None:
                a = _checked(mesh, leaf.shape[i], ("data",))
                if a is not None:
                    entries[i] = a
                    break
        return P(*entries)

    mu = (tree_map_with_path(zero_extend, params_specs, params)
          if zero else params_specs)
    return AdamWState(step=P(), mu=mu, nu=mu)


def batch_specs(batch_tree, mesh):
    """Shard the leading (batch) dim over DP when divisible."""
    def one(_, leaf):
        return P(_checked(mesh, leaf.shape[0], DP),
                 *([None] * (len(leaf.shape) - 1)))
    return tree_map_with_path(one, batch_tree)


def cache_specs(cache_tree, cfg: ArchConfig, mesh, *,
                seq_shard: bool = False):
    """Decode-state shardings.

    KV caches (leaf paths '.k'/'.v', shape (layers, B, S, Kv, hd)):
      batch over DP (or, with seq_shard for batch==1 long-context, the
      SEQUENCE dim over DP), kv-heads over TP, falling back to head_dim when
      the kv count doesn't divide the model axis.
    Recurrent states (mamba (L,B,H,P,N) / mlstm (L,B,H,dk,dv)...):
      batch over DP, heads over TP.
    """
    def one(path, leaf):
        nd = len(leaf.shape)
        spec = [None] * nd
        # the innermost named part (a NamedTuple field or dict key); list
        # and tuple indices are skipped, as the JAX package skips them
        name = next((p for p in reversed(path) if not p.isdigit()), "")
        if name in ("k", "v") and nd == 5:          # stacked KV cache
            if seq_shard and leaf.shape[1] == 1:
                spec[2] = _checked(mesh, leaf.shape[2], DP)    # sequence
            else:
                spec[1] = _checked(mesh, leaf.shape[1], DP)    # batch
            spec[3] = _checked(mesh, leaf.shape[3], TP)        # kv heads
            if spec[3] is None:
                spec[4] = _checked(mesh, leaf.shape[4], TP)    # head_dim
        elif nd >= 3:                                # recurrent states
            spec[1] = _checked(mesh, leaf.shape[1], DP)        # batch
            spec[2] = _checked(mesh, leaf.shape[2], TP)        # heads
        return P(*spec)

    return tree_map_with_path(one, cache_tree)


# --------------------------- the port's layers -------------------------------

def layer_specs(spec_tree, cfg: ArchConfig, names) -> dict:
    """Port name -> `P` of its own tensor, from a spec tree over the JAX
    package's parameter tree (`param_specs`, or `opt_specs`' ``mu``). A
    stacked leaf's spec loses its repeat entry; where that entry shards
    the repeats (ZeRO or FSDP of the per-layer scalars, whose JAX leaf is
    (repeats,)), each layer's tensor is replicated over that axis: the port
    holds the layers apart, and that state is a few scalars."""
    out = {}
    for key, stacked, group in lm_leaf_groups(cfg, names):
        node = spec_tree
        for part in _key_parts(key):
            node = node[part]
        s = P(*node[1:]) if stacked else node
        for n in group:
            out[n] = s
    return out


def shape_tree(tensors: dict, cfg: ArchConfig):
    """The JAX package's parameter tree of ``tensors`` (port name ->
    tensor) as meta tensors of each leaf's shape: what the spec functions
    read, with nothing allocated or copied."""
    return lm_tree(tensors, cfg, lambda ts, stacked: torch.empty(
        ((len(ts),) if stacked else ()) + tuple(ts[0].shape),
        dtype=ts[0].dtype, device="meta"))


def _set_param(model: nn.Module, name: str, value: nn.Parameter):
    *path, last = name.split(".")
    mod = model
    for part in path:
        mod = getattr(mod, part)
    setattr(mod, last, value)


def shard_params(model, cfg: ArchConfig, mesh, *,
                 fsdp_threshold_bytes: int | None = None):
    """Turn ``model``'s parameters into DTensors on ``mesh`` (each rank
    keeps its shard of the tensor it holds, which must be the same on every
    rank: the same seed), placed by `param_specs`; returns the spec tree
    (the JAX package's structure)."""
    own = dict(model.named_parameters())
    tree = param_specs(shape_tree(own, cfg), cfg, mesh,
                       fsdp_threshold_bytes=fsdp_threshold_bytes)
    for n, s in layer_specs(tree, cfg, own).items():
        with torch.no_grad():
            d = shard_tensor(own[n].detach(), mesh, placements(s, mesh))
        _set_param(model, n, nn.Parameter(d, requires_grad=own[n].requires_grad))
    return tree


def layer_cache_specs(spec_tree, cfg: ArchConfig) -> list:
    """One spec tree a decoder layer, in stack order (the port's
    `Model.init_cache`), from a spec tree over the JAX package's cache
    tree (`cache_specs` of `launch.shapes.cache_tree`): each stacked leaf's
    spec loses its repeat entry. A `KVCache`'s ``length`` (a host int in
    the port) has no spec."""
    from repro_torch.models.layers import KVCache
    from repro_torch.models.transformer import build_stack_spec

    def drop(s):
        if isinstance(s, KVCache):
            return KVCache(drop(s.k), drop(s.v), None)
        if isinstance(s, tuple) and not isinstance(s, P):
            return tuple(drop(t) for t in s)
        return None if s is None else P(*s[1:])
    return [drop(spec_tree[i][j])
            for i, (pattern, repeats) in enumerate(build_stack_spec(cfg))
            for _ in range(repeats) for j in range(len(pattern))]


def shard_caches(caches: list, cfg: ArchConfig, mesh, *,
                 seq_shard: bool = False) -> list:
    """The port's per-layer decode caches (`Model.init_cache`) as DTensors
    on ``mesh``, laid out by `cache_specs` as the JAX package lays out its
    stacked caches (batch over the data axes, kv heads, or else the head
    dim, over "model"; with ``seq_shard`` a batch-1 cache's sequence over
    the data axes). Each rank keeps its shard of the caches it holds."""
    from repro_torch.launch.shapes import cache_tree
    from repro_torch.models.layers import KVCache
    kv = next((c for c in caches if isinstance(c, KVCache)), None)
    first = next(t for c in caches if c is not None
                 for t in (c if isinstance(c, tuple) else (c,))
                 if torch.is_tensor(t))
    B, max_len = (kv.k.shape[0], kv.k.shape[1]) if kv is not None else \
        (first.shape[0], 1)
    specs = layer_cache_specs(
        cache_specs(cache_tree(cfg, B, max_len), cfg, mesh,
                    seq_shard=seq_shard), cfg)

    def place(c, s):
        if isinstance(c, KVCache):
            return KVCache(place(c.k, s.k), place(c.v, s.v), c.length)
        if isinstance(c, tuple):
            return tuple(place(t, u) for t, u in zip(c, s))
        if c is None:
            return None
        return shard_tensor(c, mesh, placements(s, mesh))
    return [place(c, s) for c, s in zip(caches, specs)]


def shard_batch(batch: dict, mesh) -> dict:
    """A batch (the same on every rank) laid out by `batch_specs`."""
    specs = batch_specs(batch, mesh)
    return {k: shard_tensor(v, mesh, placements(specs[k], mesh))
            for k, v in batch.items()}
