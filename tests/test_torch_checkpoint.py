"""The port's checkpoints (`repro_torch.checkpoint`, `Simulator.save` /
`load`) on the CPU.

* One case for each checkpoint test of tests/test_checkpoint.py, on trees
  of tensors: round trip, pruning, shape mismatch, async saves and their
  errors, atomic staging, LATEST as a hint, checksums and corruption,
  the fallback past corrupt steps, the ``drops_route`` shim, and the
  cross-layout restore of a mid-run state, bit for bit.
* The committed legacy checkpoint (tests/fixtures/legacy_ckpt, written by
  the JAX package's pre-engine runtime at t=10 in the (H, R, C) layout,
  one leaf short of ``drops_route``) restores into the port and
  continues with the fired history of an uninterrupted run
  (`legacy_ckpt_ext.npz`).
* Interop, with the JAX package in a child process
  (tests/torch_jax_ref.py): a checkpoint the JAX `Simulator` writes
  (lazy and merged, flat and in the tile (7, 5)) restores into the port
  bit for bit on every leaf and continues with the JAX package's fired
  history; a checkpoint the port writes restores into the JAX
  `Simulator` bit for bit (the key as two uint32 words on disk) and
  continues with the port's fired history.
"""
import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from test_torch_engine import DEFAULT_TOL, FIXTURES, FLOAT_TOL, ext_tensor
from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointCorruption,
                                    latest_step, manifest, restore,
                                    restore_latest, restore_network, save)
from repro_torch.core import Simulator, init_network, rng
from repro_torch.core import layout as L
from repro_torch.core.params import BCPNNParams
from repro_torch.core.params import test_scale as tiny_scale


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": (torch.zeros(()), torch.full((2, 2), 7.0))}}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.is_tensor(y) and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# -- tests/test_checkpoint.py, case by case ---------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 3, t)
    _assert_trees_equal(t, restore(str(tmp_path), 3, t))
    assert latest_step(str(tmp_path)) == 3


def test_restore_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, t, keep_last=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_4", "step_5"]
    r, s = restore_latest(str(tmp_path), t)
    assert s == 5 and r is not None


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, dict(t, a=torch.zeros((2, 2))))


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ck.save_async(7, t)
    t["a"].add_(100.0)          # in place after the snapshot: not saved
    ck.wait()
    assert latest_step(str(tmp_path)) == 7
    _assert_trees_equal(_tree(), restore(str(tmp_path), 7, t))


def test_no_partial_dirs_on_disk(tmp_path):
    save(str(tmp_path), 1, _tree())
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def test_stale_tmp_swept_on_next_save(tmp_path):
    """A crash mid-save leaves a .tmp_step_* staging dir; the next save
    sweeps it and pruning does not trip over it."""
    t = _tree()
    orphan = tmp_path / ".tmp_step_9_12345"
    orphan.mkdir()
    (orphan / "leaf_0.npy").write_bytes(b"partial garbage")
    save(str(tmp_path), 1, t, keep_last=1)
    names = os.listdir(tmp_path)
    assert not any(d.startswith(".tmp") for d in names)
    assert "step_1" in names
    r, s = restore_latest(str(tmp_path), t)
    assert s == 1 and r is not None


def test_latest_corrupt_pointer_falls_back(tmp_path):
    """A corrupt or dangling LATEST is only a hint."""
    t = _tree()
    save(str(tmp_path), 3, t)
    save(str(tmp_path), 5, t)
    (tmp_path / "LATEST").write_text("not a number")
    assert latest_step(str(tmp_path)) == 5
    (tmp_path / "LATEST").write_text("999")        # dangling pointer
    assert latest_step(str(tmp_path)) == 5
    (tmp_path / "LATEST").write_text("")           # empty file
    r, s = restore_latest(str(tmp_path), t)
    assert s == 5 and r is not None


def test_latest_skips_incomplete_step(tmp_path):
    """A step dir whose manifest promises more leaves than exist is never
    the latest; an unparseable step name is ignored."""
    t = _tree()
    save(str(tmp_path), 2, t)
    fake = tmp_path / "step_9"
    fake.mkdir()
    (fake / "manifest.json").write_text(json.dumps({"n_leaves": 3}))
    os.remove(tmp_path / "LATEST")
    assert latest_step(str(tmp_path)) == 2
    (tmp_path / "step_bogus").mkdir()
    assert latest_step(str(tmp_path)) == 2


def test_restore_latest_empty_and_missing_dir(tmp_path):
    t = _tree()
    assert restore_latest(str(tmp_path), t) == (None, None)
    assert restore_latest(str(tmp_path / "nope"), t) == (None, None)
    assert latest_step(str(tmp_path / "nope")) is None


def _corrupt_leaf(tmp_path, step, leaf=0):
    f = tmp_path / f"step_{step}" / f"leaf_{leaf}.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF                  # flip bits in the data, not the header
    f.write_bytes(bytes(raw))


def test_manifest_has_checksums(tmp_path):
    save(str(tmp_path), 1, _tree())
    meta = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert len(meta["checksums"]) == meta["n_leaves"] == 4
    assert all(isinstance(c, str) and len(c) == 8 for c in meta["checksums"])


def test_restore_detects_corruption(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    _corrupt_leaf(tmp_path, 1)
    with pytest.raises(CheckpointCorruption):
        restore(str(tmp_path), 1, t)


def test_restore_latest_falls_back_and_prunes_corrupt(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    save(str(tmp_path), 2, t)
    _corrupt_leaf(tmp_path, 2)
    r, s = restore_latest(str(tmp_path), t)
    assert s == 1 and r is not None
    assert not (tmp_path / "step_2").exists()
    # forensics mode: corruption re-raised, dir left in place
    save(str(tmp_path), 3, t)
    _corrupt_leaf(tmp_path, 3)
    with pytest.raises(CheckpointCorruption):
        restore_latest(str(tmp_path), t, prune_corrupt=False)
    assert (tmp_path / "step_3").exists()


def test_restore_latest_all_corrupt_returns_none(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    _corrupt_leaf(tmp_path, 1)
    assert restore_latest(str(tmp_path), t) == (None, None)


def test_checksumless_manifest_still_restores(tmp_path):
    """Pre-checksum checkpoints (no 'checksums' key) load unverified."""
    t = _tree()
    save(str(tmp_path), 1, t)
    mf = tmp_path / "step_1" / "manifest.json"
    meta = json.loads(mf.read_text())
    del meta["checksums"]
    mf.write_text(json.dumps(meta))
    _corrupt_leaf(tmp_path, 1, leaf=3)   # undetectable without checksums
    r, s = restore_latest(str(tmp_path), t)
    assert s == 1 and r is not None


def test_async_save_error_reraised(tmp_path):
    """A failed background save surfaces on wait() and on the next
    save_async, once."""
    target = tmp_path / "ckpt"
    target.write_text("a file where the checkpoint dir should go")
    ck = AsyncCheckpointer(str(target))
    ck.save_async(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                            # consumed, not sticky
    ck2 = AsyncCheckpointer(str(target))
    ck2.save_async(1, _tree())
    with pytest.raises(OSError):
        ck2.save_async(2, _tree())


def test_restore_network_shims_missing_drops_route(tmp_path):
    """A NetworkState checkpoint one trailing leaf short (from before
    drops_route) restores with the counter at 0 and every other leaf bit
    for bit; a full one restores the counter."""
    p = tiny_scale(n_hcu=2, rows=32, cols=16)
    st = init_network(p, rng.PRNGKey(0, "cpu"))
    st = st._replace(drops_in=torch.tensor(5, dtype=torch.int32))
    old = st._replace(drops_route=None)
    save(str(tmp_path), 4, old)
    r = restore_network(str(tmp_path), 4, st)
    assert int(r.drops_route) == 0 and r.drops_route.dtype == torch.int32
    assert int(r.drops_in) == 5
    _assert_trees_equal(old, r._replace(drops_route=None))
    st2 = st._replace(drops_route=torch.tensor(9, dtype=torch.int32))
    save(str(tmp_path), 5, st2)
    assert int(restore_network(str(tmp_path), 5, st).drops_route) == 9


def test_bcpnn_state_checkpoint_roundtrip(tmp_path):
    p = tiny_scale(n_hcu=2, rows=32, cols=16)
    st = init_network(p, rng.PRNGKey(0, "cpu"))
    save(str(tmp_path), 0, st)
    _assert_trees_equal(st, restore(str(tmp_path), 0, st))


def test_checkpoint_cross_layout_restore_bitwise(tmp_path):
    """A checkpoint saved under one plane layout restores under another
    bit for bit (the manifest's layout tag, then `layout.convert_hcus`),
    flat <-> the non-dividing tile (7, 5), on a mid-run state."""
    p = tiny_scale(n_hcu=2, rows=32, cols=16)
    lay = L.BlockedLayout(rows=32, cols=16, xr=7, xc=5)
    ext = ext_tensor(p, 10, width=4, lam=2.0)
    flat = Simulator(p, key=0, device="cpu")
    flat.run(ext)
    blocked = Simulator(p, key=0, device="cpu", layout=lay)
    blocked.run(ext)

    flat.save(str(tmp_path / "a"), 1)
    assert manifest(str(tmp_path / "a"), 1)["layout"] == "flat"
    b2 = Simulator(p, key=0, device="cpu", layout=lay).load(str(tmp_path / "a"))
    _assert_trees_equal(blocked.state, b2.state)

    blocked.save(str(tmp_path / "b"), 1)
    assert manifest(str(tmp_path / "b"), 1)["layout"] == L.layout_tag(lay)
    f2 = Simulator(p, key=0, device="cpu").load(str(tmp_path / "b"))
    _assert_trees_equal(flat.state, f2.state)

    b3 = Simulator(p, key=0, device="cpu", layout=lay).load(str(tmp_path / "b"))
    _assert_trees_equal(blocked.state, b3.state)


# -- the port's own cases ----------------------------------------------------

def test_restore_widens_and_refuses_to_narrow(tmp_path):
    """A tensor template takes its leaf in its own dtype where that is an
    exact widening (the key's uint32 words into int64), and refuses any
    other."""
    save(str(tmp_path), 1, {"k": np.array([1, 2**32 - 1], np.uint32),
                            "x": np.ones(3, np.float64)})
    r = restore(str(tmp_path), 1, {"k": torch.zeros(2, dtype=torch.int64),
                                   "x": torch.zeros(3, dtype=torch.float64)})
    assert r["k"].dtype == torch.int64 and r["k"].tolist() == [1, 2**32 - 1]
    with pytest.raises(ValueError, match="widen"):
        restore(str(tmp_path), 1, {"k": torch.zeros(2, dtype=torch.int64),
                                   "x": torch.zeros(3, dtype=torch.float32)})


def test_simulator_save_writes_the_jax_format(tmp_path):
    """`Simulator.save`: step = t by default, the key as two uint32 words,
    the leaves in NetworkState field order (a merged state's rings before
    drops_route), and `load` drops the captured chunks."""
    p = BCPNNParams(n_hcu=2, rows=24, cols=16, fanout=2, active_queue=8,
                    max_delay=8, out_rate=0.6)
    sim = Simulator(p, key=7, device="cpu", merged=True)
    sim.run(ext_tensor(p, 6, width=4, lam=2.0))
    d = sim.save(str(tmp_path))
    assert pathlib.Path(d).name == "step_6"
    meta = manifest(str(tmp_path), 6)
    assert meta["n_leaves"] == 21 and meta["layout"] == "flat"
    key = np.load(os.path.join(d, "leaf_18.npy"))
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, rng.key_data(sim.state.base_key))
    np.testing.assert_array_equal(np.load(os.path.join(d, "leaf_19.npy")),
                                  sim.state.jring.numpy())
    other = Simulator(p, key=7, device="cpu", merged=True)
    other.graphs._chunks[(1, 4)] = None          # stands for a capture
    other.load(str(tmp_path))
    assert other.graphs.captured == {}
    _assert_trees_equal(sim.state, other.state)


def test_legacy_layout_checkpoint_restores_and_continues():
    """The committed pre-engine checkpoint (t=10, batched (H, R, C)
    planes, no drops_route) restores into the port: the raw restore
    refuses the layout, the Simulator's shims take it; the continuation
    fires as the uninterrupted run; the leaves are the files' bit for
    bit; the state after 20 more ticks is the uninterrupted run's under
    the contract."""
    p = tiny_scale(n_hcu=2, rows=32, cols=16)
    d = np.load(FIXTURES / "legacy_ckpt_ext.npz")
    ck = str(FIXTURES / "legacy_ckpt")
    sim = Simulator(p, key=0, device="cpu")
    with pytest.raises(ValueError):
        restore(ck, 10, sim.state)
    sim.load(ck)
    assert int(sim.state.t) == 10 and int(sim.state.drops_route) == 0
    for i, leaf in enumerate(_leaves(sim.state._replace(
            drops_route=None, base_key=rng.key_data(sim.state.base_key)))):
        want = np.load(os.path.join(ck, "step_10", f"leaf_{i}.npy"))
        got = leaf.numpy() if torch.is_tensor(leaf) else leaf
        np.testing.assert_array_equal(got.reshape(want.shape), want,
                                      err_msg=f"leaf {i}")
    fired = sim.run(d["ext"][10:])
    ref = Simulator(p, key=0, device="cpu")
    fired_ref = ref.run(d["ext"])
    np.testing.assert_array_equal(fired_ref[:10].numpy(), d["fired_prefix"])
    np.testing.assert_array_equal(fired.numpy(), fired_ref[10:].numpy())
    got, want = (convert.state_to_numpy(s.state) for s in (sim, ref))
    for k in want:
        if got[k].dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **FLOAT_TOL.get(k, DEFAULT_TOL))


# -- interop with the JAX package --------------------------------------------

MERGED_P = BCPNNParams(n_hcu=4, rows=24, cols=16, fanout=4, active_queue=8,
                       max_delay=8, out_rate=0.6)
LAZY_P = tiny_scale(4, 64, 16)
# case -> (parameters, Simulator flags, tile)
INTEROP = {"lazy_flat": (LAZY_P, dict(worklist=True), None),
           "lazy_7x5": (LAZY_P, dict(worklist=True), (7, 5)),
           "merged_flat": (MERGED_P, dict(merged=True, cap_fire=4), None),
           "merged_7x5": (MERGED_P, dict(merged=True, cap_fire=4,
                                         worklist=True), (7, 5))}
N_SAVE, N_CONT = 12, 12

_INTEROP_BODY = """
from repro.core import Simulator
from repro.core.params import BCPNNParams
from repro.core import layout as L
root = str(IN["root"])
for name in [str(s) for s in IN["names"]]:
    p = BCPNNParams(**{k: int(v) for k, v in zip(
        ("n_hcu", "rows", "cols", "fanout", "active_queue", "max_delay"),
        IN[name + "_dims"])}, out_rate=float(IN[name + "_out_rate"]))
    tile = tuple(int(v) for v in IN[name + "_tile"])
    lay = L.BlockedLayout(p.rows, p.cols, *tile) if tile else None
    flags = {str(k): v for k, v in zip(IN[name + "_flag_keys"],
                                        IN[name + "_flag_vals"])}
    kw = dict(merged=bool(flags.get("merged", 0)),
              worklist=bool(flags["worklist"]) if "worklist" in flags
              else None,
              cap_fire=int(flags["cap_fire"]) if "cap_fire" in flags
              else None, layout=lay)
    ext = jnp.asarray(IN[name + "_ext"])
    n_save = int(IN["n_save"])
    sim = Simulator(p, key=0, **kw)
    sim.run(ext[:n_save])
    sim.save(f"{root}/jax_{name}")
    OUT[name + "_jax_cont"] = sim.run(ext[n_save:])
    other = Simulator(p, key=0, **kw).load(f"{root}/port_{name}")
    for i, leaf in enumerate(jax.tree.leaves(other.state)):
        OUT[f"{name}_loaded_{i}"] = leaf
    OUT[name + "_port_cont"] = other.run(ext[n_save:])
"""


def _flags_arrays(kw):
    keys = sorted(kw)
    return (np.array(keys), np.array([int(kw[k]) for k in keys], np.int64))


@pytest.fixture(scope="module")
def interop():
    """Each package writes a checkpoint after N_SAVE ticks and continues
    N_CONT more; each loads the other's and continues the same ticks."""
    with tempfile.TemporaryDirectory() as root:
        port, inp = {}, {"root": np.array(root), "n_save": np.array(N_SAVE),
                         "names": np.array(list(INTEROP))}
        for name, (p, kw, tile) in INTEROP.items():
            ext = ext_tensor(p, N_SAVE + N_CONT, lam=3.0, seed=5)
            lay = tile and L.BlockedLayout(p.rows, p.cols, *tile)
            sim = Simulator(p, key=0, device="cpu", layout=lay, **kw)
            sim.run(ext[:N_SAVE])
            sim.save(f"{root}/port_{name}")
            port[name] = dict(cont=sim.run(ext[N_SAVE:]).numpy())
            inp.update({
                name + "_dims": np.array([p.n_hcu, p.rows, p.cols, p.fanout,
                                          p.active_queue, p.max_delay]),
                name + "_out_rate": np.array(p.out_rate),
                name + "_tile": np.array(tile or (), np.int64),
                name + "_ext": ext})
            inp[name + "_flag_keys"], inp[name + "_flag_vals"] = \
                _flags_arrays(kw)
        ref = run_jax(_INTEROP_BODY, inp, timeout=600.0)
        loaded = {}
        for name, (p, kw, tile) in INTEROP.items():
            lay = tile and L.BlockedLayout(p.rows, p.cols, *tile)
            ck = f"{root}/jax_{name}"
            files = [np.load(os.path.join(ck, f"step_{N_SAVE}",
                                          f"leaf_{i}.npy"))
                     for i in range(manifest(ck, N_SAVE)["n_leaves"])]
            sim = Simulator(p, key=0, device="cpu", layout=lay, **kw).load(ck)
            # copies: the run below updates the planes in place
            leaves = [np.array(v) for v in _leaves(sim.state._replace(
                base_key=rng.key_data(sim.state.base_key)))]
            flat = Simulator(p, key=0, device="cpu", **kw).load(ck)
            port_files = [np.load(os.path.join(f"{root}/port_{name}",
                                               f"step_{N_SAVE}",
                                               f"leaf_{i}.npy"))
                          for i in range(len(files))]
            sim_state = {k: v.copy() for k, v in
                         convert.state_to_numpy(sim.state, lay).items()}
            loaded[name] = dict(files=files, leaves=leaves,
                                flat_state=convert.state_to_numpy(flat.state),
                                sim_state=sim_state,
                                cont=sim.run(inp[name + "_ext"][N_SAVE:])
                                .numpy(), port_files=port_files)
        yield port, ref, loaded


@pytest.mark.parametrize("name", list(INTEROP))
def test_jax_checkpoint_restores_into_the_port(interop, name):
    """Every leaf bit for bit the JAX package's file (the key widened from
    uint32), the same state under the flat layout after conversion, and
    the continuation fires as the JAX package's."""
    port, ref, loaded = interop
    got = loaded[name]
    assert len(got["leaves"]) == len(got["files"])
    for i, (a, b) in enumerate(zip(got["leaves"], got["files"])):
        assert a.dtype == b.dtype, f"leaf {i}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    for k, v in got["sim_state"].items():
        np.testing.assert_array_equal(got["flat_state"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["cont"], ref[name + "_jax_cont"])
    np.testing.assert_array_equal(got["cont"], port[name]["cont"])


@pytest.mark.parametrize("name", list(INTEROP))
def test_port_checkpoint_restores_into_jax(interop, name):
    """The JAX `Simulator` loads the port's checkpoint with every leaf the
    file's bit for bit, the key as uint32, and continues with the port's
    fired history."""
    port, ref, loaded = interop
    files = loaded[name]["port_files"]
    assert files[18].dtype == np.uint32                  # base_key
    for i, want in enumerate(files):
        got = ref[f"{name}_loaded_{i}"]
        assert got.dtype == want.dtype, f"leaf {i}"
        np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")
    np.testing.assert_array_equal(ref[name + "_port_cont"], port[name]["cont"])
