"""The port's tick engine end to end, on the CPU.

* From the head fixtures (no JAX in the process),
  `Simulator(test_scale(4, 64, 16), key=0, device="cpu")` under the flags
  each fixture was captured with: `head_lazy_worklist.npz` (worklist=True,
  in all four fused / fused_cols combinations), `head_lazy_dense.npz`
  (worklist=False), `head_eager.npz` (eager=True) and
  `head_host_lazy.npz` (`run_host`, worklist=False). The lazy ones also
  with the planes stored column-blocked, tiles (8, 4) and (7, 5), compared
  after unpacking, as tests/test_engine_fixtures.py holds the JAX package.
* Live, at rodent width: the JAX `Simulator.run` (kernel="ref") in a child
  process against the port on the CPU with the same flags (the default
  fused worklist backend, the unfused one, the dense one), 60 ticks from
  the same numpy input.
* Lazy against eager, as tests/test_lazy_vs_eager.py holds the JAX
  package: equal fired histories, flushed traces within rtol = atol =
  2e-4.
* `repro_torch.convert`: the JAX leaves round-trip, and a run carried
  through numpy halfway equals the unbroken run exactly.

Contract: the fired history and every integer leaf (tij, ti, delay_rows,
delay_count, t, drops_in, drops_fire) exactly; float leaves to the
tolerances in FLOAT_TOL, set at about 4x the largest gap measured between
torch 2.13 on the CPU and the JAX package (fixtures and the live run):

  leaf   largest gap                          tolerance
  zij    2.4e-7 abs (values up to 2)          rtol 4e-6, atol 4e-7
  pij    8.8e-7 relative (values ~1e-3)       rtol 4e-6, atol 4e-7
  wij    1.2e-6 abs (w passes through 0)      rtol 4e-6, atol 4e-6
  h      2.3e-5 abs (values up to 14)         rtol 4e-6, atol 1e-4

All come from float32 exp/log differing by an ulp or so between XLA:CPU
and torch. h is larger because it integrates the WTA drive, a sum of up to
A count*w terms per tick whose ulp-level gaps add up under cancellation
(the eager model's drive is a matrix product, summed in another order
again). The eager fixture's largest gap is wij's 1.2e-6.
"""
import pathlib

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import Simulator
from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import worklist as WL
from repro_torch.core.params import BCPNNParams
from repro_torch.core.params import test_scale as tiny_scale

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
INT_LEAVES = ("hcus_tij", "hcus_ti", "delay_rows", "delay_count", "t",
              "drops_in", "drops_fire")
RODENT4 = BCPNNParams(n_hcu=4, rows=1200, cols=70, fanout=16, active_queue=16,
                      max_delay=16)
LIVE_TICKS = 60
FLOAT_TOL = {"hcus_wij": dict(rtol=4e-6, atol=4e-6),
             "hcus_h": dict(rtol=4e-6, atol=1e-4)}
DEFAULT_TOL = dict(rtol=4e-6, atol=4e-7)


@pytest.fixture(autouse=True)
def _flush_denormal():
    # XLA flushes denormals to zero; torch on the CPU keeps them unless told.
    # The mode is per process and off by default: switch it back off so the
    # tests that share this worker see the default.
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def assert_contract(fired, state, ref, name, layout=None):
    np.testing.assert_array_equal(np.asarray(fired), ref["fired"],
                                  err_msg=f"{name}: fired history")
    got = convert.state_to_numpy(state, layout)
    for k in INT_LEAVES:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name}: {k}")
    for k in ref:
        if k.startswith("hcus_") and k not in INT_LEAVES:
            np.testing.assert_allclose(got[k], ref[k],
                                       **FLOAT_TOL.get(k, DEFAULT_TOL),
                                       err_msg=f"{name}: {k}")


def ext_tensor(p, T, width=8, lam=4.0, seed=0):
    """Poisson external input, as benchmarks/tick_loop.py stages it."""
    rng = np.random.default_rng(seed)
    out = np.full((T, p.n_hcu, width), p.rows, np.int32)
    for t in range(T):
        for h in range(p.n_hcu):
            n = min(width, rng.poisson(lam))
            out[t, h, :n] = rng.integers(0, p.rows, n)
    return out


# fixture name -> (the flags it was captured with, host-loop driver?);
# tests/fixtures/capture_head.py captures them
FIXTURE_FLAGS = {
    "lazy_worklist": (dict(worklist=True), False),
    "lazy_dense": (dict(worklist=False), False),
    "eager": (dict(eager=True), False),
    "host_lazy": (dict(worklist=False), True),
}
WORKLIST_COMBOS = [dict(fused=f, fused_cols=fc) for f in (True, False)
                   for fc in (True, False)]
combo_id = lambda kw: f"fused={kw['fused']},fused_cols={kw['fused_cols']}"


def replay_fixture(name, device, **extra):
    """Run head_<name>.npz's input through the port under its flags;
    returns (the fixture, fired, state)."""
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    kw, host = FIXTURE_FLAGS[name]
    sim = Simulator(tiny_scale(4, 64, 16), key=0, device=device,
                    **kw, **extra)
    if host:
        ext = torch.from_numpy(d["ext"])
        fired = sim.run_host(lambda t: ext[t - 1], ext.shape[0])
    else:
        fired = sim.run(d["ext"])
    return d, fired.cpu(), sim.state


@pytest.mark.parametrize("name", list(FIXTURE_FLAGS))
def test_fixture_trajectory(name):
    d, fired, state = replay_fixture(name, "cpu")
    assert (fired >= 0).sum() > 0
    assert_contract(fired, state, d, name)


@pytest.mark.parametrize("kw", WORKLIST_COMBOS, ids=combo_id)
def test_worklist_fused_and_unfused_match_fixture(kw):
    """Every (fused, fused_cols) combination of the worklist backend holds
    the head_lazy_worklist trajectory."""
    d, fired, state = replay_fixture("lazy_worklist", "cpu", **kw)
    assert_contract(fired, state, d, f"lazy_worklist {kw}")


BLOCKED_CASES = [*(("lazy_worklist", kw) for kw in WORKLIST_COMBOS),
                 ("lazy_dense", {})]
blocked_id = lambda v: (combo_id(v) if isinstance(v, dict) and v else
                        f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))


def replay_blocked(name, kw, tile, device):
    """A lazy fixture with the planes stored in tile ``tile``: the
    contract after unpacking, and every pad cell still `store`'s zero."""
    lay = L.BlockedLayout(64, 16, *tile)
    d, fired, state = replay_fixture(name, device, layout=lay, **kw)
    assert tuple(state.hcus.zij.shape) == lay.plane_shape(4)
    assert_contract(fired, state, d, f"{name} {kw} blocked{tile}", lay)
    pad = torch.ones(lay.plane_shape(4), dtype=torch.bool).reshape(-1)
    pad[lay.row_index(torch.arange(4 * 64)).reshape(-1)] = False
    for f in ("zij", "eij", "pij", "wij", "tij"):
        assert not getattr(state.hcus, f).cpu().reshape(-1)[pad].any(), f


@pytest.mark.parametrize("tile", [(8, 4), (7, 5)], ids=blocked_id)
@pytest.mark.parametrize("name,kw", BLOCKED_CASES, ids=blocked_id)
def test_fixture_trajectory_under_blocked_layout(name, kw, tile):
    """The layout is storage order, not semantics: head_lazy_worklist (all
    four combinations) and head_lazy_dense reproduce with the planes
    stored column-blocked, including the non-dividing tile (7, 5)."""
    replay_blocked(name, kw, tile, "cpu")


def test_blocked_simulator_views_are_flat_copies():
    """Under a blocked layout `hcus()` and `flushed()` give the flat-order
    values of the flat run, bit for bit; `hcus()` is a copy."""
    p = tiny_scale(4, 64, 16)
    ext = ext_tensor(p, 20, lam=3.0, seed=2)
    flat = Simulator(p, key=0, device="cpu", worklist=True)
    blocked = Simulator(p, key=0, device="cpu", worklist=True,
                        layout="blocked")
    assert blocked.layout == L.BlockedLayout(64, 16, 8, 4)
    np.testing.assert_array_equal(flat.run(ext).numpy(),
                                  blocked.run(ext).numpy())
    for a, b in ((flat.hcus(), blocked.hcus()),
                 (flat.flushed(), blocked.flushed())):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f).numpy(), err_msg=f)
    assert blocked.hcus().zij.data_ptr() != blocked.state.hcus.zij.data_ptr()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 4), (7, 5)], ids=blocked_id)
@pytest.mark.parametrize("name,kw", BLOCKED_CASES, ids=blocked_id)
def test_fixture_trajectory_under_blocked_layout_on_cuda(name, kw, tile):
    """The blocked fixture replays through the CUDA kernels."""
    _cuda()
    replay_blocked(name, kw, tile, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    *(("lazy_worklist", kw) for kw in WORKLIST_COMBOS),
    ("lazy_dense", {}), ("eager", {}), ("host_lazy", {})],
    ids=lambda v: combo_id(v) if isinstance(v, dict) and v else str(v))
def test_fixture_trajectory_on_cuda(name, kw):
    """The fixtures through the CUDA kernels, under the same contract."""
    _cuda()
    d, fired, state = replay_fixture(name, "cuda", **kw)
    assert_contract(fired, state, d, f"{name} {kw} on cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(fused=False, fused_cols=False),
                                dict(worklist=False), dict(layout="blocked")],
                         ids=["fused", "unfused", "dense", "fused_blocked"])
def test_tick_never_synchronises_on_cuda(kw):
    """No operation inside a tick waits for the device (what a CUDA-graph
    capture of a chunk of ticks needs): sync-debug mode "error" raises on
    any that does."""
    _cuda()
    p = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=8, active_queue=16)
    ext = torch.from_numpy(ext_tensor(p, 12)).cuda()
    sim = Simulator(p, key=0, device="cuda", **kw)
    sim.run(ext[:2])                     # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.run(ext[2:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(sim.state.t) == 12


_LIVE_BODY = """
from repro.core import Simulator
from repro.core.params import BCPNNParams
p = BCPNNParams(**{k: int(IN[k]) for k in
                   ("n_hcu", "rows", "cols", "fanout", "active_queue",
                    "max_delay")})
sim = Simulator(p, key=0, kernel="ref")
assert type(sim.backend).__name__ == "WorklistBackend"
OUT["fired"] = sim.run(jnp.asarray(IN["ext"]))
st = sim.state
for f in st.hcus._fields:
    OUT[f"hcus_{f}"] = getattr(st.hcus, f)
for f in ("delay_rows", "delay_count", "t", "drops_in", "drops_fire"):
    OUT[f] = getattr(st, f)
for f, v in zip(st.hcus._fields, sim.flushed()):
    OUT[f"flushed_{f}"] = v
"""


def _rodent_inputs():
    p = RODENT4
    dims = {k: np.int64(getattr(p, k)) for k in
            ("n_hcu", "rows", "cols", "fanout", "active_queue", "max_delay")}
    return p, ext_tensor(p, LIVE_TICKS), dims


def assert_live(sim, fired, ref, name, pre=""):
    assert int((fired >= 0).sum()) >= 10, "too few spikes to cover columns"
    assert_contract(fired, sim.state, {k[len(pre):]: v for k, v in ref.items()
                                       if k.startswith(pre)}, name)
    # every lazy trace brought current: the batched (H, R, C) view
    for f, v in zip(sim.state.hcus._fields, sim.flushed()):
        want = ref[f"{pre}flushed_{f}"]
        got = v.numpy().reshape(want.shape)
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, err_msg=f"flushed {f}",
                                       **FLOAT_TOL.get(f"hcus_{f}", DEFAULT_TOL))


def test_live_rodent_width_matches_jax():
    p, ext, dims = _rodent_inputs()
    ref = run_jax(_LIVE_BODY, {"ext": ext, **dims})
    sim = Simulator(p, key=0, device="cpu")
    fired = sim.run(ext)
    assert_live(sim, fired, ref, "rodent4")


# the JAX Simulator with the unfused worklist flags and the dense backend
_LIVE_FLAGS = {"unfused": dict(fused=False, fused_cols=False),
               "dense": dict(worklist=False)}
_LIVE_BACKENDS_BODY = """
from repro.core import Simulator
from repro.core.params import BCPNNParams
p = BCPNNParams(**{k: int(IN[k]) for k in
                   ("n_hcu", "rows", "cols", "fanout", "active_queue",
                    "max_delay")})
for pre, kw, backend in (("unfused_", dict(fused=False, fused_cols=False),
                          "WorklistBackend"),
                         ("dense_", dict(worklist=False), "DenseBackend")):
    sim = Simulator(p, key=0, kernel="ref", **kw)
    be = sim.backend
    assert type(be).__name__ == backend, be
    OUT[pre + "fired"] = sim.run(jnp.asarray(IN["ext"]))
    st = sim.state
    for f in st.hcus._fields:
        OUT[f"{pre}hcus_{f}"] = getattr(st.hcus, f)
    for f in ("delay_rows", "delay_count", "t", "drops_in", "drops_fire"):
        OUT[pre + f] = getattr(st, f)
    for f, v in zip(st.hcus._fields, sim.flushed()):
        OUT[f"{pre}flushed_{f}"] = v
"""


@pytest.fixture(scope="module")
def live_backends_ref():
    _, ext, dims = _rodent_inputs()
    return run_jax(_LIVE_BACKENDS_BODY, {"ext": ext, **dims})


@pytest.mark.parametrize("name", list(_LIVE_FLAGS))
def test_live_rodent_width_backends_match_jax(live_backends_ref, name):
    """The unfused worklist backend and the dense backend against the JAX
    `Simulator` with the same flags, 60 ticks at rodent width."""
    p, ext, _ = _rodent_inputs()
    sim = Simulator(p, key=0, device="cpu", **_LIVE_FLAGS[name])
    fired = sim.run(ext)
    assert_live(sim, fired, live_backends_ref, f"rodent4 {name}", f"{name}_")


@pytest.mark.parametrize("seed,n_ticks,dims",
                         [(0, 50, (4, 64, 16)), (1, 30, (4, 64, 16)),
                          (3, 20, (2, 32, 16))],
                         ids=["seed0", "seed1", "2x32x16"])
def test_lazy_matches_eager(seed, n_ticks, dims):
    """The lazy tick against the eager golden model (the port's
    tests/test_lazy_vs_eager.py): the same spikes, and the same trace
    state after a flush up to float rounding."""
    p = tiny_scale(*dims)
    ext = ext_tensor(p, n_ticks, lam=3.0, seed=seed)
    lazy = Simulator(p, key=0, device="cpu", cap_fire=p.n_hcu)
    eager = Simulator(p, key=0, device="cpu", cap_fire=p.n_hcu, eager=True)
    f_lazy = torch.stack([lazy.tick(e) for e in ext])
    f_eager = torch.stack([eager.tick(e) for e in ext])
    np.testing.assert_array_equal(f_lazy.numpy(), f_eager.numpy())
    assert (f_lazy >= 0).sum() > 0, "test must exercise output spikes"
    a, b = lazy.flushed(), eager.flushed()
    for name in ("zij", "eij", "pij", "wij", "zi", "ei", "pi", "zj", "ej",
                 "pj", "h"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=2e-4,
                                   atol=2e-4,
                                   err_msg=f"trace plane {name} diverged")


def test_convert_round_trip():
    d = dict(np.load(FIXTURES / "head_lazy_worklist.npz"))
    leaves = {k: v for k, v in d.items()
              if not (k.startswith("conn_") or k in ("ext", "fired"))}
    leaves["base_key"] = np.array([123, 4567], np.uint32)
    leaves["drops_route"] = np.array(0, np.int32)
    back = convert.state_to_numpy(
        convert.state_from_numpy(leaves, tiny_scale(4, 64, 16), "cpu"))
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    conn = {k: v for k, v in d.items() if k.startswith("conn_")}
    back = convert.conn_to_numpy(convert.conn_from_numpy(conn, "cpu"))
    for k, v in conn.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_run_carried_through_numpy_is_exact():
    p = tiny_scale(4, 64, 16)
    ext = ext_tensor(p, 20, lam=3.0, seed=3)
    whole = Simulator(p, key=0, device="cpu")
    f_whole = whole.run(ext)
    first = Simulator(p, key=0, device="cpu")
    f1 = first.run(ext[:10])
    second = Simulator(p, key=0, device="cpu")
    second.state = convert.state_from_numpy(
        convert.state_to_numpy(first.state), p, "cpu")
    second.conn = convert.conn_from_numpy(
        convert.conn_to_numpy(first.conn), "cpu")
    f2 = second.run(ext[10:])
    np.testing.assert_array_equal(torch.cat([f1, f2]).numpy(), f_whole.numpy())
    a, b = (convert.state_to_numpy(s.state) for s in (second, whole))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_build_worklist_and_compact_mask():
    rs = np.random.default_rng(4)
    n, A, R = 5, 7, 40
    rows_u = np.where(rs.random((n, A)) < 0.5, rs.integers(0, R, (n, A)), R)
    g_row, order, nv = WL.build_worklist(torch.from_numpy(rows_u).int(), R)
    h = np.arange(n)[:, None]
    want = np.where(rows_u < R, h * R + rows_u, n * R).reshape(-1)
    np.testing.assert_array_equal(g_row.numpy(), want)
    valid = np.nonzero(want < n * R)[0]
    assert int(nv) == len(valid)
    np.testing.assert_array_equal(order[:len(valid)].numpy(), valid)
    assert not order[len(valid):].any()


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["vector", "rows"])
def test_put_drop_is_a_drop_mode_scatter(trailing):
    """`hcu.put_drop` writes what JAX's ``.at[idx].set(new, mode="drop")``
    writes, with the padding entries clipped into range: group 0 has
    valid entries and padding, group 1 none at all, group 2 only valid
    entries."""
    rs = np.random.default_rng(5)
    n_dst, A = 12, 4
    dst = rs.normal(size=(n_dst, *trailing)).astype(np.float32)
    valid = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], bool)
    idx = np.array([[2, 5, 11, 11], [11, 11, 11, 11], [0, 1, 3, 7]])
    new = rs.normal(size=(3, A, *trailing)).astype(np.float32)
    want = dst.copy()
    want[idx[valid]] = new[valid]
    got = torch.from_numpy(dst.copy())
    idx_t = torch.from_numpy(idx)
    old = got[idx_t]
    H.put_drop(got, torch.from_numpy(new), old,
               H.drop_redirect(idx_t, torch.from_numpy(valid)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flat_and_batched_views_share_storage():
    sim = Simulator(tiny_scale(4, 64, 16), device="cpu")
    hb = sim.hcus()
    assert hb.zij.shape == (4, 64, 16) and hb.ti.shape == (4, 64)
    flat = L.flat_state(hb)
    for f in ("zij", "tij", "zi", "ti"):
        assert getattr(flat, f).data_ptr() == getattr(sim.state.hcus, f).data_ptr()
        assert getattr(flat, f).shape == getattr(sim.state.hcus, f).shape
