"""The port's lazy worklist tick end to end, on the CPU.

* From the head fixtures (no JAX in the process):
  `Simulator(test_scale(4, 64, 16), key=0, device="cpu").run(ext)` against
  `head_lazy_worklist.npz` and `head_lazy_dense.npz` (the JAX package's
  worklist and dense backends, which pin the same trajectory).
* Live, at rodent width: the JAX `Simulator.run` (kernel="ref", the
  worklist backend is its default at R*C > 65536) in a child process
  against the port on the CPU, 60 ticks from the same numpy input.
* `repro_torch.convert`: the JAX leaves round-trip, and a run carried
  through numpy halfway equals the unbroken run exactly.

Contract: the fired history and every integer leaf (tij, ti, delay_rows,
delay_count, t, drops_in, drops_fire) exactly; float leaves to the
tolerances in FLOAT_TOL, set at about 4x the largest gap measured between
torch 2.13 on the CPU and the JAX package (fixtures and the live run):

  leaf   largest gap                          tolerance
  zij    2.4e-7 abs (values up to 2)          rtol 4e-6, atol 4e-7
  pij    8.8e-7 relative (values ~1e-3)       rtol 4e-6, atol 4e-7
  wij    8.9e-7 abs (w passes through 0)      rtol 4e-6, atol 4e-6
  h      2.3e-5 abs (values up to 14)         rtol 4e-6, atol 1e-4

All come from float32 exp/log differing by an ulp or so between XLA:CPU
and torch. h is larger because it integrates the WTA drive, a sum of up to
A count*w terms per tick whose ulp-level gaps add up under cancellation.
"""
import pathlib

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import Simulator
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


def assert_contract(fired, state, ref, name):
    np.testing.assert_array_equal(np.asarray(fired), ref["fired"],
                                  err_msg=f"{name}: fired history")
    got = convert.state_to_numpy(state)
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


@pytest.mark.parametrize("name", ["lazy_worklist", "lazy_dense"])
def test_fixture_trajectory(name):
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    sim = Simulator(tiny_scale(4, 64, 16), key=0, device="cpu")
    fired = sim.run(d["ext"])
    assert (fired >= 0).sum() > 0
    assert_contract(fired, sim.state, d, name)


@pytest.mark.cuda
def test_fixture_trajectory_on_cuda():
    """The same fixture through the CUDA kernels, under the same contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = dict(np.load(FIXTURES / "head_lazy_worklist.npz"))
    sim = Simulator(tiny_scale(4, 64, 16), key=0, device="cuda")
    fired = sim.run(d["ext"]).cpu()
    assert_contract(fired, sim.state, d, "lazy_worklist on cuda")


@pytest.mark.cuda
def test_tick_never_synchronises_on_cuda():
    """No operation inside a tick waits for the device (what a CUDA-graph
    capture of a chunk of ticks needs): sync-debug mode "error" raises on
    any that does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=8, active_queue=16)
    ext = torch.from_numpy(ext_tensor(p, 12)).cuda()
    sim = Simulator(p, key=0, device="cuda")
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


def test_live_rodent_width_matches_jax():
    p = RODENT4
    ext = ext_tensor(p, LIVE_TICKS)
    dims = {k: np.int64(getattr(p, k)) for k in
            ("n_hcu", "rows", "cols", "fanout", "active_queue", "max_delay")}
    ref = run_jax(_LIVE_BODY, {"ext": ext, **dims})
    sim = Simulator(p, key=0, device="cpu")
    fired = sim.run(ext)
    assert int((fired >= 0).sum()) >= 10, "too few spikes to cover columns"
    assert_contract(fired, sim.state, ref, "rodent4")
    # every lazy trace brought current: the batched (H, R, C) view
    for f, v in zip(sim.state.hcus._fields, sim.flushed()):
        want = ref[f"flushed_{f}"]
        got = v.numpy().reshape(want.shape)
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, err_msg=f"flushed {f}",
                                       **FLOAT_TOL.get(f"hcus_{f}", DEFAULT_TOL))


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


def test_flat_and_batched_views_share_storage():
    sim = Simulator(tiny_scale(4, 64, 16), device="cpu")
    hb = sim.hcus()
    assert hb.zij.shape == (4, 64, 16) and hb.ti.shape == (4, 64)
    flat = L.flat_state(hb)
    for f in ("zij", "tij", "zi", "ti"):
        assert getattr(flat, f).data_ptr() == getattr(sim.state.hcus, f).data_ptr()
        assert getattr(flat, f).shape == getattr(sim.state.hcus, f).shape
