"""The port's chunked driver and the facade's last names.

* `Simulator.run` / `network.network_run` in chunks of 1, 3, 7 and 128
  ticks reproduce the head fixtures `head_lazy_worklist`,
  `head_lazy_dense` and `head_eager` (40 ticks each, so 7 leaves a
  remainder) under the contract of tests/test_torch_engine.py; the
  chunk passed to `run` overrides the Simulator's; T = 0 gives (0, H).
* `Simulator.reset` re-inits the state (a reset run reproduces the
  fixture again), and `reset(key=k)` equals a fresh `Simulator(p, key=k)`.
* `hcu.init_hcu_state` and `hcu.column_update` (j >= 0 and j = -1)
  against the JAX package's in a child process: integer leaves exactly,
  float leaves to the contract's tolerances (the largest gap measured is
  wij's 2.4e-7, an ulp of a log).
* On a CUDA device (skipped without one): every local path replays its
  chunks as CUDA graphs bit for bit equal to the per-tick driver
  (`Simulator.tick`), at BCPNNParams(n_hcu=8, rows=1200, cols=70) for 12
  ticks in chunks of 5 (two graphs: 5 and 2); a capture counts the
  wrappers' launches once per captured tick and a replay none, while its
  device trace shows each kernel once per replayed tick; `reset` drops
  the graphs; eager Simulators and a free `network_run` capture side by
  side in one process.
"""
import numpy as np
import pytest
import torch

from test_torch_engine import (DEFAULT_TOL, FIXTURES, FLOAT_TOL,
                               WORKLIST_COMBOS, assert_contract, combo_id,
                               ext_tensor)
from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import (Simulator, column_update, init_hcu_state,
                              network_run)
from repro_torch.core import network as N
from repro_torch.core.params import BCPNNParams
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.kernels import bcpnn_update as BU

TINY = tiny_scale(4, 64, 16)
CHUNK_FIXTURES = {"lazy_worklist": dict(worklist=True),
                  "lazy_dense": dict(worklist=False),
                  "eager": dict(eager=True)}


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _fixture(name):
    return dict(np.load(FIXTURES / f"head_{name}.npz"))


@pytest.mark.parametrize("chunk", [1, 3, 7, 128])
@pytest.mark.parametrize("name", list(CHUNK_FIXTURES))
def test_chunked_run_reproduces_fixture(name, chunk):
    d = _fixture(name)
    sim = Simulator(TINY, key=0, device="cpu", chunk=chunk,
                    **CHUNK_FIXTURES[name])
    fired = sim.run(d["ext"])
    assert_contract(fired, sim.state, d, f"{name} chunk={chunk}")


@pytest.mark.parametrize("chunk", [3, 128])
def test_free_network_run_reproduces_fixture(chunk):
    """The free driver, handed the Simulator's initial state."""
    d = _fixture("lazy_worklist")
    sim = Simulator(TINY, key=0, device="cpu", worklist=True)
    state, fired = network_run(sim.state, sim.conn,
                               torch.from_numpy(d["ext"]), TINY, chunk=chunk,
                               worklist=True)
    assert fired.shape == (40, 4) and fired.dtype == torch.int32
    assert_contract(fired, state, d, f"network_run chunk={chunk}")


def test_run_chunk_overrides_the_simulators(monkeypatch):
    """`run(chunk=)` takes precedence over `Simulator(chunk=)`; full chunks
    first, then the remainder."""
    seen = []
    orig = N._run_ticks
    monkeypatch.setattr(N, "_run_ticks", lambda s, c, ext, *a:
                        seen.append(ext.shape[0]) or orig(s, c, ext, *a))
    sim = Simulator(TINY, key=0, device="cpu", chunk=5)
    ext = ext_tensor(TINY, 11)
    sim.run(ext)
    assert seen == [5, 5, 1]
    seen.clear()
    sim.run(ext, chunk=3)
    assert seen == [3, 3, 3, 2]


def test_zero_ticks_give_an_empty_history():
    sim = Simulator(TINY, key=0, device="cpu")
    fired = sim.run(np.zeros((0, 4, 8), np.int32))
    assert fired.shape == (0, 4) and fired.dtype == torch.int32
    assert int(sim.state.t) == 0


def test_chunk_must_be_positive():
    sim = Simulator(TINY, key=0, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        sim.run(ext_tensor(TINY, 2), chunk=-1)


@pytest.mark.parametrize("name", ["lazy_worklist", "eager"])
def test_reset_reproduces_fixture(name):
    d = _fixture(name)
    sim = Simulator(TINY, key=0, device="cpu", chunk=7, **CHUNK_FIXTURES[name])
    sim.run(d["ext"][:13])
    assert sim.reset() is sim
    assert int(sim.state.t) == 0
    assert_contract(sim.run(d["ext"]), sim.state, d, f"{name} after reset")


def test_reset_with_key_equals_a_fresh_simulator():
    ext = ext_tensor(TINY, 9, seed=3)
    sim = Simulator(TINY, key=0, device="cpu")
    sim.run(ext)
    sim.reset(key=5)
    fresh = Simulator(TINY, key=5, device="cpu")
    got = {**convert.state_to_numpy(sim.state), **convert.conn_to_numpy(sim.conn)}
    want = {**convert.state_to_numpy(fresh.state),
            **convert.conn_to_numpy(fresh.conn)}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(sim.run(ext).numpy(), fresh.run(ext).numpy())


_HCU_BODY = """
from repro.core import hcu as H
from repro.core.params import test_scale
p = test_scale(4, 64, 16)
st = H.init_hcu_state(p)
for f in st._fields:
    OUT["init_" + f] = getattr(st, f)
st = H.HCUState(*[jnp.asarray(IN[f]) for f in st._fields])
for j in (5, 15, -1):
    out = H.column_update(st, jnp.int32(j), jnp.int32(IN["now"]), p)
    for f in out._fields:
        OUT[f"col{j}_" + f] = getattr(out, f)
"""


@pytest.fixture(scope="module")
def hcu_ref():
    """A random (R, C) state (timestamps 0..29, traces in (1e-3, 0.3)) and
    the JAX package's init_hcu_state / column_update on it."""
    rs = np.random.default_rng(0)
    st = init_hcu_state(TINY, device="cpu")
    inp = {}
    for f in st._fields:
        shape = tuple(getattr(st, f).shape)
        inp[f] = (rs.integers(0, 30, shape).astype(np.int32)
                  if getattr(st, f).dtype == torch.int32 else
                  (rs.random(shape) * 0.3 + 1e-3).astype(np.float32))
    inp["now"] = np.array(40, np.int32)
    return inp, run_jax(_HCU_BODY, inp)


def _hcu_contract(got, ref, prefix):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), ref[prefix + f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **FLOAT_TOL.get(
                f"hcus_{f}", DEFAULT_TOL))


def test_init_hcu_state_matches_jax(hcu_ref):
    _hcu_contract(init_hcu_state(TINY, device="cpu"), hcu_ref[1], "init_")


@pytest.mark.parametrize("j", [5, 15, -1])
def test_column_update_matches_jax(hcu_ref, j):
    inp, ref = hcu_ref
    st = init_hcu_state(TINY, device="cpu")
    st = st._replace(**{f: torch.from_numpy(inp[f].copy()) for f in st._fields})
    got = column_update(st, torch.tensor(j, dtype=torch.int32),
                        torch.tensor(40, dtype=torch.int32), TINY)
    _hcu_contract(got, ref, f"col{j}_")
    if j < 0:
        for f in st._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), inp[f])


# ---------------------------------------------------------------------------
# on a CUDA device
# ---------------------------------------------------------------------------

RODENT8 = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=8, active_queue=16)
GRAPH_PATHS = {
    "fused": (dict(), ("fused_row_update", "fused_col_update")),
    "fused_blocked": (dict(layout="blocked"),
                      ("fused_row_update", "fused_col_update")),
    **{combo_id(kw): (kw, ("fused_row_update" if kw["fused"] else
                           "worklist_row_update",
                           "fused_col_update" if kw["fused_cols"] else
                           "col_update"))
       for kw in WORKLIST_COMBOS[1:]},
    "dense": (dict(worklist=False), ("row_update", "col_update")),
    "eager": (dict(eager=True), ()),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _leaves_equal(a, b, what):
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            _leaves_equal(x, y, what)
        elif x is not None:
            assert torch.equal(x, y), f"{what}: {f} differs"


# the name each wrapper's kernel has in a device trace
KERNEL_TAGS = {"fused_row_update": "fused_row_kernel",
               "fused_col_update": "fused_col_kernel",
               "worklist_row_update": "worklist_row_kernel",
               "row_update": "row_block_kernel",
               "col_update": "col_block_kernel"}


def _executions(run):
    """How often each wrapper's kernel ran on the device during ``run()``,
    counted in a torch.profiler trace of the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names, "the trace holds no device activity"
    return {k: sum(tag in n for n in names) for k, tag in KERNEL_TAGS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replay_equals_the_per_tick_driver(path):
    """12 ticks in chunks of 5: two graphs (5 and 2 ticks), the fired
    history and every leaf of the state bit for bit those of 12 calls of
    `Simulator.tick`; then 12 more ticks replay the same two graphs."""
    _cuda()
    kw, _ = GRAPH_PATHS[path]
    ext = torch.from_numpy(ext_tensor(RODENT8, 24)).cuda()
    graphed = Simulator(RODENT8, key=0, chunk=5, **kw)
    ticked = Simulator(RODENT8, key=0, **kw)
    for lo, hi in ((0, 12), (12, 24)):
        fired = graphed.run(ext[lo:hi])
        want = torch.stack([ticked.tick(e) for e in ext[lo:hi]])
        assert torch.equal(fired, want), f"{path}: fired history differs"
        _leaves_equal(graphed.state, ticked.state, path)
    assert list(graphed.graphs.captured) == [5, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replays_count_launches_per_tick(path):
    """A capture counts one wrapper launch of each kernel of its path a
    captured tick (and the scratch tick before a backend's first capture
    one more); a replay counts none on the host, and the device trace of
    the replays shows each kernel of the path once per replayed tick and
    no kernel of another path."""
    _cuda()
    kw, expect = GRAPH_PATHS[path]
    ext = torch.from_numpy(ext_tensor(RODENT8, 24)).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5, **kw)
    before, scratch = dict(BU.launches), len(N.scratch_ticked)
    sim.run(ext[:12])                          # captures 5 and 2
    torch.cuda.synchronize()
    counts = {k: BU.launches[k] - before[k] for k in before}
    scratch = len(N.scratch_ticked) - scratch
    assert counts == {k: 7 + scratch if k in expect else 0 for k in counts}
    before = dict(BU.launches)
    ran = _executions(lambda: sim.run(ext[12:24]))   # replays 5, 5, 2
    assert dict(BU.launches) == before
    assert ran == {k: 12 if k in expect else 0 for k in ran}
    assert list(sim.graphs.captured) == [5, 2]


@pytest.mark.cuda
def test_reset_drops_the_graphs():
    _cuda()
    ext = torch.from_numpy(ext_tensor(RODENT8, 12)).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5)
    first = sim.run(ext)
    assert list(sim.graphs.captured) == [5, 2]
    sim.reset()
    assert sim.graphs.captured == {}
    assert torch.equal(sim.run(ext), first)
    assert list(sim.graphs.captured) == [5, 2]


@pytest.mark.cuda
def test_eager_graphs_of_many_drivers_in_one_process():
    """Two eager Simulators and a free `network_run` call, each with graphs
    of its own, capture on the device's one capture stream in one
    process, and each replays the per-tick driver's history."""
    _cuda()
    ext = torch.from_numpy(ext_tensor(RODENT8, 12)).cuda()
    ticked = Simulator(RODENT8, key=0, eager=True)
    want = torch.stack([ticked.tick(e) for e in ext])
    sims = [Simulator(RODENT8, key=0, eager=True, chunk=c) for c in (5, 4)]
    for sim in sims:
        assert torch.equal(sim.run(ext), want)
    free = Simulator(RODENT8, key=0, eager=True)
    _, fired = network_run(free.state, free.conn, ext, RODENT8, chunk=3,
                           eager=True)
    assert torch.equal(fired, want)
    assert [list(s.graphs.captured) for s in sims] == [[5, 2], [4]]
