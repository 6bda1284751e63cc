"""The port's resilience layer (`repro_torch.runtime`) and the Fig 7 queue
math (`repro_torch.core.queues`), on the CPU.

* One case for each case of tests/test_resilience.py: crash-restore-replay
  through `ResilientRunner` on the four head fixtures (lazy / merged x
  dense / worklist), the restart from scratch, the restart budgets, bit
  flips, retention-fault scope, the engine on corrupted timestamps, and
  the health monitor's verdicts (the per-class case priced at a
  `distributed.RouteConfig`); one for each case of tests/test_queues.py.
* Against the JAX package, in one child process (tests/torch_jax_ref.py):
  `flip_bits` in every mode with and without `bit_mask`, and
  `inject_retention_faults` on a run's state in every mode, bit for bit;
  `ResilientRunner` with injected crashes against the JAX runner's fired
  history, and against the port's own uninterrupted run bit for bit; the
  `nblocks` branch of `rng.random_bits` (JAX's layout built from
  `jax._src.prng.threefry_split` / `threefry_2x32` at a block of 1001
  words, the port's `BLOCK_WORDS` set to the same).
* The names: `repro_torch.core.__all__` equals `repro.core.__all__`, and
  `repro_torch.runtime` / `repro_torch.experiments` export the JAX
  package's names (read with `ast` from the JAX files). The sharded
  `ElasticRunner`, `remesh` and `remesh_network` are held in
  tests/test_torch_elastic.py.
* `cuda`-marked: the crash replay through the CUDA graphs, which survive
  the restores, and the fault draws on the card equal to the CPU's.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from test_torch_engine import assert_contract
from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import (Simulator, enqueue_spikes, init_network,
                              make_connectivity, network_tick, rng)
from repro_torch.core import network as N
from repro_torch.core.params import BCPNNParams
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.core.queues import (drop_probability_per_ms,
                                     expected_drops_per_month,
                                     min_queue_for_monthly_drop_budget,
                                     p_x_or_more)
from repro_torch.core.distributed import RouteConfig
from repro_torch.runtime import (HealthMonitor, InjectedFailure,
                                 ResilientRunner, RestartableLoop,
                                 RestartBudgetExceeded, flip_bits,
                                 inject_retention_faults)
from repro_torch.runtime.resilience import IJ_PLANES

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"

# must match tests/fixtures/capture_head.py
LAZY_P = tiny_scale(n_hcu=4, rows=64, cols=16)
MERGED_P = BCPNNParams(n_hcu=4, rows=24, cols=16, fanout=4, active_queue=8,
                       max_delay=8, out_rate=0.6)
CASES = {
    "lazy_dense": (LAZY_P, dict(worklist=False)),
    "lazy_worklist": (LAZY_P, dict(worklist=True)),
    "merged_dense": (MERGED_P, dict(merged=True, worklist=False,
                                    cap_fire=MERGED_P.n_hcu)),
    "merged_worklist": (MERGED_P, dict(merged=True, worklist=True,
                                       cap_fire=MERGED_P.n_hcu)),
}
MODES = ("flip", "clear", "set")
MASKS = (0xFFFFFFFF, 1 << 31, 0x0F0F00FF)
FAULT_P = tiny_scale(n_hcu=2, rows=32, cols=16)
BLOCK = 1001
BLOCK_COUNTS = (500, BLOCK, 3503)        # below, at, 2.5 blocks above


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _fixture_sim(name, device="cpu"):
    p, kw = CASES[name]
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    sim = Simulator(p, key=0, chunk=13, device=device, **kw)
    sim.conn = convert.conn_from_numpy(d, sim.device)
    return sim, d


def _once(fails):
    def injector(chunk):
        if chunk in fails:
            fails.discard(chunk)
            return True
        return False
    return injector


def _planes():
    x = np.linspace(0.5, 9.5, 64, dtype=np.float32).reshape(8, 8)
    y = np.random.default_rng(0).integers(-2**31, 2**31 - 1, (5, 7),
                                          dtype=np.int64).astype(np.int32)
    return x, y


def _fault_ext(p, T=8):
    ext = np.full((T, p.n_hcu, p.active_queue), p.rows, np.int32)
    ext[:, :, 0] = 3
    return ext


# -- the JAX reference, one child for the file --------------------------------

_JAX_BODY = """
from jax import lax
from jax._src import prng as P
from repro.core import Connectivity, Simulator, test_scale
from repro.runtime import (ResilientRunner, flip_bits,
                           inject_retention_faults)
import tempfile

MODES = ("flip", "clear", "set")
MASKS = (0xFFFFFFFF, 1 << 31, 0x0F0F00FF)
for name in ("x", "y"):
    plane = jnp.asarray(IN[name])
    for m in MODES:
        for mask in MASKS:
            for rate in (0.1, 0.5):
                out = flip_bits(plane, jax.random.PRNGKey(3), rate, mode=m,
                                bit_mask=mask)
                OUT[f"flip_{name}_{m}_{mask}_{rate}"] = out

# a run's state, then retention faults on it
p = test_scale(n_hcu=2, rows=32, cols=16)
sim = Simulator(p, key=0)
sim.run(jnp.asarray(IN["fault_ext"]))
st = sim.state
for f in st.hcus._fields:
    OUT[f"state_hcus_{f}"] = getattr(st.hcus, f)
for f in ("delay_rows", "delay_count", "t", "drops_in", "drops_fire",
          "drops_route", "base_key"):
    OUT[f"state_{f}"] = getattr(st, f)
for m in MODES:
    for mask in (0xFFFFFFFF, 0x007FFFFF):
        c = inject_retention_faults(st, jax.random.PRNGKey(7), 0.01, mode=m,
                                    bit_mask=mask)
        for f in ("zij", "eij", "pij", "wij", "tij"):
            OUT[f"inject_{m}_{mask}_{f}"] = getattr(c.hcus, f)
c = inject_retention_faults(st, jax.random.PRNGKey(9), 0.05,
                            planes=("tij", "wij"))
OUT["inject_sub_tij"] = c.hcus.tij
OUT["inject_sub_wij"] = c.hcus.wij

# ResilientRunner with two crashes on the lazy_worklist fixture
d = np.load("tests/fixtures/head_lazy_worklist.npz")
lp = test_scale(n_hcu=4, rows=64, cols=16)
rsim = Simulator(lp, key=0, chunk=13, worklist=True)
rsim.conn = Connectivity(jnp.asarray(d["conn_dest_hcu"]),
                         jnp.asarray(d["conn_dest_row"]),
                         jnp.asarray(d["conn_delay"]))
fails = {1, 2}
def injector(chunk):
    if chunk in fails:
        fails.discard(chunk)
        return True
    return False
with tempfile.TemporaryDirectory() as tmp:
    runner = ResilientRunner(rsim, tmp, chunk_ticks=13, save_every=2,
                             fail_injector=injector)
    fired, health = runner.run(jnp.asarray(d["ext"]))
OUT["runner_fired"] = fired
OUT["runner_restarts"] = np.int64(runner.restarts)

# random_bits' nblocks branch at a block of IN["block"] words
block = int(IN["block"])
def blocked_bits(key, n):
    nblocks, rem = divmod(n, block)
    if not nblocks:
        return P.threefry_2x32(key, lax.iota(np.uint32, rem))
    keys = P.threefry_split(key, (nblocks + 1,))
    blocks = jax.vmap(P.threefry_2x32, in_axes=(0, None))(
        keys[:-1], lax.iota(np.uint32, block))
    last = P.threefry_2x32(keys[-1], lax.iota(np.uint32, rem))
    return jnp.concatenate([blocks.ravel(), last])
key = jax.random.PRNGKey(5)
for n in IN["counts"]:
    OUT[f"bits_{n}"] = blocked_bits(key, int(n))
# the reconstruction is JAX's own below a block (no nblocks branch)
ref = jax.random.bits(key, (500,))
assert np.array_equal(np.asarray(blocked_bits(key, 500)), np.asarray(ref))
assert np.array_equal(np.asarray(jax.random.bits(key, (3 * block,))),
                      np.asarray(P.threefry_2x32(key, lax.iota(np.uint32,
                                                               3 * block))))
"""


@pytest.fixture(scope="module")
def jax_ref():
    x, y = _planes()
    return run_jax(_JAX_BODY, {
        "x": x, "y": y, "fault_ext": _fault_ext(FAULT_P),
        "block": np.int64(BLOCK), "counts": np.array(BLOCK_COUNTS)},
        timeout=300)


def _bits(t):
    return t.contiguous().view(torch.int32).numpy()


# -- fault class 1: crash-restore-replay (tests/test_resilience.py) ----------

@pytest.mark.parametrize("name", sorted(CASES))
def test_crash_restore_replay_bitwise(name, tmp_path):
    """Two injected crashes with save_every=2: the first before any
    checkpoint (restart from scratch), the second restoring a checkpoint
    older than the crash point. The recovered run holds the JAX package's
    uninterrupted fixture under the parity contract, and equals the port's
    own uninterrupted run bit for bit, every leaf."""
    sim, d = _fixture_sim(name)
    fails = {1, 2}
    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             save_every=2, fail_injector=_once(fails))
    fired, health = runner.run(d["ext"])
    assert runner.restarts == 2 and not fails
    assert health["restarts"] == 2
    assert [r["kind"] for r in runner.recoveries] == ["crash", "crash"]
    assert isinstance(fired, np.ndarray) and fired.dtype == np.int32
    assert_contract(fired, sim.state, d, name)
    if sim.merged:
        np.testing.assert_array_equal(sim.state.jring.numpy(), d["jring"])
    ref, _ = _fixture_sim(name)
    want = ref.run(d["ext"]).numpy()
    np.testing.assert_array_equal(fired, want)
    for a, b in zip(N._leaves(sim.state), N._leaves(ref.state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_crash_before_first_checkpoint_restarts_from_scratch(tmp_path):
    """A failure before any checkpoint lands replays from the initial
    state (not the half-updated live one) — still the fixture."""
    name = "lazy_worklist"
    sim, d = _fixture_sim(name)
    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             save_every=1000, fail_injector=_once({1}))
    fired, _ = runner.run(d["ext"])
    assert runner.restarts == 1
    assert runner.recoveries[0]["restored_tick"] == 0
    assert_contract(fired, sim.state, d, name)


def test_resilient_runner_restart_budget(tmp_path):
    sim, d = _fixture_sim("lazy_dense")
    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             save_every=1000, max_restarts=3,
                             fail_injector=lambda c: c == 0)
    with pytest.raises(RestartBudgetExceeded):
        runner.run(d["ext"])
    assert runner.restarts == 4


def test_restartable_loop_budget_and_real_errors(tmp_path):
    """Always-failing injector with no checkpoint exhausts max_restarts;
    a real exception from step_fn propagates instead of being retried."""
    loop = RestartableLoop(str(tmp_path / "a"), save_every=1000,
                           fail_injector=lambda s: True, max_restarts=5)
    with pytest.raises(RestartBudgetExceeded):
        loop.run({"x": torch.zeros(())}, lambda s, i: s, 10)
    assert loop.restarts == 6

    def bad_step(state, step):
        raise RuntimeError("real failure")

    loop2 = RestartableLoop(str(tmp_path / "b"), save_every=1000)
    with pytest.raises(RuntimeError, match="real failure"):
        loop2.run({"x": torch.zeros(())}, bad_step, 10)
    assert loop2.restarts == 0


def test_restartable_loop_restores_and_resumes(tmp_path):
    """A crash after a checkpoint resumes from it; one before any restarts
    from the entry state, which the in-place steps did not reach."""
    fails = {3, 5}

    def step_fn(state, i):
        state["x"].add_(1.0)
        return state

    loop = RestartableLoop(str(tmp_path), save_every=2,
                           fail_injector=_once(fails))
    state, step = loop.run({"x": torch.zeros(())}, step_fn, 7)
    assert step == 7 and loop.restarts == 2 and float(state["x"]) == 7.0
    fails = {1}
    loop = RestartableLoop(str(tmp_path / "b"), save_every=100,
                           fail_injector=_once(fails))
    state, step = loop.run({"x": torch.zeros(())}, step_fn, 3)
    assert float(state["x"]) == 3.0 and loop.restarts == 1


def test_resilient_runner_matches_jax_runner(jax_ref, tmp_path):
    """The JAX `ResilientRunner` with crashes before chunks 1 and 2 on the
    lazy_worklist fixture, and the port's with the same crashes: the same
    fired history, exactly."""
    sim, d = _fixture_sim("lazy_worklist")
    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             save_every=2, fail_injector=_once({1, 2}))
    fired, _ = runner.run(d["ext"])
    assert runner.restarts == int(jax_ref["runner_restarts"]) == 2
    np.testing.assert_array_equal(fired, jax_ref["runner_fired"])


def test_restore_copies_into_the_held_tensors(tmp_path):
    """A restore writes the checkpoint into the Simulator's own tensors
    (their storage unchanged) instead of rebinding them, so the chunk
    graphs captured on them survive: the state after the restore holds the
    checkpoint's bits at the same addresses."""
    sim, d = _fixture_sim("lazy_worklist")
    sim.run(d["ext"][:13])
    sim.save(str(tmp_path))
    want = [t.clone() for t in N._leaves(sim.state)]
    sim.run(d["ext"][13:20])
    held = list(N._leaves(sim.state))
    from repro_torch.checkpoint import restore_latest
    from repro_torch.runtime import resilience as R
    restored, step = restore_latest(str(tmp_path),
                                    R._shape_template(sim.state))
    assert step == 13
    N.copy_into(sim.state, restored)
    for a, b, w in zip(N._leaves(sim.state), held, want, strict=True):
        assert a.data_ptr() == b.data_ptr() and torch.equal(a, w)


# -- fault class 2: retention bit flips ---------------------------------------

def test_flip_bits_rate_zero_is_bitwise_noop():
    x = torch.linspace(-3.0, 7.0, 64).reshape(8, 8)
    for mode in MODES:
        y = flip_bits(x, rng.PRNGKey(0), 0.0, mode=mode)
        assert torch.equal(_bits_t(x), _bits_t(y))


def _bits_t(t):
    return t.view(torch.int32)


def test_flip_bits_deterministic_and_modes():
    x = torch.linspace(0.5, 9.5, 64).reshape(8, 8)
    k = rng.PRNGKey(3)
    a = flip_bits(x, k, 0.1)
    b = flip_bits(x, k, 0.1)
    assert torch.equal(_bits_t(a), _bits_t(b))
    assert (a != x).any()
    # clear only removes bits; set only adds them
    xb = _bits_t(x)
    cb = _bits_t(flip_bits(x, k, 0.5, mode="clear"))
    sb = _bits_t(flip_bits(x, k, 0.5, mode="set"))
    assert int((cb & ~xb).abs().sum()) == 0
    assert int((~sb & xb).abs().sum()) == 0
    with pytest.raises(ValueError):
        flip_bits(x, k, 0.1, mode="zap")


def test_flip_bits_bit_mask_sign_only():
    """rate=1 with a sign-bit mask negates every float exactly."""
    x = torch.linspace(1.0, 4.0, 16)
    y = flip_bits(x, rng.PRNGKey(0), 1.0, bit_mask=1 << 31)
    assert torch.equal(y, -x)


@pytest.mark.parametrize("plane", ["x", "y"], ids=["float32", "int32"])
@pytest.mark.parametrize("mode", MODES)
def test_flip_bits_matches_jax(jax_ref, plane, mode):
    """Every mask and rate of the JAX child: the same bits, on a float32
    plane and an int32 one."""
    src = dict(zip(("x", "y"), _planes()))[plane]
    for mask in MASKS:
        for rate in (0.1, 0.5):
            got = flip_bits(torch.from_numpy(src), rng.PRNGKey(3), rate,
                            mode=mode, bit_mask=mask)
            assert got.dtype == torch.from_numpy(src).dtype
            want = jax_ref[f"flip_{plane}_{mode}_{mask}_{rate}"]
            np.testing.assert_array_equal(_bits(got), want.view(np.int32),
                                          err_msg=f"{mask:#x} {rate}")


def _jax_state(jax_ref):
    arrays = {k[len("state_"):]: v for k, v in jax_ref.items()
              if k.startswith("state_")}
    return convert.state_from_numpy(arrays, FAULT_P, "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_inject_retention_faults_matches_jax(jax_ref, mode):
    """The JAX run's state, corrupted by both packages at rate 0.01 in
    every plane, with the full mask and with the float mantissa only: the
    same bits in each plane."""
    st = _jax_state(jax_ref)
    for mask in (0xFFFFFFFF, 0x007FFFFF):
        c = inject_retention_faults(st, rng.PRNGKey(7), 0.01, mode=mode,
                                    bit_mask=mask)
        for f in IJ_PLANES:
            want = jax_ref[f"inject_{mode}_{mask}_{f}"]
            np.testing.assert_array_equal(
                _bits(getattr(c.hcus, f)), want.view(np.int32),
                err_msg=f"{mode} {mask:#x} {f}")


def test_inject_retention_faults_plane_order_matches_jax(jax_ref):
    """Plane i of `planes` draws under fold_in(key, i), in the caller's
    order, as in the JAX package."""
    st = _jax_state(jax_ref)
    c = inject_retention_faults(st, rng.PRNGKey(9), 0.05,
                                planes=("tij", "wij"))
    for f in ("tij", "wij"):
        np.testing.assert_array_equal(_bits(getattr(c.hcus, f)),
                                      jax_ref[f"inject_sub_{f}"].view(np.int32))


def test_inject_retention_faults_scope():
    """Only the named ij planes are corrupted; SRAM-resident state (queues,
    j-vectors, RNG key) stays bit-exact; rate 0 is a full no-op."""
    sim = Simulator(FAULT_P, key=0, device="cpu")
    st = sim.state
    z = inject_retention_faults(st, rng.PRNGKey(0), 0.0)
    for a, b in zip(N._leaves(st), N._leaves(z), strict=True):
        assert torch.equal(a, b)
    c = inject_retention_faults(st, rng.PRNGKey(0), 0.05, planes=("wij",))
    assert (c.hcus.wij != st.hcus.wij).any()
    for f in ("zij", "eij", "pij", "tij", "zi", "zj", "pj"):
        assert torch.equal(getattr(c.hcus, f), getattr(st.hcus, f)), f
    assert torch.equal(c.delay_rows, st.delay_rows)
    with pytest.raises(ValueError):
        inject_retention_faults(st, rng.PRNGKey(0), 0.1, planes=("zj",))


def test_corrupted_tij_timestamps_do_not_crash_engine():
    """The engine keeps running on a state whose timestamps were hit —
    graceful degradation, not a crash."""
    p = FAULT_P
    sim = Simulator(p, key=0, device="cpu")
    ext = torch.from_numpy(_fault_ext(p))
    sim.run(ext)
    sim.state = inject_retention_faults(sim.state, rng.PRNGKey(7), 0.01)
    fired = sim.run(ext)
    assert fired.shape == (8, 2)


def test_flip_rate_is_binomial():
    """Over 2^17 cells at rate 1e-3 the flipped bits lie within 5 sigma of
    rate x bits."""
    x = torch.zeros(1 << 17)
    y = flip_bits(x, rng.PRNGKey(11), 1e-3)
    flipped = int(sum(((_bits_t(y) >> b) & 1).sum() for b in range(32)))
    n = x.numel() * 32
    assert abs(flipped - 1e-3 * n) < 5 * (1e-3 * n) ** 0.5


# -- random_bits' nblocks branch ----------------------------------------------

@pytest.mark.parametrize("n", BLOCK_COUNTS, ids=["below", "at", "above"])
def test_random_bits_blocks_match_jax(jax_ref, monkeypatch, n):
    """With the block cut to 1001 words the port hashes each block under
    its own key of split(key, nblocks + 1), as JAX's nblocks branch does."""
    monkeypatch.setattr(rng, "BLOCK_WORDS", BLOCK)
    got = rng.random_bits(rng.PRNGKey(5), (n,)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, jax_ref[f"bits_{n}"])


def test_random_bits_blocks_keep_the_narrow_layout(jax_ref, monkeypatch):
    """A 16-bit draw over blocks cuts the blocked 32-bit words, low half
    first."""
    monkeypatch.setattr(rng, "BLOCK_WORDS", BLOCK)
    words = jax_ref["bits_3503"].astype(np.int64)
    want = np.stack([words & 0xFFFF, words >> 16], -1).reshape(-1)[:7005]
    got = rng.random_bits(rng.PRNGKey(5), (7005,), 16).numpy()
    np.testing.assert_array_equal(got, want)


# -- fault class 3: health accounting -----------------------------------------

def _p():
    return tiny_scale(n_hcu=4, rows=32, cols=16)


def test_health_monitor_ok():
    mon = HealthMonitor(_p(), target_us_per_tick=1e9)
    mon.begin({"in": 5, "fire": 1})
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 5, "fire": 1})
    rep = mon.report()
    assert rep["status"] == "ok"
    assert rep["ticks"] == 10
    assert rep["drops"]["total"] == 0
    for key in ("budget", "deadline", "drops", "restarts"):
        assert key in rep
    assert rep["budget"]["expected_drops_run"] == pytest.approx(
        mon.expected_drops())


def test_health_monitor_over_budget():
    mon = HealthMonitor(_p(), target_us_per_tick=1e9)
    mon.begin({"in": 0, "fire": 0})
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 10_000_000, "fire": 0})
    rep = mon.report()
    assert rep["status"] == "over-budget"
    assert rep["budget"]["over_budget"] is True
    assert rep["drops"]["in"] == 10_000_000


def test_health_monitor_deadline_missed():
    mon = HealthMonitor(_p(), target_us_per_tick=0.0)
    mon.begin({"in": 0, "fire": 0})
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 0, "fire": 0})
    rep = mon.report()
    assert rep["status"] == "deadline-missed"
    assert rep["deadline"]["chunks_missed"] == 1
    # over-budget outranks deadline-missed
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 10_000_000, "fire": 0})
    assert mon.report()["status"] == "over-budget"


def test_health_monitor_per_class_budgets():
    mon = HealthMonitor(_p(), target_us_per_tick=1e9)
    mon.set_mesh(2, RouteConfig(cap_fire=2, cap_route=32))
    mon.begin({"in": 0, "fire": 0, "route": 0})
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 0, "fire": 0, "route": 0})
    b = mon.class_budgets()
    assert set(b) == {"in", "fire", "route"}
    assert all(v >= 0.0 for v in b.values())
    rep = mon.report()
    assert rep["status"] == "ok"
    assert set(rep["classes"]) == {"in", "fire", "route"}
    assert rep["budget"]["expected_drops_run"] == pytest.approx(
        sum(b.values()))
    # a single class blowing ITS budget flips the verdict
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 0, "fire": 0, "route": 10_000_000})
    rep = mon.report()
    assert rep["status"] == "over-budget"
    assert rep["classes"]["route"]["over"] is True
    assert rep["classes"]["in"]["over"] is False


def test_health_monitor_local_runs_budget_in_only():
    mon = HealthMonitor(_p(), target_us_per_tick=1e9)
    mon.begin({"in": 0, "fire": 0, "route": 0})
    mon.chunk_start(10)
    mon.chunk_end(10, {"in": 0, "fire": 0, "route": 0})
    assert set(mon.class_budgets()) == {"in"}


def test_simulator_drops_accessor():
    sim = Simulator(_p(), key=0, device="cpu")
    d = sim.drops()
    assert d == {"in": 0, "fire": 0, "route": 0}
    assert isinstance(d["in"], int)


# -- the Fig 7 queue math and the runtime queues (tests/test_queues.py) ------

def test_eq1_poisson_tail_paper_anchors():
    """Fig 7 anchor points: P(0+)=1, P(10+)~0.5 at lambda=10, ~0 after 22+."""
    assert p_x_or_more(0, 10.0) == 1.0
    assert abs(p_x_or_more(10, 10.0) - 0.542) < 0.02
    assert p_x_or_more(23, 10.0) < 3e-4


def test_queue_36_monthly_drop_budget():
    """Paper: queue of 36 => ~30% probability of one drop per month."""
    drops = expected_drops_per_month(36, 10.0)
    assert 0.05 < drops < 1.0, f"expected O(0.3)/month, got {drops}"
    q = min_queue_for_monthly_drop_budget(10.0, budget=1.0)
    assert 30 <= q <= 36


def test_drop_probability_monotone_in_queue():
    probs = [drop_probability_per_ms(q, 10.0) for q in (5, 10, 22, 36)]
    assert all(a > b for a, b in zip(probs, probs[1:]))


def test_enqueue_respects_capacity_and_counts_drops():
    p = tiny_scale(n_hcu=2, rows=64, cols=16)      # active_queue == 8
    st = init_network(p, rng.PRNGKey(0, "cpu"))
    m = 3 * p.active_queue                          # oversubscribe one bucket
    dest_h = torch.zeros((m,), dtype=torch.int32)
    dest_r = torch.arange(m, dtype=torch.int32) % p.rows
    delay = torch.full((m,), 2, dtype=torch.int32)
    valid = torch.ones((m,), dtype=torch.bool)
    st2 = enqueue_spikes(st, dest_h, dest_r, delay, valid, p, p.n_hcu)
    b = int((st.t + 2) % p.max_delay)
    assert int(st2.delay_count[0, b]) == p.active_queue
    assert int(st2.drops_in) == m - p.active_queue
    assert (st2.delay_rows[0, b] < p.rows).all()


def test_delayed_delivery_timing():
    """A spike with delay d is consumed exactly d ticks later."""
    p = tiny_scale(n_hcu=1, rows=32, cols=16)
    st = init_network(p, rng.PRNGKey(0, "cpu"))
    d = 3
    i32 = lambda v: torch.tensor([v], dtype=torch.int32)
    st = enqueue_spikes(st, i32(0), i32(5), i32(d),
                        torch.tensor([True]), p, 1)
    conn = make_connectivity(p, rng.PRNGKey(1, "cpu"), n_hcu=1)
    empty = torch.full((1, 4), p.rows, dtype=torch.int32)
    for i in range(1, d + 1):
        bucket = int((st.t + 1) % p.max_delay)
        pending = int(st.delay_count[0, bucket])
        st, _ = network_tick(st, conn, empty, p)
        assert pending == (1 if i == d else 0)
    assert int(st.delay_count.sum()) == 0 or int(st.drops_in) == 0


# -- names -------------------------------------------------------------------

def _jax_all(rel):
    tree = ast.parse((ROOT / "src" / "repro" / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "__all__":
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {rel}")


@pytest.mark.parametrize("pkg", ["core", "runtime", "experiments"])
def test_exports_equal_the_jax_packages(pkg):
    import importlib
    mod = importlib.import_module(f"repro_torch.{pkg}")
    assert mod.__all__ == _jax_all(f"{pkg}/__init__.py")
    for name in mod.__all__:
        assert getattr(mod, name) is not None


def test_injected_failure_is_the_only_recovered_error(tmp_path):
    """A real error inside a chunk propagates out of the runner."""
    sim, d = _fixture_sim("lazy_dense")

    def boom(chunk):
        raise RuntimeError("real failure")

    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             fail_injector=boom)
    with pytest.raises(RuntimeError, match="real failure"):
        runner.run(d["ext"])
    assert runner.restarts == 0
    assert issubclass(InjectedFailure, RuntimeError)


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_crash_restore_replay_on_cuda(name, tmp_path):
    """The crash replay through the CUDA graphs: the fixture under the
    contract, and the graphs captured before the restores are the ones
    replayed after them (a restore copies in place)."""
    _cuda()
    sim, d = _fixture_sim(name, "cuda")
    seen = []

    def injector(chunk):
        seen.append(dict(sim.graphs.captured))
        return _once(fails)(chunk)

    fails = {2, 3}
    runner = ResilientRunner(sim, str(tmp_path), chunk_ticks=13,
                             save_every=1, fail_injector=injector)
    fired, _ = runner.run(d["ext"])
    assert runner.restarts == 2
    assert_contract(fired, sim.state, d, f"{name} on cuda")
    final = sim.graphs.captured
    assert all(final[L] is g for s in seen for L, g in s.items())


@pytest.mark.cuda
def test_retention_faults_on_cuda_equal_the_cpu():
    _cuda()
    sim = Simulator(FAULT_P, key=0, device="cpu")
    sim.run(torch.from_numpy(_fault_ext(FAULT_P)))
    st = sim.state
    on = N.tree_map(lambda a: a.cuda(), st)
    for mode in MODES:
        a = inject_retention_faults(st, rng.PRNGKey(7), 1e-2, mode=mode)
        b = inject_retention_faults(on, rng.PRNGKey(7, "cuda"), 1e-2,
                                    mode=mode)
        for f in IJ_PLANES:
            assert torch.equal(_bits_t(getattr(a.hcus, f)),
                               _bits_t(getattr(b.hcus, f)).cpu()), (mode, f)
