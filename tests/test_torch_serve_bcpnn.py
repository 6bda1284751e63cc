"""The port's BCPNN recall server (`repro_torch.launch.serve_bcpnn`) and the
session lanes it carries (`network.stack_sessions` / `write_sessions` /
`take_session`), on the CPU.

* One case for each case of tests/test_serve_bcpnn.py — the bitwise
  lane-vs-solo contract on the dense and the (forced) worklist backend,
  slot recycling, statuses, queue overflow, the health monitor's pricing,
  the stats schema, merged mode rejected — and of tests/test_serve_queue.py
  (the admission queue's invariants, as property tests where hypothesis
  is installed).
* Against the JAX package: the committed fixture
  tests/fixtures/assoc_serve_small.npz (the toy server's sessions, written
  by tests/fixtures/capture_assoc.py) replayed exactly — each session's
  fired trajectory, status, ticks, winners and drops; and live, in one
  child (tests/torch_jax_ref.py), the JAX server and the port's on the
  dense and the worklist backend: the sessions exactly, and every lane's
  final leaves (through `take_session` and `convert.state_to_numpy` of the
  stacked state) under the parity contract of tests/test_torch_engine.py.
* The lanes: `write_sessions` copies in place with the JAX package's
  drop-mode index rule, `take_session` gives views, the stacked state
  converts to and from numpy; `main()` runs with `--device cpu` and
  defaults to CUDA.
* `cuda`-marked: the fixture's sessions through the card, each lane equal
  to a solo run through the graphs, and no capture after the first step.
"""
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from test_torch_engine import FLOAT_TOL, DEFAULT_TOL, INT_LEAVES
from torch_jax_ref import ROOT, run_jax
from repro_torch import convert
from repro_torch.core import (Simulator, stack_sessions, take_session,
                              write_sessions)
from repro_torch.core import network as N
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.launch import serve_bcpnn as SB
from repro_torch.launch.serve_bcpnn import (BCPNNRecallServer, RecallRequest,
                                            RequestQueue)

FIXTURE = ROOT / "tests" / "fixtures" / "assoc_serve_small.npz"


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _toy_params():
    return tiny_scale(n_hcu=4, rows=48, cols=8)


def _warm(p, warm_ticks=8, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.rows, (warm_ticks, p.n_hcu, 4)).astype(np.int32)


def _warmed_sim(p, device="cpu", warm_ticks=8, **kw):
    """A Simulator with nontrivial planes/queues (random external drive)."""
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=device, **kw)
    sim.run(_warm(p, warm_ticks))
    return sim


def _requests(p, n, rng, budget=15):
    return [RecallRequest(rid, rng.integers(0, p.rows, p.n_hcu),
                          rng.random(p.n_hcu) < 0.7, budget_ticks=budget)
            for rid in range(n)]


def _cue_ext(p, req, n_ticks, width=4):
    frame = np.full((p.n_hcu, width), p.rows, np.int32)
    mask = np.asarray(req.cue_mask, bool)
    frame[mask, 0] = np.asarray(req.cue_rows, np.int32)[mask]
    return np.ascontiguousarray(np.broadcast_to(frame, (n_ticks,) +
                                                frame.shape))


def _solo(srv, p, req, device="cpu", **kw):
    """The session re-run alone: a fresh Simulator (same key, so the same
    connectivity) from the server's template, `run(chunk=step_ticks)`."""
    ref = Simulator(p, key=0, cap_fire=p.n_hcu, device=device, **kw)
    N.copy_into(ref.state, srv.template)
    fired = ref.run(_cue_ext(p, req, req.ticks), chunk=srv.step_ticks)
    return ref, fired.cpu().numpy()


# -- tests/test_serve_bcpnn.py, case by case ---------------------------------

def test_batched_sessions_bitwise_match_single_runs():
    """Every served session's trajectory equals an independent
    single-session Simulator run from the template, bit for bit."""
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=3, queue_capacity=8,
                            step_ticks=5)
    done = srv.run(_requests(p, 7, np.random.default_rng(0)))
    assert len(done) == 7
    for req in done:
        assert req.ticks % srv.step_ticks == 0 and req.ticks > 0
        _, f_ref = _solo(srv, p, req)
        assert req.fired.shape == f_ref.shape
        assert (req.fired == f_ref).all(), \
            f"session {req.rid} diverged from its solo run"


def test_slot_recycling_serves_every_request_once():
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=2, queue_capacity=16,
                            step_ticks=5)
    n = 9
    done = srv.run(_requests(p, n, np.random.default_rng(1), budget=10))
    assert sorted(r.rid for r in done) == list(range(n))
    assert srv.queue.counters()["admitted"] == n
    assert srv.queue.counters()["rejected"] == 0
    assert len(srv.queue) == 0
    assert all(r.status in ("done", "expired") for r in done)
    assert n > srv.slots


def test_budget_expiry_and_convergence_statuses():
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=2, queue_capacity=4,
                            step_ticks=5)
    done = srv.run(_requests(p, 4, np.random.default_rng(2), budget=15))
    for r in done:
        if r.status == "expired":
            assert r.ticks >= r.budget_ticks
        else:
            assert r.status == "done"
            assert (r.winners >= 0).all()
        assert r.service_ms is not None and r.service_ms >= 0
        assert r.sojourn_ms >= r.service_ms
        assert set(r.drops) == {"in", "fire", "route"}
        assert all(v >= 0 for v in r.drops.values())


def test_queue_overflow_rejects_and_counts():
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=2, queue_capacity=2,
                            step_ticks=5, req_rate=1.0)
    reqs = _requests(p, 5, np.random.default_rng(3), budget=10)
    accepted = [srv.submit(r) for r in reqs]
    assert accepted == [True, True, False, False, False]
    assert [r.status for r in reqs] == \
        ["queued", "queued", "rejected", "rejected", "rejected"]
    c = srv.queue.counters()
    assert c["submitted"] == 5 and c["rejected"] == 3 and c["waiting"] == 2
    while srv.busy:
        srv.step()
    rep = srv.monitor.report()
    assert rep["drops"]["reject"] == 3
    assert "reject" in srv.monitor.class_budgets()


def test_health_monitor_prices_sessions_at_capacity():
    """The drop budget scales with n_hcu * slots (all lanes tick)."""
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=3, queue_capacity=4,
                            step_ticks=5)
    srv.run(_requests(p, 3, np.random.default_rng(4), budget=10))
    assert srv.monitor.n_hcu == p.n_hcu * 3
    rep = srv.monitor.report()
    assert rep["ticks"] == srv.steps * srv.step_ticks
    assert {"in", "fire", "route", "reject"} <= set(rep["drops"])


def test_stats_schema_and_slo():
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p), slots=2, queue_capacity=4,
                            step_ticks=5)
    srv.run(_requests(p, 3, np.random.default_rng(5), budget=10))
    s = srv.stats(slo_ms=1e9)
    assert s["completed"] == 3 == s["done"] + s["expired"]
    assert s["p95_service_ms"] > 0 and s["p95_sojourn_ms"] > 0
    assert s["slo_met"] is True
    assert s["health"]["status"] in ("ok", "over-budget", "deadline-missed")
    assert srv.stats(slo_ms=1e-9)["slo_met"] is False


def test_worklist_backend_sessions_bitwise_match():
    """The lane contract holds on the worklist backend too (forced — the
    toy size would select dense by the size guard)."""
    p = _toy_params()
    sim = _warmed_sim(p, warm_ticks=6, worklist=True)
    srv = BCPNNRecallServer(sim, slots=2, queue_capacity=4, step_ticks=5)
    assert type(srv.be).__name__ == "WorklistBackend"
    done = srv.run(_requests(p, 3, np.random.default_rng(6), budget=10))
    for req in done:
        _, f_ref = _solo(srv, p, req, worklist=True)
        assert (req.fired == f_ref).all()


def test_merged_mode_rejected():
    sim = Simulator(_toy_params(), key=0, merged=True, device="cpu")
    with pytest.raises(NotImplementedError):
        BCPNNRecallServer(sim)


# -- tests/test_serve_queue.py, case by case ---------------------------------

def _req(rid: int) -> RecallRequest:
    return RecallRequest(rid, np.zeros(2, np.int32), np.ones(2, bool))


def _drive(capacity: int, ops):
    """Apply an op sequence; return (queue, admitted rids, rejected rids)."""
    q = RequestQueue(capacity)
    admitted, rejected = [], []
    rid = 0
    for op in ops:
        if op < 0:                       # offer
            r = _req(rid)
            rid += 1
            was_full = len(q) >= q.capacity
            ok = q.offer(r)
            assert ok == (not was_full), "drop iff at capacity at offer time"
            assert r.status == ("queued" if ok else "rejected")
            if not ok:
                rejected.append(r.rid)
        else:                            # take up to `op` requests
            admitted.extend(r.rid for r in q.take(op))
    return q, admitted, rejected


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=1, max_value=5),
       st.lists(st.integers(min_value=-1, max_value=4), max_size=80))
def test_queue_invariants(capacity, ops):
    q, admitted, rejected = _drive(capacity, ops)
    assert q.admitted + q.rejected + len(q) == q.submitted
    assert len(admitted) == q.admitted and len(rejected) == q.rejected
    assert len(set(admitted)) == len(admitted), "no duplicates"
    assert not set(admitted) & set(rejected), "no request in two buckets"
    assert admitted == sorted(admitted)
    assert len(q) <= q.capacity


def test_queue_basic_conservation():
    q, admitted, rejected = _drive(2, [-1, -1, -1, 2, -1, -1, -1, 4])
    assert q.submitted == 6
    assert q.admitted + q.rejected + len(q) == 6
    assert admitted == sorted(admitted)


def test_queue_basic_fifo_and_free():
    q = RequestQueue(3)
    for rid in range(3):
        assert q.offer(_req(rid))
    assert q.free == 0
    assert not q.offer(_req(3))
    assert [r.rid for r in q.take(2)] == [0, 1]
    assert q.free == 2
    assert q.offer(_req(4))
    assert [r.rid for r in q.take(5)] == [2, 4]
    assert q.counters() == {"submitted": 5, "admitted": 4, "rejected": 1,
                            "waiting": 0, "capacity": 3}


# -- the session lanes --------------------------------------------------------

def test_stack_take_and_write_sessions():
    """`stack_sessions` gives contiguous (S,)-stacked copies, `take_session`
    views into them, and `write_sessions` copies the template into the
    named lanes in place: entries in [-S, 0) count from the end, other
    out-of-range entries are dropped (the JAX package's drop mode)."""
    p = _toy_params()
    sim = _warmed_sim(p)
    stacked = stack_sessions(sim.state, 4)
    assert stacked.t.shape == (4,) and stacked.hcus.zij.is_contiguous()
    lane = take_session(stacked, 2)
    assert lane.hcus.zij.data_ptr() != sim.state.hcus.zij.data_ptr()
    lane.t.fill_(99)
    assert int(stacked.t[2]) == 99                 # a view, not a copy
    for i in range(4):
        stacked.t[i] = 50 + i
    ptrs = [t.data_ptr() for t in N._leaves(stacked)]
    t0 = int(sim.state.t)
    out = write_sessions(stacked, sim.state, np.array([1, -1, 4, -5, 9]))
    assert out is stacked
    assert [t.data_ptr() for t in N._leaves(stacked)] == ptrs
    assert stacked.t.tolist() == [50, t0, 52, t0]
    for i in (1, 3):
        for a, b in zip(N._leaves(take_session(stacked, i)),
                        N._leaves(sim.state)):
            assert torch.equal(a, b)
    write_sessions(stacked, sim.state, torch.tensor([0]))
    assert int(stacked.t[0]) == t0


def test_stacked_state_converts_round_trip():
    p = _toy_params()
    stacked = stack_sessions(_warmed_sim(p, layout="blocked").state, 3)
    lay = Simulator(p, device="cpu", layout="blocked").layout
    arrays = convert.state_to_numpy(stacked, lay)
    assert arrays["hcus_zij"].shape == (3, p.n_hcu * p.rows, p.cols)
    assert arrays["base_key"].shape == (3, 2)
    back = convert.state_from_numpy(arrays, p, "cpu", lay)
    for a, b in zip(N._leaves(back), N._leaves(stacked), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_main_runs_on_the_cpu(capsys):
    SB.main(["--device", "cpu", "--requests", "5", "--slots", "2"])
    assert "served 5 sessions" in capsys.readouterr().out


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SB.main(["--requests", "1"])


# -- against the JAX package ---------------------------------------------------

def _fixture_server(device):
    d = dict(np.load(FIXTURE))
    p = _toy_params()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=device)
    sim.run(d["warm"])
    srv = BCPNNRecallServer(sim, slots=3, queue_capacity=8, step_ticks=5)
    done = srv.run([RecallRequest(i, d["cue_rows"][i], d["cue_mask"][i],
                                  budget_ticks=15)
                    for i in range(d["cue_rows"].shape[0])])
    return d, srv, done


def _assert_sessions(done, d, what):
    assert [r.rid for r in done] == d["srv_rid"].tolist(), what
    assert [int(r.status == "done") for r in done] == d["srv_status"].tolist()
    assert [r.ticks for r in done] == d["srv_ticks"].tolist()
    assert [[r.drops[k] for k in ("in", "fire", "route")] for r in done] == \
        d["srv_drops"].tolist()
    np.testing.assert_array_equal(np.stack([r.winners for r in done]),
                                  d["srv_winners"])
    np.testing.assert_array_equal(np.concatenate([r.fired for r in done]),
                                  d["srv_fired"], err_msg=what)


def test_serve_fixture_reproduced():
    """The JAX server's sessions from the committed fixture, exactly."""
    d, _, done = _fixture_server("cpu")
    _assert_sessions(done, d, "cpu")


_JAX_SERVE = """
from repro.core import Simulator, take_session, test_scale
from repro.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest

p = test_scale(n_hcu=4, rows=48, cols=8)
for tag, wl, slots, n, budget in (("dense", False, 3, 7, 15),
                                  ("worklist", True, 2, 3, 10)):
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, worklist=wl)
    sim.run(jnp.asarray(IN[f"{tag}_warm"]))
    srv = BCPNNRecallServer(sim, slots=slots, queue_capacity=8, step_ticks=5)
    rows, masks = IN[f"{tag}_rows"], IN[f"{tag}_masks"]
    done = srv.run([RecallRequest(i, rows[i], masks[i], budget_ticks=budget)
                    for i in range(n)])
    OUT[f"{tag}_rid"] = np.array([r.rid for r in done])
    OUT[f"{tag}_status"] = np.array([r.status == "done" for r in done],
                                    np.int32)
    OUT[f"{tag}_ticks"] = np.array([r.ticks for r in done])
    OUT[f"{tag}_drops"] = np.array([[r.drops[k] for k in ("in", "fire",
                                                          "route")]
                                    for r in done])
    OUT[f"{tag}_winners"] = np.stack([r.winners for r in done])
    OUT[f"{tag}_fired"] = np.concatenate([r.fired for r in done])
    for lane in range(slots):
        st = take_session(srv.stacked, lane)
        for f in st.hcus._fields:
            OUT[f"{tag}_lane{lane}_hcus_{f}"] = getattr(st.hcus, f)
        for f in ("delay_rows", "delay_count", "t", "drops_in",
                  "drops_fire"):
            OUT[f"{tag}_lane{lane}_{f}"] = getattr(st, f)
"""

LIVE = {"dense": (dict(), 3, 7, 15, 0), "worklist": (dict(worklist=True),
                                                     2, 3, 10, 6)}


def _live_inputs():
    p = _toy_params()
    ins = {}
    for tag, (_, _, n, _, seed) in LIVE.items():
        rng = np.random.default_rng(seed)
        reqs = _requests(p, n, rng)
        ins[f"{tag}_warm"] = _warm(p, 8 if tag == "dense" else 6)
        ins[f"{tag}_rows"] = np.stack([r.cue_rows for r in reqs])
        ins[f"{tag}_masks"] = np.stack([r.cue_mask for r in reqs])
    return ins


@pytest.fixture(scope="module")
def jax_serve():
    return run_jax(_JAX_SERVE, _live_inputs(), timeout=300)


@pytest.mark.parametrize("tag", list(LIVE))
def test_served_sessions_match_jax(jax_serve, tag):
    """The JAX server and the port's, the same requests on the same warmed
    state: every session exactly, and every lane's final leaves under the
    parity contract (integers exactly)."""
    kw, slots, n, budget, _ = LIVE[tag]
    ins = _live_inputs()
    p = _toy_params()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device="cpu", **kw)
    sim.run(ins[f"{tag}_warm"])
    srv = BCPNNRecallServer(sim, slots=slots, queue_capacity=8, step_ticks=5)
    done = srv.run([RecallRequest(i, ins[f"{tag}_rows"][i],
                                  ins[f"{tag}_masks"][i], budget_ticks=budget)
                    for i in range(n)])
    ref = {k[len(tag) + 1:].replace("srv_", ""): v
           for k, v in jax_serve.items() if k.startswith(tag + "_")}
    _assert_sessions(done, {f"srv_{k}": v for k, v in ref.items()}, tag)
    got = convert.state_to_numpy(srv.stacked)
    for lane in range(slots):
        for k, v in ref.items():
            if not k.startswith(f"lane{lane}_"):
                continue
            leaf = k[len(f"lane{lane}_"):]
            if leaf in INT_LEAVES:
                np.testing.assert_array_equal(got[leaf][lane], v,
                                              err_msg=f"{tag} {k}")
            else:
                np.testing.assert_allclose(got[leaf][lane], v,
                                           **FLOAT_TOL.get(leaf, DEFAULT_TOL),
                                           err_msg=f"{tag} {k}")


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_serve_fixture_on_cuda():
    """The fixture's sessions through the lane graphs on the card; the
    lanes' graphs are captured at the first step only."""
    _cuda()
    d, srv, done = _fixture_server("cuda")
    _assert_sessions(done, d, "cuda")
    assert srv.captures == srv.slots
    assert [c["step"] for c in srv.capture_steps] == [0]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(worklist=True)],
                         ids=["dense", "worklist"])
def test_lanes_equal_solo_runs_on_cuda(kw):
    """Each served session equals a solo `Simulator.run(chunk=step_ticks)`
    through the graphs, bit for bit."""
    _cuda()
    p = _toy_params()
    srv = BCPNNRecallServer(_warmed_sim(p, "cuda", **kw), slots=3,
                            queue_capacity=8, step_ticks=5)
    done = srv.run(_requests(p, 7, np.random.default_rng(0)))
    for req in done:
        _, f_ref = _solo(srv, p, req, "cuda", **kw)
        assert (req.fired == f_ref).all(), req.rid
