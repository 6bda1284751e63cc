"""The span recorder (`repro_torch.core.spans`): device marks inside the
tick, host spans around chunks and server steps, one clock.

On the CPU:

* With the recorder off nothing is marked, `ChunkGraphs` keys a capture
  (length, drive width, False) and ``captured`` gives only unrecorded
  graphs; a recorded capture is keyed apart and a switch back never
  replays it.
* With it on, every tick of the lazy worklist (fused) and the dense
  backend marks its start and the end of its six phases once, in order,
  monotone; the fired history and every state leaf equal an unrecorded
  run's bit for bit (the eager and merged modes too).
* Host spans nest: ``chunk`` over ``chunk.stage`` / ``chunk.replay`` /
  ``chunk.out`` (the marks inside their replay's span), ``serve.step``
  over ``serve.admit`` / ``serve.stage`` / ``serve.lanes`` (a
  ``serve.lane`` each) / ``serve.read`` / ``serve.retire``, with parent
  ids; a request's spans carry its rid and lane, which the admit and
  retire spans name.
* The summary of a drive run and of a recall run: every number finite and
  >= 0, the six phases, the between-tick time and the replay gap adding
  up to the marked ticks' span.
* With the recorder off and torch.profiler on, a span is a host range of
  the profile in function scope (no user annotation).

`cuda`-marked (skipped without a card): a recorded replay gives the
unrecorded replay's bits; the unrecorded graph's node count is unchanged
after a recorded capture, and the recorded one holds 7 nodes a tick more;
calibrated marks lie inside the host span of their replay and its
synchronize; under the profiler no device event carries a span's name.
"""
import ctypes
import math
import time

import numpy as np
import pytest
import torch

from repro_torch.core import Simulator, spans
from repro_torch.core import network as N
from repro_torch.core.params import BCPNNParams
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest

TINY = tiny_scale(4, 64, 16)
BACKENDS = {"worklist_fused": dict(worklist=True),
            "dense": dict(worklist=False)}
MODES = {**BACKENDS, "eager": dict(eager=True), "merged": dict(merged=True)}


def _ext(p, T, width=4, lam=2.0, seed=0):
    rng = np.random.default_rng(seed)
    out = np.full((T, p.n_hcu, width), p.rows, np.int32)
    n = np.minimum(rng.poisson(lam, (T, p.n_hcu)), width)
    for t in range(T):
        for h in range(p.n_hcu):
            out[t, h, :n[t, h]] = rng.integers(0, p.rows, n[t, h])
    return torch.from_numpy(out)


def _leaves_equal(a, b, what):
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            _leaves_equal(x, y, what)
        elif x is not None:
            assert torch.equal(x, y), f"{what}: {f} differs"


def _children(rec, sp):
    return [s for s in rec.spans if s.parent == sp.id]


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture
def counted(monkeypatch):
    """Counts of each mark written, by index."""
    seen = [0] * spans.N_MARKS
    orig = spans.Marks.mark

    def mark(self, i):
        seen[i] += 1
        orig(self, i)

    monkeypatch.setattr(spans.Marks, "mark", mark)
    return seen


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BACKENDS))
def test_recorder_off_marks_nothing(name, counted):
    sim = Simulator(TINY, key=0, device="cpu", chunk=3, **BACKENDS[name])
    sim.run(_ext(TINY, 7))
    sim.tick(_ext(TINY, 1)[0])
    assert spans.recorder() is None
    assert counted == [0] * spans.N_MARKS
    with spans.span("chunk") as sp:
        assert sp is None


class _FakeGraph:
    def replay(self):
        pass


def test_capture_keys_keep_recorded_graphs_apart(monkeypatch):
    """`ChunkGraphs.run` with a stand-in capture: off keys (L, A, False),
    on captures (L, A, True) beside it, off again reuses the first; the
    recorded replay's marks reach the recorder inside its replay span."""
    made = []

    def capture(self, L, A_ext, p, be, cap_fire, tick_kw, recorded):
        n = self._carry.delay_rows.shape[0]
        marks = spans.Marks(L, "cpu") if recorded else None
        if marks is not None:
            for _ in range(L):
                for i in range(spans.N_MARKS):
                    marks.mark(i)
        c = N._Chunk(_FakeGraph(),
                     torch.zeros((L, n, A_ext), dtype=torch.int32),
                     torch.zeros((L, n), dtype=torch.int32), marks)
        self._chunks[(L, A_ext, recorded)] = c
        made.append((L, A_ext, recorded))
        return c

    monkeypatch.setattr(N.ChunkGraphs, "_capture", capture)
    sim = Simulator(TINY, key=0, device="cpu")
    g = N.ChunkGraphs()
    be = sim.backend
    ext = _ext(TINY, 5)
    g.run(sim.state, sim.conn, ext, TINY, be, None, 5)
    assert made == [(5, 4, False)]
    unrecorded = g.captured[5]
    with spans.record("cpu") as rec:
        g.run(sim.state, sim.conn, ext, TINY, be, None, 5)
        g.run(sim.state, sim.conn, ext, TINY, be, None, 5)
    assert made == [(5, 4, False), (5, 4, True)]
    assert g.captured == {5: unrecorded}
    g.run(sim.state, sim.conn, ext, TINY, be, None, 5)
    assert made == [(5, 4, False), (5, 4, True)]
    kept = rec.marks()
    assert len(kept) == 2
    for block, m in kept:
        replay = rec.spans[block.span]
        assert replay.name == "chunk.replay" and m.shape == (5, spans.N_MARKS)
    assert [s.name for s in rec.spans if s.parent is None] == [
        "chunk.capture", "chunk", "chunk"]


# ---------------------------------------------------------------------------
# marks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BACKENDS))
def test_each_tick_marks_its_phases_in_order(name, counted):
    T = 9
    sim = Simulator(TINY, key=0, device="cpu", chunk=4, **BACKENDS[name])
    with spans.record("cpu") as rec:
        sim.run(_ext(TINY, T))
    assert spans.MARKS == ("tick.start", "bucket", "keys", "rows", "wta",
                           "cols", "fanout")
    assert spans.PHASES == spans.MARKS[1:]
    assert counted == [T] * spans.N_MARKS
    kept = rec.marks()
    assert [b.ticks for b, _ in kept] == [4, 4, 1]
    ticks = np.concatenate([m for _, m in kept])
    assert ticks.shape == (T, spans.N_MARKS) and (ticks > 0).all()
    assert (np.diff(ticks, axis=1) >= 0).all()
    assert (ticks[1:, 0] >= ticks[:-1, -1]).all()
    assert spans.recorder() is None


@pytest.mark.parametrize("name", list(MODES))
def test_recorded_run_is_bitwise_the_unrecorded_one(name):
    ext = _ext(TINY, 10, seed=3)
    plain = Simulator(TINY, key=0, device="cpu", chunk=4, **MODES[name])
    want = plain.run(ext)
    rec_sim = Simulator(TINY, key=0, device="cpu", chunk=4, **MODES[name])
    first = rec_sim.run(ext[:4])
    with spans.record("cpu"):
        rest = rec_sim.run(ext[4:])
    assert torch.equal(torch.cat([first, rest]), want)
    _leaves_equal(rec_sim.state, plain.state, name)


def test_record_does_not_nest():
    with spans.record("cpu"):
        with pytest.raises(RuntimeError, match="already on"):
            with spans.record("cpu"):
                pass
    assert spans.recorder() is None


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------

def test_chunk_spans_nest_and_hold_their_marks():
    sim = Simulator(TINY, key=0, device="cpu", chunk=3, worklist=True)
    with spans.record("cpu") as rec:
        sim.run(_ext(TINY, 7))
    chunks = [s for s in rec.spans if s.name == "chunk"]
    assert [s.attrs["ticks"] for s in chunks] == [3, 3, 1]
    for c in chunks:
        assert c.parent is None
        kids = _children(rec, c)
        assert [k.name for k in kids] == ["chunk.stage", "chunk.replay",
                                          "chunk.out"]
        for k in kids:
            assert c.start_ns <= k.start_ns <= k.end_ns <= c.end_ns
    for block, m in rec.marks():
        replay = rec.spans[block.span]
        assert replay.start_ns <= m.min() and m.max() <= replay.end_ns


def _toy_server(device="cpu", slots=3):
    p = tiny_scale(n_hcu=4, rows=48, cols=8)
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=device)
    srv = BCPNNRecallServer(sim, slots=slots, queue_capacity=8, step_ticks=4)
    rng = np.random.default_rng(5)
    reqs = [RecallRequest(i, rng.integers(0, p.rows, p.n_hcu),
                          rng.random(p.n_hcu) < 0.6, budget_ticks=12)
            for i in range(5)]
    return srv, reqs


def test_serve_step_spans_nest_and_requests_link():
    srv, reqs = _toy_server()
    with spans.record("cpu") as rec:
        done = srv.run(reqs)
    assert len(done) == len(reqs)
    steps = [s for s in rec.spans if s.name == "serve.step"]
    assert len(steps) == srv.steps
    admitted, retired = {}, {}
    for st in steps:
        assert st.parent is None
        kids = _children(rec, st)
        assert [k.name for k in kids] == ["serve.admit", "serve.stage",
                                          "serve.lanes", "serve.read",
                                          "serve.retire"]
        for k in kids:
            assert st.start_ns <= k.start_ns <= k.end_ns <= st.end_ns
        lanes = _children(rec, kids[2])
        assert [(s.name, s.attrs["lane"]) for s in lanes] == [
            ("serve.lane", i) for i in range(srv.slots)]
        for s in lanes:
            assert [c.name for c in _children(rec, s)] == ["chunk"]
        admitted.update(kids[0].attrs["admitted"])
        retired.update(kids[4].attrs["retired"])
    req = spans.request_spans(done)
    for r in done:
        mine = [s for s in req if s.attrs["rid"] == r.rid]
        assert [s.name for s in mine] == ["request", "request.queue",
                                          "request.service"]
        assert all(s.attrs["lane"] == r.lane for s in mine)
        assert mine[1].parent == mine[2].parent == mine[0].id
        assert mine[0].start_ns <= mine[1].end_ns <= mine[0].end_ns
        assert admitted[r.rid] == r.lane == retired[r.rid]


def test_serve_steps_are_bitwise_with_the_recorder_on():
    a, reqs_a = _toy_server()
    b, reqs_b = _toy_server()
    a.run(reqs_a)
    with spans.record("cpu"):
        b.run(reqs_b)
    for x, y in zip(a.completed, b.completed):
        assert (x.rid, x.status, x.ticks, x.lane) == (y.rid, y.status,
                                                      y.ticks, y.lane)
        np.testing.assert_array_equal(x.fired, y.fired)
    _leaves_equal(a.stacked, b.stacked, "stacked lanes")


# ---------------------------------------------------------------------------
# the summary
# ---------------------------------------------------------------------------

def _finite(v):
    return v is not None and math.isfinite(v) and v >= 0


def test_drive_summary_adds_up():
    """A tiny drive run (human widths cut down, 256 ticks in 128-tick
    chunks as the drive cells run them)."""
    p = BCPNNParams(n_hcu=4, rows=100, cols=10, fanout=10, active_queue=16)
    sim = Simulator(p, key=0, device="cpu", worklist=True, chunk=32)
    sim.run(_ext(p, 32, seed=1))
    with spans.record("cpu") as rec:
        sim.run(_ext(p, 96, seed=2))
    s = rec.summary()
    assert s["ticks"] == 96
    assert set(s["phase_us"]) == set(spans.PHASES)
    assert all(_finite(v) for v in s["phase_us"].values())
    for k in ("between_us", "replay_gap_us", "marked_tick_us"):
        assert _finite(s[k]), k
    total = sum(s["phase_us"].values()) + s["between_us"] + s["replay_gap_us"]
    assert total == pytest.approx(s["marked_tick_us"], rel=1e-9)
    kept = rec.marks()
    span_us = (kept[-1][1][-1, -1] - kept[0][1][0, 0]) / 96 * 1e-3
    assert s["marked_tick_us"] == pytest.approx(span_us, rel=1e-12)
    assert s["steps"] == [] and s["step_host_ms"] is None


def test_recall_summary_reads_each_step():
    srv, reqs = _toy_server()
    for r in reqs[:3]:
        srv.submit(r)
    srv.step()                                     # warm: lanes full
    with spans.record("cpu") as rec:
        srv.run(reqs[3:])
    s = rec.summary()
    assert len(s["steps"]) == srv.steps - 1
    for st in s["steps"]:
        assert st["lane_ticks"] == srv.slots * srv.step_ticks
        assert _finite(st["wall_ms"]) and _finite(st["lanes_ms"])
        assert _finite(st["host_ms"])
        assert st["host_ms"] == pytest.approx(st["wall_ms"] - st["lanes_ms"])
    assert _finite(s["step_host_ms"]) and s["lane_device_ms"] > 0
    assert all(_finite(v) for v in s["phase_us"].values())


def test_empty_summary():
    with spans.record("cpu") as rec:
        pass
    s = rec.summary()
    assert s["ticks"] == 0 and s["phase_us"] is None and s["steps"] == []


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_off_spans_are_function_scope_profile_ranges():
    from torch.profiler import ProfilerActivity, profile
    sim = Simulator(TINY, key=0, device="cpu", chunk=4, worklist=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(_ext(TINY, 4))
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("chunk")]
    assert sorted({e.name() for e in ours}) == [
        "chunk", "chunk.out", "chunk.replay", "chunk.stage"]
    assert not any(e.is_user_annotation() for e in ours)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

RODENT8 = BCPNNParams(n_hcu=8, rows=1200, cols=70)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _graph_nodes(graph) -> int:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                               ctypes.byref(count)) == 0
    return count.value


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BACKENDS))
def test_recorded_replay_equals_the_unrecorded_one(name):
    _cuda()
    ext = _ext(RODENT8, 30, width=8, lam=4.0).cuda()
    plain = Simulator(RODENT8, key=0, chunk=5, **BACKENDS[name])
    want = plain.run(ext)
    sim = Simulator(RODENT8, key=0, chunk=5, **BACKENDS[name])
    got = [sim.run(ext[:10])]
    with spans.record() as rec:
        got.append(sim.run(ext[10:20]))
    got.append(sim.run(ext[20:]))
    assert torch.equal(torch.cat(got), want)
    _leaves_equal(sim.state, plain.state, name)
    s = rec.summary()
    assert s["ticks"] == 10 and all(v >= 0 for v in s["phase_us"].values())


@pytest.mark.cuda
def test_recorded_capture_leaves_the_unrecorded_graph_alone():
    _cuda()
    ext = _ext(RODENT8, 20, width=8, lam=4.0).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5)
    sim.run(ext[:5])
    graph = sim.graphs.captured[5]
    nodes = _graph_nodes(graph)
    with spans.record():
        sim.run(ext[5:10])
    assert sim.graphs.captured == {5: graph}
    assert _graph_nodes(graph) == nodes
    recorded = sim.graphs._chunks[(5, 8, True)].graph
    assert _graph_nodes(recorded) == nodes + 5 * spans.N_MARKS
    sim.run(ext[10:15])
    assert _graph_nodes(sim.graphs.captured[5]) == nodes


@pytest.mark.cuda
def test_a_full_ring_keeps_the_newest_replays(monkeypatch):
    _cuda()
    monkeypatch.setattr(spans, "RING_TICKS", 12)
    ext = _ext(RODENT8, 25, width=8, lam=4.0).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5)
    with spans.record() as rec:
        sim.run(ext[:20])                    # four replays of 5 ticks
    kept = rec.marks()
    replays = [s.id for s in rec.spans if s.name == "chunk.replay"]
    assert [b.span for b, _ in kept] == replays[-2:]
    assert [b.slot for b, _ in kept] == [0, 5]
    ticks = np.concatenate([m for _, m in kept])
    assert (np.diff(ticks, axis=1) >= 0).all()
    assert (ticks[1:, 0] >= ticks[:-1, -1]).all()
    assert rec.summary()["ticks"] == 10


@pytest.mark.cuda
def test_calibrated_marks_lie_inside_their_replay():
    _cuda()
    ext = _ext(RODENT8, 25, width=8, lam=4.0).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5)
    sim.run(ext[:5])
    ends = []
    with spans.record() as rec:
        for lo in range(5, 25, 5):
            sim.run(ext[lo:lo + 5])
            torch.cuda.synchronize()
            ends.append(time.perf_counter_ns())
    kept = rec.marks()
    assert len(kept) == 4
    err = rec.clock_err_ns
    assert 0 <= err < 1_000_000
    for (block, m), end in zip(kept, ends):
        replay = rec.spans[block.span]
        assert replay.start_ns - err <= m.min() and m.max() <= end + err
        assert (np.diff(m, axis=1) >= 0).all()


@pytest.mark.cuda
def test_profiled_spans_stay_off_the_device_timeline():
    _cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ext = _ext(RODENT8, 10, width=8, lam=4.0).cuda()
    sim = Simulator(RODENT8, key=0, chunk=5)
    sim.run(ext[:5])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(ext[5:])
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    dev = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert {"chunk", "chunk.stage", "chunk.replay", "chunk.out"} <= host
    assert dev and not any(n.startswith("chunk") for n in dev)


@pytest.mark.cuda
def test_recorded_server_steps_on_the_card():
    _cuda()
    a, reqs_a = _toy_server("cuda")
    b, reqs_b = _toy_server("cuda")
    a.run(reqs_a)
    b.submit(reqs_b[0])
    b.step()
    with spans.record() as rec:
        b.run(reqs_b[1:])
    served = {r.rid: r for r in b.completed}
    assert len(served) == len(a.completed)
    for x in a.completed:
        np.testing.assert_array_equal(x.fired, served[x.rid].fired)
    s = rec.summary()
    assert s["steps"] and _finite(s["step_host_ms"])
    assert s["lane_device_ms"] > 0
