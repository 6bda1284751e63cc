"""Where a run's time goes: device marks inside the tick and host spans
around chunks and server steps, on one clock. Off unless a caller enters
the recorder:

    from repro_torch.core import spans
    with spans.record() as rec:       # the current CUDA device, or device=
        sim.run(ext)                  # or srv.step(), any driver
    rec.summary()                     # device us a tick of each phase, ...

* **Marks.** `engine.tick` marks the start of each tick (``tick.start``)
  and the end of each of its six phases (`PHASES`): ``bucket`` (the delay
  bucket and the merge with the drive), ``keys`` (empty: the WTA derives
  its keys itself), ``rows`` (the row phase: dedup, worklist, row
  kernel), ``wta`` (`hcu.periodic_update`, whose `hcu.wta_draw` derives
  the keys, draws and takes the argmax, and `select_fired`), ``cols``
  (the column phase) and ``fanout`` (the connectivity gathers and `enqueue_spikes`, or the
  split route's receive; its send then runs inside ``cols``). A backend
  without a phase marks where it would end, so that phase reads 0.
  Marks are written only into the buffer of a chunk that is being captured
  (CUDA) or run tick by tick (the CPU) while the recorder is on
  (`marking`): on CUDA a mark is one one-thread kernel (`csrc/spans.cu`)
  that writes the device's ``%globaltimer`` (ns) into slot (tick, mark) of
  the chunk's (ticks, 7) int64 buffer, captured into the chunk's graph, so
  every replay of that graph records it; on the CPU, whose operations are
  synchronous, it is `time.perf_counter_ns()`. `network.ChunkGraphs` keys
  a recorded graph apart from the unrecorded one and, after each recorded
  replay, copies the buffer into the recorder's ring on the device (a copy
  in stream order: no synchronisation). With the recorder off no mark is
  captured, so the graphs hold exactly the nodes they hold without this
  module.
* **Spans.** `span` records a host span at a chunk or server-step
  boundary, never inside a tick: its name, start and end on
  `time.perf_counter_ns`, the enclosing span (``parent``), an ``id`` and
  attributes. The drivers' spans: ``chunk`` (children ``chunk.stage``,
  ``chunk.replay``, ``chunk.out``) and ``chunk.capture`` in
  `network.network_run` / `ChunkGraphs.run`; ``serve.step`` (children
  ``serve.admit``, ``serve.stage``, ``serve.lanes``, ``serve.read``,
  ``serve.retire``, and under ``serve.lanes`` one ``serve.lane`` a lane)
  in `BCPNNRecallServer.step`. A request's spans are its `RecallRequest`
  timestamps (`request_spans`), linked to the steps by the ``rid`` and
  ``lane`` in ``serve.admit`` / ``serve.retire``. While torch.profiler
  records, each span is also a host range of the profile under its name (a
  function-scope range, which puts nothing on the device timeline), with
  the recorder on or off; otherwise an off span costs one flag read.
* **One clock.** On entry (and again on exit) the recorder measures the
  offset between ``%globaltimer`` and `perf_counter_ns`: a mark launched
  between two host reads around a synchronize, the tightest of a few
  rounds, its half-width the offset's error bound. Marks are reported on
  the host clock.

Spans and marks stay in memory until the caller reads them; there is no
exporter. One recorder at a time per process.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

MARKS = ("tick.start", "bucket", "keys", "rows", "wta", "cols", "fanout")
PHASES = MARKS[1:]
_INDEX = {m: i for i, m in enumerate(MARKS)}
N_MARKS = len(MARKS)
RING_TICKS = 1 << 17            # the device ring's ticks: 7.3 MB of marks

_recorder: "Recorder | None" = None     # the recorder entered, if any
_marks: "Marks | None" = None           # where the ticks now marking write
_NULL = contextlib.nullcontext()
# a host range of a profile in function scope: the profiler also draws a
# user-scope range (`record_function`) on the device timeline, where a
# trace would count it as device time
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


# ---------------------------------------------------------------------------
# device marks
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("spans")
    lib.span_mark.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.span_mark.restype = ctypes.c_int
    return lib


def _device_mark(buf: torch.Tensor, index: int) -> None:
    """Launch one mark into int64 ``buf``'s flat slot ``index`` on the
    current stream of its device."""
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = _lib().span_mark(buf.data_ptr() + 8 * index, stream)
    if rc:
        raise RuntimeError(f"span_mark failed (cudaError {rc})")


class Marks:
    """The marks of one chunk's ``ticks`` ticks: an int64 (ticks,
    `N_MARKS`) buffer on ``device`` (numpy on the CPU), in the device's
    nanoseconds. ``tick.start`` opens the next row."""

    def __init__(self, ticks: int, device):
        self.ticks = ticks
        self.device = torch.device(device)
        if self.device.type == "cpu":
            self.buf = np.zeros((ticks, N_MARKS), np.int64)
        else:
            self.buf = torch.zeros((ticks, N_MARKS), dtype=torch.int64,
                                   device=self.device)
        self._row = -1

    def mark(self, i: int) -> None:
        if i == 0:
            self._row += 1
            if self._row >= self.ticks:
                raise RuntimeError(f"a chunk of {self.ticks} ticks marked "
                                   "a tick more")
        if isinstance(self.buf, np.ndarray):
            self.buf[self._row, i] = time.perf_counter_ns()
        else:
            _device_mark(self.buf, self._row * N_MARKS + i)


def mark(name: str) -> None:
    """Mark ``name`` (one of `MARKS`) in the tick being captured or run,
    where `marking` has a buffer; nothing otherwise."""
    if _marks is not None:
        _marks.mark(_INDEX[name])


@contextlib.contextmanager
def marking(marks: Marks | None):
    """The ticks run inside write their marks into ``marks`` (None: no
    marks)."""
    global _marks
    prev, _marks = _marks, marks
    try:
        yield marks
    finally:
        _marks = prev


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    id: int | str
    name: str
    parent: int | str | None
    start_ns: int
    end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def span(name: str, **attrs):
    """A context manager that records the host span ``name`` (yielding
    its `Span`, or None with the recorder off), nested in the span open
    around it; also a profiler range while torch.profiler records."""
    rec = _recorder
    if rec is not None:
        return rec._span(name, attrs)
    if _profiler._is_profiler_enabled and _RANGE is not None:
        return _RANGE(name)
    return _NULL


def request_spans(requests) -> list[Span]:
    """The spans of served `RecallRequest`s, from their own timestamps
    (host seconds of `time.perf_counter`, the server's default clock):
    ``request`` (submit to finish) with children ``request.queue`` (submit
    to admission) and ``request.service`` (admission to finish), each
    carrying the request's ``rid`` and ``lane``; ids ``request:<rid>``."""
    ns = lambda s: None if s is None else int(round(s * 1e9))
    out = []
    for r in requests:
        if r.submit_s is None:
            continue
        attrs = {"rid": r.rid, "lane": r.lane, "status": r.status}
        rid = f"request:{r.rid}"
        out.append(Span(rid, "request", None, ns(r.submit_s), ns(r.finish_s),
                        dict(attrs)))
        if r.admit_s is not None:
            out.append(Span(f"{rid}:queue", "request.queue", rid,
                            ns(r.submit_s), ns(r.admit_s), dict(attrs)))
            out.append(Span(f"{rid}:service", "request.service", rid,
                            ns(r.admit_s), ns(r.finish_s), dict(attrs)))
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class Block(NamedTuple):
    """One recorded replay's marks: ``ticks`` rows of the ring from
    ``slot`` (CUDA) or the host array ``host`` (CPU), taken inside the
    span ``span`` (its id)."""
    slot: int
    ticks: int
    span: int | None
    host: np.ndarray | None


class Recorder:
    """Spans and marks of one recording (`record`). ``spans``: every
    host span, in the order they opened (a span's id is its index);
    ``offset_ns``: device clock minus host clock; ``clock_err_ns``: its
    error bound; ``drift_ns``: the offset at exit less the one at entry
    (None until exit, and on the CPU)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans: list[Span] = []
        self._open: list[int] = []
        self._blocks: collections.deque[Block] = collections.deque()
        self._pos = 0
        self.offset_ns = self.clock_err_ns = 0
        self.drift_ns = None
        self._ring = None
        if self.cuda:
            self._ring = torch.zeros((RING_TICKS, N_MARKS), dtype=torch.int64,
                                     device=self.device)
            self.offset_ns, self.clock_err_ns = self._calibrate()

    def _calibrate(self, rounds: int = 8) -> tuple[int, int]:
        """(offset, error bound) in ns: each round marks between two host
        reads around a synchronize; the tightest round's midpoint."""
        dev = self.device
        buf = torch.zeros(rounds, dtype=torch.int64, device=dev)
        host = []
        for i in range(rounds):
            torch.cuda.synchronize(dev)
            h0 = time.perf_counter_ns()
            _device_mark(buf, i)
            torch.cuda.synchronize(dev)
            host.append((h0, time.perf_counter_ns()))
        marks = buf.tolist()
        i = min(range(rounds), key=lambda k: host[k][1] - host[k][0])
        h0, h1 = host[i]
        return marks[i] - (h0 + h1) // 2, (h1 - h0 + 1) // 2

    def _close(self) -> None:
        if self.cuda:
            offset, err = self._calibrate()
            self.drift_ns = offset - self.offset_ns
            self.clock_err_ns = max(self.clock_err_ns, err)

    @contextlib.contextmanager
    def _span(self, name: str, attrs: dict):
        parent = self._open[-1] if self._open else None
        s = Span(len(self.spans), name, parent, time.perf_counter_ns(),
                 attrs=attrs)
        self.spans.append(s)
        self._open.append(s.id)
        ranged = _profiler._is_profiler_enabled and _RANGE is not None
        try:
            with _RANGE(name) if ranged else _NULL:
                yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            self._open.pop()

    def take(self, marks: Marks, span: Span | None) -> None:
        """Keep a replay's (or a CPU chunk's) marks, inside ``span``: a
        device buffer is copied into the ring in stream order, the oldest
        blocks overwritten when it is full; a host one is kept as it is."""
        sid = None if span is None else span.id
        if isinstance(marks.buf, np.ndarray):
            self._blocks.append(Block(0, marks.ticks, sid, marks.buf))
            return
        if self._ring is None:
            raise RuntimeError(f"a recorder on {self.device} took marks of "
                               f"{marks.device}: record on that device")
        L = marks.ticks
        if L > RING_TICKS:
            raise ValueError(f"a chunk of {L} ticks outgrows the ring of "
                             f"{RING_TICKS}")
        if self._pos + L > RING_TICKS:
            self._pos = 0
        lo, hi = self._pos, self._pos + L
        while self._blocks and self._blocks[0].slot < hi \
                and self._blocks[0].slot + self._blocks[0].ticks > lo:
            self._blocks.popleft()
        self._ring[lo:hi].copy_(marks.buf)
        self._blocks.append(Block(lo, L, sid, None))
        self._pos = hi

    def marks(self) -> list[tuple[Block, np.ndarray]]:
        """Each kept block with its (ticks, `N_MARKS`) marks in host-clock
        ns, oldest first (reads the ring back: a synchronisation)."""
        ring = None if self._ring is None else self._ring.cpu().numpy()
        out = []
        for b in self._blocks:
            m = b.host if b.host is not None else \
                ring[b.slot:b.slot + b.ticks] - self.offset_ns
            out.append((b, m))
        return out

    def _ancestor(self, sid, name: str):
        while sid is not None:
            s = self.spans[sid]
            if s.name == name:
                return s
            sid = s.parent
        return None

    def summary(self) -> dict:
        """Over the ticks whose marks are kept:

        * ``phase_us``: device us a tick of each phase of `PHASES`;
        * ``between_us``: us a tick from a tick's last mark to the next
          tick's first inside one replay (the fired row's copy);
        * ``replay_gap_us``: us a tick from the last mark of one replay to
          the first of the next (the graph's carry copies, the next
          chunk's input copy, and the device's idle time between);
        * ``marked_tick_us``: the sum of those three, the marked span from
          the first mark to the last over the ticks;
        * ``steps``: for each ``serve.step`` with marked lanes, its wall
          ms, the span of its lanes' marks (ms), their difference (the
          host time the device waits for within the step) and its
          lane-ticks; ``step_host_ms`` their median, ``lane_device_ms``
          the lanes' marked ms over their lane-ticks (each lane from its
          first mark to its last);
        * the clock: ``offset_ns``, ``clock_err_ns``, ``drift_ns``.

        Numbers that have nothing to read are None."""
        kept = self.marks()
        out = {"ticks": sum(b.ticks for b, _ in kept), "phase_us": None,
               "between_us": None, "replay_gap_us": None,
               "marked_tick_us": None, "steps": [], "step_host_ms": None,
               "lane_device_ms": None, "offset_ns": self.offset_ns,
               "clock_err_ns": self.clock_err_ns, "drift_ns": self.drift_ns}
        if not kept:
            return out
        n = out["ticks"]
        ticks = np.concatenate([m for _, m in kept])
        phase = np.diff(ticks, axis=1).sum(0) / n * 1e-3
        between = sum(int((m[1:, 0] - m[:-1, -1]).sum()) for _, m in kept)
        gap = sum(int(b[0, 0] - a[-1, -1])
                  for (_, a), (_, b) in zip(kept, kept[1:]))
        out.update(phase_us=dict(zip(PHASES, phase.tolist())),
                   between_us=between / n * 1e-3, replay_gap_us=gap / n * 1e-3,
                   marked_tick_us=(int(kept[-1][1][-1, -1])
                                   - int(kept[0][1][0, 0])) / n * 1e-3)
        steps = {}
        for b, m in kept:
            step = None if b.span is None else self._ancestor(b.span,
                                                              "serve.step")
            if step is not None:
                steps.setdefault(step.id, (step, []))[1].append(m)
        lane_ns = lane_ticks = 0
        for step, ms in steps.values():
            first = min(int(m[0, 0]) for m in ms)
            last = max(int(m[-1, -1]) for m in ms)
            wall = step.end_ns - step.start_ns
            ticks_ = sum(m.shape[0] for m in ms)
            out["steps"].append({"id": step.id, "wall_ms": wall * 1e-6,
                                 "lanes_ms": (last - first) * 1e-6,
                                 "host_ms": (wall - (last - first)) * 1e-6,
                                 "lane_ticks": ticks_})
            lane_ns += sum(int(m[-1, -1] - m[0, 0]) for m in ms)
            lane_ticks += ticks_
        if steps:
            out["step_host_ms"] = statistics.median(
                s["host_ms"] for s in out["steps"])
            out["lane_device_ms"] = lane_ns / lane_ticks * 1e-6
        return out


def recorder() -> Recorder | None:
    """The recorder entered, or None."""
    return _recorder


@contextlib.contextmanager
def record(device=None):
    """Record spans and marks until the block ends; yields the `Recorder`.
    ``device``: where the marked ticks run (default: the current CUDA
    device if there is one, else the CPU). Graphs captured inside are
    recorded graphs, kept beside the unrecorded ones of the same length;
    the ticks of a capture marked under one setting are never replayed
    under the other."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already on")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    rec = Recorder(device)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        rec._close()
