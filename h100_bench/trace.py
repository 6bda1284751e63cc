"""A device trace of part of a run, and the reductions of it that the
per-layer metrics and the ``breakdown`` read.

`Trace` runs a callable under `torch.profiler` (host and CUDA activity)
and keeps each device operation as (name, start us, end us) and each host
operation likewise; the host clock's wall seconds of the traced call,
which ends in a synchronize, are its window.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch


@dataclasses.dataclass
class Trace:
    device_ops: list          # (name, start_us, end_us), by start
    host_ops: list            # (name, start_us, end_us), by start
    window_s: float           # host wall seconds of the traced call

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        return union_us(self.device_ops) * 1e-6

    def op_seconds(self, match=None) -> float:
        """Summed durations of the device operations whose name contains
        ``match`` (all of them where None)."""
        return sum(e - s for n, s, e in self.device_ops
                   if match is None or match in n) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the longest idle gaps between device operations, each named by the
        host operation that was running at the gap's middle."""
        by = collections.Counter()
        for n, s, e in self.device_ops:
            by[n] += (e - s) * 1e-6
        ops = [[n[:120], v] for n, v in by.most_common(top)]
        gaps = []
        end = None
        for n, s, e in self.device_ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        named = []
        for g, a, b in gaps[:top]:
            mid = (a + b) / 2
            host = [h for h in self.host_ops if h[1] <= mid <= h[2]]
            label = min(host, key=lambda h: h[2] - h[1])[0] if host else \
                "host: no operation"
            named.append([label[:120], g * 1e-6])
        return {"device_ops": ops, "idle_gaps": named}


def union_us(ops) -> float:
    total, end = 0.0, None
    for _, s, e in ops:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _events(prof):
    """(device ops, host ops) of a finished profile, from the raw kineto
    events where the build exposes them (much faster than building the
    profiler's FunctionEvents for ~1e5 device operations)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            s = e.start_ns() / 1e3
            item = (e.name(), s, s + e.duration_ns() / 1e3)
            (dev if e.device_type() == DeviceType.CUDA else host).append(item)
    else:
        for e in prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            (dev if e.device_type == DeviceType.CUDA else host).append(item)
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def trace(fn, device) -> Trace:
    """Run fn() under the profiler and synchronize inside the traced span
    (host activity only on the CPU, where the tests run it)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    return Trace(dev, host, window)
