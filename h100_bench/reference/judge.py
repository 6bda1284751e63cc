"""The comparisons that decide ``correct``: the reference's replay of a
fired history and the gaps and differences it reads.

* ``wta_gap``: at each spike of a simulated HCU, how far the fired
  minicolumn's WTA score (support over temperature plus its Gumbel noise)
  lies below the best score the reference computes for that HCU and tick.
  0 where the fired minicolumn is the reference's own choice.
* ``fire_mismatch``: ticks and HCUs where firing at all differs from the
  reference's draw.
* ``state_err``: over the float leaves compared, the largest
  ``max|program - reference|`` over ``max|reference|`` of the leaf.
* ``int_mismatch``: entries of the integer leaves (timestamps, delay
  queues, counts, drop counters, the time) that differ.

The control, the reference with its ij planes held in bfloat16, runs in
lockstep with the float32 reference on the same inputs; its reading of
``wta_gap`` is the gap of the minicolumn that it puts first.
"""
from __future__ import annotations

import torch

from h100_bench.reference import network as RN


def replay(net: RN.RefNet, fired, batch, ext_of, t0: int,
           control: RN.RefNet | None = None, chunk: int = 128):
    """Run ``net`` (and ``control``) over ticks t0+1 .. t0+T of the fired
    history ``fired`` (T, n) and its fired batch ``batch``, teacher-forced
    on both; ext_of(k) gives the sample's drive (S, width) at tick t0+1+k.
    On CUDA each run of ``chunk`` ticks is captured once as a CUDA graph
    and replayed (the ticks read their inputs from buffers filled before
    each replay); on the CPU the ticks run one by one. Returns (readings,
    control readings or None)."""
    dev, S, sample = net.dev, net.S, net.sample
    T, n = fired.shape
    C = net.p.cols
    L = min(chunk, T)
    first = torch.stack([ext_of(i) for i in range(L)])   # each tick once
    buf = dict(ext=torch.empty(first.shape, dtype=torch.int32, device=dev),
               batch=torch.empty((L, n), dtype=torch.int64, device=dev),
               win=torch.empty((L, S), dtype=torch.int64, device=dev),
               fired=torch.empty((L, S), dtype=torch.int64, device=dev),
               noise=torch.empty((L, S, C), dtype=torch.float32, device=dev),
               fire=torch.empty((L, S), dtype=torch.bool, device=dev),
               t=torch.zeros((), dtype=torch.int32, device=dev))
    ctrl_gap = torch.zeros((), dtype=torch.float32, device=dev)
    for m in (net, control):
        if m is not None:
            m.gap.zero_()
            m.mismatch.zero_()
            m.overflow.zero_()

    def ticks(k: int):
        for i in range(k):
            args = (buf["t"] + (i + 1), buf["ext"][i], buf["batch"][i],
                    buf["win"][i], buf["fired"][i], buf["noise"][i],
                    buf["fire"][i])
            scores = net.tick(*args)
            if control is not None:
                pick = control.tick(*args).argmax(dim=1)
                on = buf["fired"][i] >= 0
                gap = scores.max(dim=1).values - scores.gather(
                    1, pick[:, None])[:, 0]
                ctrl_gap.copy_(torch.maximum(
                    ctrl_gap, torch.where(on, gap, 0.0).max()))

    graphs = {}
    for lo in range(0, T, L):
        k = min(L, T - lo)
        buf["t"].fill_(t0 + lo)
        buf["ext"][:k] = first if lo == 0 else torch.stack(
            [ext_of(lo + i) for i in range(k)])
        buf["batch"][:k] = batch[lo:lo + k]
        buf["win"][:k] = batch[lo:lo + k][:, sample]
        buf["fired"][:k] = fired[lo:lo + k][:, sample]
        buf["fire"][:k], buf["noise"][:k] = net.draws(t0 + lo + 1, k)
        if dev.type != "cuda":
            ticks(k)
            continue
        if k not in graphs:
            graphs[k] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[k]):
                ticks(k)
        graphs[k].replay()
    readings = {"wta_gap": float(net.gap), "fire_mismatch": int(net.mismatch),
                "overflow": int(net.overflow)}
    return readings, (None if control is None else
                      {"wta_gap": float(ctrl_gap)})


BLOCK = 1 << 26


def compare(prog: dict, ref: dict):
    """(state_err, int_mismatch) over the leaves both dicts hold."""
    err, bad, nan = 0.0, 0, False
    for k in prog:
        a, b = prog[k], ref[k]
        if not torch.is_tensor(a):
            bad += int(a != b)
        elif a.dtype.is_floating_point:
            a, b = a.reshape(-1), b.reshape(-1)
            scale = diff = 0.0
            for lo in range(0, b.numel(), BLOCK):
                x = a[lo:lo + BLOCK].to(b.device).double()
                y = b[lo:lo + BLOCK].double()
                scale = max(scale, float(y.abs().max()))
                diff = max(diff, float((x - y).abs().max()))
                nan = nan or bool(torch.isnan(x).any())
            err = max(err, diff / scale if scale > 0 else diff)
        else:
            a, b = a.reshape(-1), b.reshape(-1)
            for lo in range(0, b.numel(), BLOCK):
                bad += int((a[lo:lo + BLOCK].to(b.device).long()
                            != b[lo:lo + BLOCK].long()).sum())
    return (float("nan") if nan else err), bad
