"""Driver of the simulation cells: `Simulator.run` over successive chunks
of a drive mix (`generator.DriveStream`).

Set-up: the network is built on the device from the seed's key (the
port's own init and connectivity), the drive stream is seeded, and
``warmup_chunks`` chunks run (the first captures the chunk's CUDA graph).
Window: chunks of ``chunk`` ticks until ``--seconds`` have passed, at most
two in flight; the wall time ends in a synchronize. ``tick_us`` is the
window's wall time over the ticks it ran. With ``--trace 1`` the
``trace_chunks`` chunks after the warm-up run under the profiler first.

Check: the whole fired history (set-up and window, kept in pinned host
memory so that ``peak_gib`` counts the program alone), a sample of HCUs'
state and delay queues and every HCU's queue counts are copied out, the
program is freed, and the reference replays the sample over every tick
(`reference.judge.replay`), reading the other HCUs' spikes from the
history.
"""
from __future__ import annotations

import gc
import time

import torch

from h100_bench import generator, graphs, harness
from h100_bench import trace as tr
from h100_bench.reference import judge
from h100_bench.reference import network as RN
from h100_bench.reference import threefry as TF

class LayerCtx:
    """What the simulation cells' per-layer readers read."""

    def __init__(self, trace, ticks, nv, nf, n, R, C, W, K, graph_nodes,
                 chunk):
        self.trace, self.ticks = trace, ticks
        self.nv, self.nf = nv, nf              # per traced tick
        self.n, self.R, self.C, self.W, self.K = n, R, C, W, K
        self.graph_nodes, self.chunk = graph_nodes, chunk


def sample_hcus(n: int, k: int, seed: int):
    g = torch.Generator().manual_seed((seed ^ 0x5A3D) & generator.SEED_MASK)
    return torch.sort(torch.randperm(n, generator=g)[:min(k, n)]).values


def program_outputs(sim, sample):
    """The sample's state and delay queues (the reference's layout: planes
    (S*R, C), i-vectors (S*R,)), every HCU's queue counts, the drop
    counters and the time, copied off the program's state."""
    hc = sim.hcus()                     # batched (H, R, C) view, flat order
    st = sim.state
    s = sample.to(st.t.device)
    out = {}
    for f in ("zij", "eij", "pij", "wij", "tij"):
        v = getattr(hc, f)[s]
        out[f] = v.reshape(-1, v.shape[-1])
    for f in ("zi", "ei", "pi", "ti"):
        out[f] = getattr(hc, f)[s].reshape(-1)
    for f in ("zj", "ej", "pj", "h"):
        out[f] = getattr(hc, f)[s].clone()
    out["delay_rows"] = st.delay_rows[s].clone()
    out["delay_count"] = st.delay_count[s].clone()
    whole = {"delay_count": st.delay_count.clone(),
             "drops_in": int(st.drops_in), "drops_fire": int(st.drops_fire),
             "t": int(st.t)}
    return out, whole


def delivered_rows(p: RN.Params, conn, batch, ext_chunks, t_first: int,
                   t_last: int):
    """Distinct rows delivered to each HCU at each tick t_first..t_last (the
    fan-out of the fired batch ``batch`` (T, n), row k being tick k+1, and
    the drive ``ext_chunks`` of those ticks, (L, n, width)). Returns a
    list of per-tick sums over HCUs."""
    n, R, D = p.n_hcu, p.rows, p.max_delay
    dev = batch.device
    keys = []
    for ts in range(max(1, t_first - (D - 1)), t_last):
        h = torch.nonzero(batch[ts - 1] >= 0).squeeze(1)
        j = batch[ts - 1, h].long()
        arr = ts + conn.delay[h, j].reshape(-1).long()
        dst = conn.dest_hcu[h, j].reshape(-1).long()
        row = conn.dest_row[h, j].reshape(-1).long()
        m = (arr >= t_first) & (arr <= t_last)
        keys.append(((arr[m] - t_first) * n + dst[m]) * R + row[m])
    L = t_last - t_first + 1
    e = ext_chunks.long()
    tt = torch.arange(L, device=dev)[:, None, None]
    hh = torch.arange(n, device=dev)[None, :, None]
    ek = ((tt * n + hh) * R + e)[e < R]
    keys.append(ek.reshape(-1))
    u = torch.unique(torch.cat(keys))
    return torch.bincount(u // (n * R), minlength=L).tolist()


def run(ctx: harness.Ctx) -> harness.Outcome:
    from repro_torch.core import Simulator
    from repro_torch.core.params import BCPNNParams

    cfg, mix, lim = ctx.config, ctx.mix, ctx.limits
    cuda = ctx.device != "cpu"
    dev = torch.device(ctx.device)
    sim_kw = cfg.get("simulator", {})
    params = harness.program_params(BCPNNParams, cfg)
    n, R, C = params.n_hcu, params.rows, params.cols
    chunk = int(mix["chunk"])
    key = TF.key_from_seed(ctx.seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sim = Simulator(params, key=key.to(dev), device=dev, **sim_kw)
    stream = generator.DriveStream(mix, n, R, ctx.seed, dev)
    fired = []

    def one_chunk():
        f = sim.run(stream.next(chunk)).to(torch.int8)
        if cuda:    # the history waits on the host, out of the card's peak
            host = torch.empty(f.shape, dtype=torch.int8, pin_memory=True)
            f = host.copy_(f, non_blocking=True)
        fired.append(f)

    for _ in range(int(mix["warmup_chunks"])):
        one_chunk()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    trace = None
    traced = (0, 0)
    if ctx.trace:
        k0 = len(fired)
        trace = tr.trace(lambda: [one_chunk() for _ in
                                  range(int(mix["trace_chunks"]))], dev)
        traced = (k0 * chunk + 1, len(fired) * chunk)

    t0 = time.perf_counter()
    k_first = len(fired)
    evs, host = [], []
    while True:
        h0 = time.perf_counter()
        one_chunk()
        host.append(time.perf_counter() - h0)
        if cuda:
            evs.append(torch.cuda.Event(enable_timing=True))
            evs[-1].record()
            if len(evs) > 1:
                evs[-2].synchronize()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ticks = (len(fired) - k_first) * chunk
    # each chunk's pace on the device (us a tick), to tell a slow process
    # from a slow stretch of one, and the host's time to enqueue a chunk
    pace = sorted(a.elapsed_time(b) * 1e3 / chunk
                  for a, b in zip(evs, evs[1:]))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    nodes = None
    if ctx.trace and cuda and chunk in sim.graphs.captured:
        nodes = graphs.graph_nodes(sim.graphs.captured[chunk])

    # the check: copy out what is compared, free the program
    sample = sample_hcus(n, int(lim["sample_hcus"]), ctx.seed).to(dev)
    prog, whole = program_outputs(sim, sample)
    hist = torch.cat(fired)
    del sim, fired
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rp = RN.Params.from_dict(cfg)
    key = key.to(dev)
    conn = RN.connectivity(rp, key)
    cap = rp.fire_cap(sim_kw.get("cap_fire"))
    hist = hist.to(dev, torch.int64)
    T = hist.shape[0]
    batch = RN.fired_batch(hist, cap)
    fire_all = RN.fire_draws(rp, RN.base_key(key), 1, T)
    fire_mismatch = int((fire_all != (hist >= 0)).sum())
    del fire_all
    counts, d_in, d_fire = RN.queue_counts(rp, conn, hist, 0, cap)
    int_bad = (int((counts != whole["delay_count"].long()).sum())
               + int(d_in != whole["drops_in"]) + int(d_fire != whole["drops_fire"])
               + int(T != whole["t"]))
    net = RN.RefNet(rp, sample, key, conn)
    control = (RN.RefNet(rp, sample, key, conn, plane_dtype=torch.bfloat16)
               if ctx.control else None)
    ref_stream = generator.DriveStream(mix, n, R, ctx.seed, dev)
    ext = {}

    def ext_of(k):
        if k % chunk == 0:
            full = ref_stream.next(chunk)
            ext["s"] = full[:, sample]
            if traced[0] <= k + 1 <= traced[1]:
                ext.setdefault("traced", []).append(full)
        return ext["s"][k % chunk]

    readings, ctrl = judge.replay(net, hist, batch, ext_of, 0, control)
    err, bad = judge.compare(prog, net.snapshot())
    checks = {
        "reference_overflow": (readings["overflow"], 0),
        "fire_mismatch": (fire_mismatch + readings["fire_mismatch"],
                          lim["fire_mismatch"]),
        "int_mismatch": (int_bad + bad, lim["int_mismatch"]),
        "wta_gap": (readings["wta_gap"], lim["wta_gap"]),
        "state_err": (err, lim["state_err"]),
    }
    control_out = None
    if control is not None:
        c_err, c_bad = judge.compare(control.snapshot(), net.snapshot())
        control_out = {"wta_gap": ctrl["wta_gap"], "state_err": c_err,
                       "int_mismatch": c_bad}
    layer_ctx = None
    if ctx.trace:
        L = traced[1] - traced[0] + 1
        nv = delivered_rows(rp, conn, batch, torch.cat(ext["traced"]),
                            traced[0], traced[1])
        nf = (batch[traced[0] - 1:traced[1]] >= 0).sum(1).tolist()
        W = n * (rp.active_queue + int(mix["width"]))
        layer_ctx = LayerCtx(trace, L, nv, nf, n, R, C, W, cap, nodes, chunk)
    notes = {"ticks_window": ticks, "window_s": wall,
             "ticks_checked": T, "sample_hcus": int(sample.shape[0]),
             "check_s": time.perf_counter() - t_check,
             "spikes": int((hist >= 0).sum()), "drops_in": d_in,
             "drops_fire": d_fire}
    if pace:
        notes.update(chunk_tick_us_min=pace[0],
                     chunk_tick_us_median=pace[len(pace) // 2],
                     chunk_tick_us_max=pace[-1])
    host.sort()
    notes.update(chunk_host_ms_median=host[len(host) // 2] * 1e3,
                 chunk_host_ms_max=host[-1] * 1e3)
    return harness.Outcome(
        e2e={"tick_us": wall / ticks * 1e6, "peak_gib": peak / 2**30,
             "setup_s": setup_s},
        attempted=ticks, failed=0, memory_peak_bytes=peak, checks=checks,
        layer_ctx=layer_ctx, trace=trace, control=control_out, notes=notes)
