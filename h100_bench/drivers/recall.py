"""Driver of the recall-serving cells: `BCPNNRecallServer` under an open
loop of a recall mix (`generator.recall_traffic`).

Set-up: the network is built from the seed's key, `train_assoc` stores the
mix's patterns (its fired history is recorded for the check), the server
takes the trained state as its template, and ``warmup_sessions`` sessions
run through it (the first step captures every lane's graph).
Window: sessions are submitted when due (the generator's arrival times
from the window's start), the server steps whenever it holds work, and the
run waits until every session due in the window has an answer.
``recall_p90_ms`` is the 90th percentile of the sessions' sojourn from the
time each was due; a rejected session counts as failed and as slower than
any answer. With ``--trace 1``, ``trace_steps`` steps of the warm-up
(after the capture, lanes full) run under the profiler.

Check: each sampled session's lane (a seeded sample of the sessions, and
the longest one) is snapshotted when it completes: the j-vectors, delay
queues, drop counters and time of every HCU, the planes and i-vectors of
``check_hcus`` HCUs. After the window the reference trains its own
template from the patterns, teacher-forced on the recorded training
history, compares it with the program's, and replays each sampled
session from it over the session's served trajectory.
"""
from __future__ import annotations

import gc
import logging
import math
import time

import numpy as np
import torch

from h100_bench import generator, harness
from h100_bench import trace as tr
from h100_bench.reference import judge
from h100_bench.reference import network as RN
from h100_bench.reference import threefry as TF

PLANES = ("zij", "eij", "pij", "wij", "tij")
IVECS = ("zi", "ei", "pi", "ti")
JVECS = ("zj", "ej", "pj", "h")


class LayerCtx:
    def __init__(self, trace, lane_ticks, col_cells):
        self.trace, self.lane_ticks, self.col_cells = trace, lane_ticks, col_cells


def lane_snapshot(state, rows):
    """The compared leaves of one lane (a single-session NetworkState in
    the flat layout): planes and i-vectors at the flat rows ``rows``,
    every HCU's j-vectors and queues, the counters and the time."""
    hc = state.hcus
    out = {f: getattr(hc, f)[rows].clone() for f in PLANES + IVECS}
    out.update({f: getattr(hc, f).clone() for f in JVECS})
    out["delay_rows"] = state.delay_rows.clone()
    out["delay_count"] = state.delay_count.clone()
    out["drops_in"] = state.drops_in.clone()
    out["drops_fire"] = state.drops_fire.clone()
    out["t"] = state.t.clone()
    return out


def template_leaves(state):
    """Every compared leaf of a whole NetworkState (the template)."""
    hc = state.hcus
    out = {f: getattr(hc, f) for f in PLANES + IVECS + JVECS}
    out["delay_rows"] = state.delay_rows
    out["delay_count"] = state.delay_count
    return out


def percentile(values, q: float) -> float:
    """numpy's linear percentile; infinities (failed sessions) sort last."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Service:
    """The recall service of one run, set up: the trained template in a
    `BCPNNRecallServer`, warmed, and what the check needs of the set-up."""

    def __init__(self, ctx: harness.Ctx, patterns):
        from repro_torch.core import Simulator
        from repro_torch.core.params import BCPNNParams
        from repro_torch.experiments import train_assoc
        from repro_torch.launch.serve_bcpnn import BCPNNRecallServer

        cfg, mix = ctx.config, ctx.mix
        srv_cfg = cfg["serving"]
        self.dev = torch.device(ctx.device)
        params = harness.program_params(BCPNNParams, cfg, srv_cfg["params"])
        self.n, self.R = params.n_hcu, params.rows
        self.budget = int(mix["budget_ticks"])
        self.patterns = patterns
        self.key = TF.key_from_seed(ctx.seed)
        sim = Simulator(params, key=self.key.to(self.dev), device=self.dev,
                        cap_fire=int(srv_cfg["cap_fire"]),
                        **cfg.get("simulator", {}))
        self.train_fired = []
        run_once = sim.run

        def recording(ext, *a, **k):
            f = run_once(ext, *a, **k)
            self.train_fired.append(f.to(torch.int8))
            return f

        sim.run = recording
        train_assoc(sim, patterns.numpy(), reps=int(mix["train_reps"]),
                    present_ms=int(mix["present_ms"]),
                    gap_ms=int(mix["gap_ms"]))
        del sim.run
        self.srv = BCPNNRecallServer(
            sim, slots=int(srv_cfg["slots"]),
            queue_capacity=int(srv_cfg["queue_capacity"]),
            step_ticks=int(srv_cfg["step_ticks"]),
            ext_width=int(srv_cfg["ext_width"]))

    def request(self, rid, pattern, cue_mask):
        from repro_torch.launch.serve_bcpnn import RecallRequest
        return RecallRequest(rid, self.patterns[pattern].numpy(),
                             cue_mask.numpy(), budget_ticks=self.budget)

    def warm(self, sessions, k: int, trace_steps: int = 0):
        """Serve k sessions (cues of the mix, ids below 0) to the end: the
        first step captures every lane's graph. With ``trace_steps``, that
        many steps after it run under the profiler (lanes full while k is
        at least twice the lanes). Returns (trace or None, steps traced)."""
        P = self.patterns.shape[0]
        for i in range(k):
            self.srv.submit(self.request(-1 - i, i % P,
                                         sessions[i % len(sessions)].cue_mask))
        self.srv.step()
        trace, before = None, self.srv.steps
        if trace_steps:
            trace = tr.trace(lambda: [self.srv.step() for _ in
                                      range(trace_steps)], self.dev)
        traced = self.srv.steps - before
        while self.srv.busy:
            self.srv.step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return trace, traced

    def open_loop(self, sessions, seconds, on_done=None,
                  wait_s: float = 60.0):
        """Offer ``sessions`` when due (seconds after the call), step the
        server while it holds work, and return once every session has an
        answer (or ``wait_s`` past ``seconds``). Returns a dict: reqs (rid
        -> request, ``due_s`` on the host clock), lateness (s), wall (s),
        backlog (sessions queued or in a lane when the last one was
        offered)."""
        srv = self.srv
        out = {"reqs": {}, "lateness": [], "backlog": None}
        nxt = 0
        t0 = time.perf_counter()

        def serve_once():
            nonlocal nxt
            now = time.perf_counter() - t0
            while nxt < len(sessions) and sessions[nxt].due_s <= now:
                s = sessions[nxt]
                r = self.request(s.rid, s.pattern, s.cue_mask)
                srv.submit(r)
                r.due_s = t0 + s.due_s
                out["lateness"].append(now - s.due_s)
                out["reqs"][s.rid] = r
                nxt += 1
                if nxt == len(sessions):
                    out["backlog"] = len(srv.queue) + sum(
                        a is not None for a in srv.active)
            if srv.busy:
                done = srv.step()
                if on_done is not None:
                    on_done(done)
                return True
            if nxt < len(sessions):
                time.sleep(max(0.0, sessions[nxt].due_s
                               - (time.perf_counter() - t0)))
                return True
            return False

        while time.perf_counter() - t0 < seconds + wait_s:
            if not serve_once():
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        out["wall"] = time.perf_counter() - t0
        return out


def sojourns(sessions, reqs):
    """Each session's ms from due to answer (inf: rejected or never
    answered), the rejected count and the unanswered count."""
    ms, rejected, unanswered = [], 0, 0
    for s in sessions:
        r = reqs.get(s.rid)
        if r is None or r.status == "rejected":
            rejected += 1
            ms.append(math.inf)
        elif r.finish_s is None:
            unanswered += 1
            ms.append(math.inf)
        else:
            ms.append((r.finish_s - r.due_s) * 1e3)
    return ms, rejected, unanswered


def run(ctx: harness.Ctx) -> harness.Outcome:
    from repro_torch.core import network as N

    # the server's health monitor logs each step past realtime; a lane step
    # is far past it by design, so keep standard error for the result
    logging.getLogger("repro_torch").setLevel(logging.ERROR)
    cfg, mix, lim = ctx.config, ctx.mix, ctx.limits
    srv_cfg = cfg["serving"]
    cuda = ctx.device != "cpu"
    dev = torch.device(ctx.device)
    n, R = int(cfg["n_hcu"]), int(cfg["rows"])
    width = int(srv_cfg["ext_width"])
    patterns, sessions = generator.recall_traffic(mix, n, R, ctx.seed,
                                                  ctx.seconds)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    svc = Service(ctx, patterns)
    trace, traced_steps = svc.warm(
        sessions, int(mix["warmup_sessions"]),
        int(mix["trace_steps"]) if ctx.trace else 0)
    setup_s = time.perf_counter() - ctx.t_start
    srv, key, train_fired = svc.srv, svc.key, svc.train_fired
    P = patterns.shape[0]

    # the sampled sessions: a seeded sample, and the longest served
    g = torch.Generator().manual_seed((ctx.seed ^ 0x7E11) & generator.SEED_MASK)
    picked = set(torch.randperm(len(sessions), generator=g)[
        :int(mix["snapshots"])].tolist())
    check = torch.sort(torch.randperm(n, generator=g)[
        :int(lim["check_hcus"])]).values
    rows = (check[:, None] * R + torch.arange(R)).reshape(-1).to(dev)
    snaps, longest = {}, None
    ticks_of = {}

    def finished(done):
        nonlocal longest
        for r in done:
            if r.rid < 0:
                continue
            ticks_of[r.rid] = r.ticks
            view = N.take_session(srv.stacked, r.lane)
            if r.rid in picked:
                snaps[r.rid] = lane_snapshot(view, rows)
            elif longest is None or r.ticks > ticks_of[longest]:
                if longest is not None and longest not in picked:
                    snaps.pop(longest, None)
                longest = r.rid
                snaps[r.rid] = lane_snapshot(view, rows)

    served = svc.open_loop(sessions, ctx.seconds, finished)
    reqs, lateness, wall = served["reqs"], served["lateness"], served["wall"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sojourn, failed, unanswered = sojourns(sessions, reqs)
    p90 = percentile(sojourn, 90)

    # the check: keep the template and the snapshots, free the server
    template = srv.template
    lane_ticks = traced_steps * srv.slots * srv.step_ticks
    steps = srv.steps
    del srv, svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rp = RN.Params.from_dict({**cfg, **srv_cfg["params"]})
    key = key.to(dev)
    conn = RN.connectivity(rp, key)
    cap = int(srv_cfg["cap_fire"])
    everyone = torch.arange(n, device=dev)
    net = RN.RefNet(rp, everyone, key, conn)
    control = (RN.RefNet(rp, everyone, key, conn, plane_dtype=torch.bfloat16)
               if ctx.control else None)
    hist = torch.cat(train_fired).to(torch.int64)
    T0 = hist.shape[0]
    all_on = torch.ones(n, dtype=torch.bool)
    silence = torch.full((n, width), R, dtype=torch.int32)
    frames = []
    for _ in range(int(mix["train_reps"])):
        for pid in range(P):
            f = generator.cue_frame(patterns[pid], all_on, R, width)
            frames += [f] * int(mix["present_ms"])
        frames += [silence] * int(mix["gap_ms"])
    frames = [f.to(dev) for f in frames]
    batch = RN.fired_batch(hist, cap)
    fire_bad = int((RN.fire_draws(rp, RN.base_key(key), 1, T0)
                    != (hist >= 0)).sum())
    readings, ctrl = judge.replay(net, hist, batch, lambda k: frames[k], 0,
                                  control)
    gap, c_gap = readings["wta_gap"], (ctrl or {}).get("wta_gap", 0.0)
    fire_bad += readings["fire_mismatch"]
    overflow = readings["overflow"]
    counts0, din0, dfire0 = RN.queue_counts(rp, conn, hist, 0, cap)
    ref_template = net.snapshot()
    err, bad = judge.compare(template_leaves(template), ref_template)
    bad += (int(din0 != int(template.drops_in))
            + int(dfire0 != int(template.drops_fire))
            + int(T0 != int(template.t)))
    c_err = c_bad = 0
    if control is not None:
        c_template = control.snapshot()
        c_err, c_bad = judge.compare(c_template, ref_template)
    del template
    gc.collect()
    checked = 0
    for rid, snap in sorted(snaps.items()):
        r = reqs[rid]
        s = sessions[rid]
        frame = generator.cue_frame(patterns[s.pattern], s.cue_mask, R,
                                    width).to(dev)
        shist = torch.from_numpy(np.asarray(r.fired)).to(dev, torch.int64)
        sbatch = RN.fired_batch(shist, cap)
        net.load(ref_template)
        if control is not None:
            control.load(c_template)
        rd, cd = judge.replay(net, shist, sbatch, lambda k: frame, T0, control)
        gap = max(gap, rd["wta_gap"])
        overflow += rd["overflow"]
        fire_bad += rd["fire_mismatch"] + int(
            (RN.fire_draws(rp, RN.base_key(key), T0 + 1, shist.shape[0])
             != (shist >= 0)).sum())
        _, din, dfire = RN.queue_counts(rp, conn, shist, T0, cap,
                                        counts0, (din0, dfire0))
        ref = net.snapshot()
        ref_cut = {f: ref[f][rows] for f in PLANES + IVECS}
        ref_cut.update({f: ref[f] for f in JVECS + ("delay_rows", "delay_count")})
        e, b = judge.compare({k: snap[k] for k in ref_cut}, ref_cut)
        err, bad = max(err, e), bad + b
        bad += (int(din != int(snap["drops_in"]))
                + int(dfire != int(snap["drops_fire"]))
                + int(T0 + shist.shape[0] != int(snap["t"])))
        if control is not None:
            c_gap = max(c_gap, cd["wta_gap"])
            cs = control.snapshot()
            e, b = judge.compare({f: cs[f][rows] for f in PLANES + IVECS}
                                 | {f: cs[f] for f in JVECS}, ref_cut)
            c_err, c_bad = max(c_err, e), c_bad + b
        checked += 1
    checks = {
        "sessions_unchecked": (int(checked == 0) + unanswered, 0),
        "reference_overflow": (overflow, 0),
        "fire_mismatch": (fire_bad, lim["fire_mismatch"]),
        "int_mismatch": (bad, lim["int_mismatch"]),
        "wta_gap": (gap, lim["wta_gap"]),
        "state_err": (err, lim["state_err"]),
    }
    control_out = (None if control is None else
                   {"wta_gap": c_gap, "state_err": c_err, "int_mismatch": c_bad})
    layer_ctx = None
    if ctx.trace:
        rate = rp.out_rate * rp.dt_ms
        col_cells = lane_ticks * n * R if rate >= 1.0 else None
        layer_ctx = LayerCtx(trace, lane_ticks, col_cells)
    done = [reqs[s.rid] for s in sessions if s.rid in reqs]
    notes = {"sessions": len(sessions), "window_s": wall, "steps": steps,
             "backlog_at_last_arrival": served["backlog"],
             "converged": sum(r.status == "done" for r in done),
             "expired": sum(r.status == "expired" for r in done),
             "rejected": failed, "p50_ms": percentile(sojourn, 50),
             "p95_ms": percentile(sojourn, 95), "p99_ms": percentile(sojourn, 99),
             "lateness_max_ms": max(lateness, default=0.0) * 1e3,
             "lateness_mean_ms": (sum(lateness) / max(len(lateness), 1)) * 1e3,
             "sessions_checked": checked, "check_s": time.perf_counter() - t_check}
    return harness.Outcome(
        e2e={"recall_p90_ms": p90 if math.isfinite(p90) else 1e12,
             "peak_gib": peak / 2**30, "setup_s": setup_s},
        attempted=len(sessions), failed=failed + unanswered,
        memory_peak_bytes=peak, checks=checks, layer_ctx=layer_ctx,
        trace=trace, control=control_out, notes=notes)
