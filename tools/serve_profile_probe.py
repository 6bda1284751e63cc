#!/usr/bin/env python3
"""Repeat the profiled recall-server step of `chip_smoke.py` phase 8d and
count what its device trace misses, against what the program did.

    python3 tools/serve_profile_probe.py [--steps 30]

Run from the repository root on a machine with one CUDA card. It builds
phase 8d's server once (`chip_smoke.serve_params()`: human_scale(256) with
the serving benchmark's dynamics, trained by `train_assoc`;
`BCPNNRecallServer` with SERVE_SLOTS lanes of SERVE_STEP ticks), keeps
every lane busy with fresh sessions (0.6 partial cues of the trained
patterns, budget 48 ticks), runs one unprofiled step that captures the
lanes' graphs, then profiles each of ``--steps`` engine steps as
`chip_smoke.profile_serve_step` does (torch.profiler, device activity
only). For each step it reads, from the program and not from the trace:

* every lane's tick counter ``t`` on the device, which must equal the
  template's plus the ticks its session has run (each step advances every
  lane exactly SERVE_STEP ticks);
* one lane (step mod SERVE_SLOTS), bit for bit against its session's solo
  run (`Simulator.run(chunk=SERVE_STEP)` from the template): the fired
  history so far and every leaf, as phase 8d checks two sessions;

and from the trace, the executions of the fused row and column kernels
against SERVE_SLOTS x SERVE_STEP lane-ticks. Before the first profiled
step it counts each lane graph's kernel nodes by name
(`chip_smoke.graph_kernels`). Prints a line a step and a summary JSON
line; exits 1 if a lane skipped a tick or left its solo run (a fault of
the program), 0 otherwise, whatever the trace counted.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Simulator, network as N
    from repro_torch.experiments import train_assoc
    from repro_torch.kernels import _build
    from repro_torch.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest
    if not torch.cuda.is_available():
        print("serve_profile_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    S, T = cs.SERVE_SLOTS, cs.SERVE_STEP
    p = cs.serve_params()
    t0 = time.perf_counter()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu)
    patterns = np.random.default_rng(3).integers(0, p.rows, (3, p.n_hcu))
    train_assoc(sim, patterns, reps=cs.ASSOC_REPS)
    srv = BCPNNRecallServer(sim, slots=S, queue_capacity=cs.SERVE_QUEUE,
                            step_ticks=T)
    template = srv.template
    t_template = int(template.t)
    print(f"probe: server of {S} lanes x {T} ticks built in "
          f"{time.perf_counter() - t0:.1f} s (the trained Simulator is "
          f"reused for the solo runs)")
    rng = np.random.default_rng(2)
    rid = [10_000]

    def top_up():   # enough queued sessions to fill every lane that frees
        while len(srv.queue) < S:
            srv.submit(RecallRequest(rid[0], patterns[rid[0] % 3],
                                     rng.random(p.n_hcu) < cs.SERVE_CUE,
                                     budget_ticks=cs.SERVE_BUDGET))
            rid[0] += 1

    top_up()
    srv.step()                       # captures every lane's graph
    torch.cuda.synchronize()
    captures = srv.captures
    nodes = [sum((cs.graph_kernels(g) for g in lane.captured.values()),
                 start=collections.Counter())
             for lane in srv.graphs]
    per_lane = [{k: sum(c for nm, c in cnt.items() if tag in nm)
                 for k, tag in cs.KERNEL_TAGS.items()} for cnt in nodes]
    graph_ok = all(d["fused_row_update"] == T and d["fused_col_update"] == T
                   and not any(d[k] for k in cs.BCPNN_KERNELS[2:])
                   for d in per_lane)
    print(f"probe: kernel nodes of each lane's graph {json.dumps(per_lane[0])}"
          f" (all lanes alike: {all(d == per_lane[0] for d in per_lane)}; "
          f"{T} of each fused kernel and no other BCPNN kernel: {graph_ok})")

    n = S * T
    misses, tick_faults, solo_faults, solo_checked = [], [], [], 0
    for k in range(args.steps):
        top_up()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            done_now = srv.step()
            torch.cuda.synchronize()
        if srv.captures != captures:
            print(f"probe: step {k} captured", file=sys.stderr)
            return 1
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        ran = {key: sum(tag in nm for nm in names)
               for key, tag in cs.KERNEL_TAGS.items()}
        lanes = {lane: r for lane, r in enumerate(srv.active) if r is not None}
        lanes.update({r.lane: r for r in done_now})
        t_dev = srv.stacked.t.cpu().numpy()
        want_t = np.array([t_template + lanes[lane].ticks for lane in range(S)])
        if len(lanes) != S or not np.array_equal(t_dev, want_t):
            tick_faults.append(k)
        lane = k % S
        req = lanes[lane]
        fired = req.fired if any(r is req for r in done_now) else np.concatenate(
            srv._traj[lane], axis=0)
        N.copy_into(sim.state, template)
        frame = np.full((p.n_hcu, 4), p.rows, np.int32)
        mask = np.asarray(req.cue_mask, bool)
        frame[mask, 0] = np.asarray(req.cue_rows, np.int32)[mask]
        ext = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frame, (req.ticks,) + frame.shape))).cuda()
        f = sim.run(ext, chunk=T).cpu().numpy()
        solo_checked += 1
        same = np.array_equal(f, fired) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                cs.leaves(sim.state), cs.leaves(N.take_session(srv.stacked,
                                                               lane)),
                strict=True))
        if not same:
            solo_faults.append(k)
        miss = {key: n - ran[key] for key in ("fused_row_update",
                                              "fused_col_update")}
        if any(miss.values()) or any(ran[key] for key in cs.BCPNN_KERNELS[2:]):
            misses.append({"step": k, **ran})
        print(f"probe step {k}: trace ran {json.dumps(ran)} in {n} lane-ticks;"
              f" lanes' t {t_dev.tolist()} (expected {want_t.tolist()}); lane"
              f" {lane} (session {req.rid}, {req.ticks} ticks) equals its solo"
              f" run: {same}")
    summary = {"card": smi, "profiled_steps": args.steps,
               "lane_ticks_per_step": n, "graph_kernel_nodes": per_lane[0],
               "graphs_hold_every_kernel": graph_ok,
               "steps_trace_short": len(misses), "trace_short": misses,
               "steps_lane_t_wrong": tick_faults,
               "solo_checks": solo_checked, "solo_mismatches": solo_faults}
    print("probe summary:", json.dumps(summary))
    return 1 if tick_faults or solo_faults or not graph_ok else 0


if __name__ == "__main__":
    sys.exit(main())
