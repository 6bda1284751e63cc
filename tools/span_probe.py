#!/usr/bin/env python3
"""The span recorder (`repro_torch.core.spans`) on the benchmark's cells:
the phases of a replayed tick, the device time between replays, the recall
step's host time, and what recording costs, with recorder-on windows
beside recorder-off ones in turns in one process.

    python3 tools/span_probe.py [--cells rodent.drive4 human256.drive4
        human256.recall] [--pairs 5] [--seed N] [--recall-seconds 20]
        [--out build/span_probe.json]

Run from the repository root on a machine with one CUDA card. Each cell
is set up as `h100_bench/run.py` sets it up (its configuration, traffic
and seed; `h100_bench.drivers`), then:

* a drive cell: two chunks capture the unrecorded graph and one recorded
  chunk the recorded graph; then ``--pairs`` pairs of windows of
  ``window_chunks`` chunks (off, on; the next pair on, off), each timed
  as the driver times its window (host clock to a synchronize, at most
  two chunks in flight). For each recorded window the recorder's summary
  (device us a tick of each phase, between ticks, between replays) beside
  the window's us a tick; each recorded chunk's own phases, to show which
  phase grows in a slow chunk; the unrecorded graph's node count before
  and after the recorded capture, and the recorded graph's;
* the recall cell: the warm-up sessions capture the lanes' unrecorded
  graphs and one recorded warm-up their recorded ones; then ``--pairs``
  open-loop windows of ``--recall-seconds`` each way, in turns, each with
  its p90 sojourn; for a recorded window the summary's step host time and
  lane device time, and the median of each ``serve.*`` child span.

Prints a line a window and writes every number to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import logging
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from h100_bench import generator, graphs, harness  # noqa: E402
from h100_bench.reference import threefry as TF  # noqa: E402
from repro_torch.core import spans  # noqa: E402

WINDOW_CHUNKS = {"rodent.drive4": 6, "human256.drive4": 12}


def cell_files(name):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, mix, limits, _, _ = harness.resolve(bench, name, ROOT)
    return cfg, mix, limits


def drive(name, pairs, seed):
    from repro_torch.core import Simulator
    from repro_torch.core.params import BCPNNParams
    cfg, mix, _ = cell_files(name)
    dev = torch.device("cuda")
    params = harness.program_params(BCPNNParams, cfg)
    chunk, width = int(mix["chunk"]), int(mix["width"])
    t0 = time.perf_counter()
    sim = Simulator(params, key=TF.key_from_seed(seed).to(dev), device=dev,
                    **cfg.get("simulator", {}))
    stream = generator.DriveStream(mix, params.n_hcu, params.rows, seed, dev)

    def one_chunk():
        f = sim.run(stream.next(chunk)).to(torch.int8)
        host = torch.empty(f.shape, dtype=torch.int8, pin_memory=True)
        host.copy_(f, non_blocking=True)

    def window(k):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        evs = []
        for _ in range(k):
            one_chunk()
            evs.append(torch.cuda.Event())
            evs[-1].record()
            if len(evs) > 1:
                evs[-2].synchronize()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) / (k * chunk) * 1e6

    for _ in range(2):
        one_chunk()
    torch.cuda.synchronize(dev)
    nodes_before = graphs.graph_nodes(sim.graphs.captured[chunk])
    with spans.record():
        one_chunk()
    torch.cuda.synchronize(dev)
    recorded = sim.graphs._chunks[(chunk, width, True)].graph
    out = {"setup_s": time.perf_counter() - t0, "ticks_per_chunk": chunk,
           "nodes_unrecorded_before": nodes_before,
           "nodes_unrecorded_after": graphs.graph_nodes(
               sim.graphs.captured[chunk]),
           "nodes_recorded": graphs.graph_nodes(recorded),
           "windows": [], "chunks": []}
    k = WINDOW_CHUNKS[name]
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if not on:
                us = window(k)
                out["windows"].append({"on": False, "tick_us": us})
                print(f"{name} window {len(out['windows'])} off: {us:.1f} "
                      "us/tick", flush=True)
                continue
            with spans.record() as rec:
                us = window(k)
            s = rec.summary()
            w = {"on": True, "tick_us": us, **{k_: s[k_] for k_ in (
                "phase_us", "between_us", "replay_gap_us", "marked_tick_us",
                "clock_err_ns", "drift_ns")}}
            w["sum_us"] = (sum(s["phase_us"].values()) + s["replay_gap_us"])
            out["windows"].append(w)
            for _, m in rec.marks():
                ph = (m[:, 1:] - m[:, :-1]).mean(0) * 1e-3
                out["chunks"].append({
                    "window": len(out["windows"]),
                    "tick_us": float((m[-1, -1] - m[0, 0]) / m.shape[0]
                                     * 1e-3),
                    "phase_us": dict(zip(spans.PHASES, ph.tolist()))})
            print(f"{name} window {len(out['windows'])} on: {us:.1f} us/tick;"
                  f" marked {s['marked_tick_us']:.1f}; phases "
                  + ", ".join(f"{p} {v:.1f}" for p, v in s["phase_us"].items())
                  + f"; between ticks {s['between_us']:.2f}, between replays "
                  f"{s['replay_gap_us']:.2f}; phases + gap {w['sum_us']:.1f} "
                  f"({w['sum_us'] / us - 1:+.2%} of the window's us/tick); "
                  f"clock err {s['clock_err_ns']} ns, drift "
                  f"{s['drift_ns']} ns",
                  flush=True)
    off = [w["tick_us"] for w in out["windows"] if not w["on"]]
    on = [w["tick_us"] for w in out["windows"] if w["on"]]
    out["cost"] = statistics.median(on) / statistics.median(off) - 1
    print(f"{name}: recorder off {statistics.median(off):.1f} us/tick "
          f"({min(off):.1f}-{max(off):.1f}), on {statistics.median(on):.1f} "
          f"({min(on):.1f}-{max(on):.1f}): cost {out['cost']:+.3%}; nodes "
          f"{nodes_before} -> {out['nodes_unrecorded_after']} unrecorded, "
          f"{out['nodes_recorded']} recorded", flush=True)
    del sim
    torch.cuda.empty_cache()
    return out


def recall(name, pairs, seed, seconds):
    from h100_bench.drivers import recall as RD
    logging.getLogger("repro_torch").setLevel(logging.ERROR)
    cfg, mix, limits = cell_files(name)
    t0 = time.perf_counter()
    ctx = harness.Ctx(name, 1, cfg, mix, limits, seed, seconds, False, False,
                      "cuda", t0)
    patterns, sessions = generator.recall_traffic(
        mix, int(cfg["n_hcu"]), int(cfg["rows"]), seed, seconds)
    svc = RD.Service(ctx, patterns)
    svc.warm(sessions, int(mix["warmup_sessions"]))
    with spans.record():
        svc.warm(sessions, svc.srv.slots)
    out = {"setup_s": time.perf_counter() - t0, "windows": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with spans.record() as rec:
                    served = svc.open_loop(sessions, seconds)
            else:
                served = svc.open_loop(sessions, seconds)
            ms, rejected, unanswered = RD.sojourns(sessions, served["reqs"])
            w = {"on": on, "p90_ms": RD.percentile(ms, 90),
                 "p50_ms": RD.percentile(ms, 50), "rejected": rejected,
                 "unanswered": unanswered}
            line = (f"{name} window {len(out['windows']) + 1} "
                    f"{'on' if on else 'off'}: p90 {w['p90_ms']:.1f} ms, "
                    f"p50 {w['p50_ms']:.1f}")
            if on:
                s = rec.summary()
                kids = {}
                for sp in rec.spans:
                    if sp.parent is not None and \
                            rec.spans[sp.parent].name == "serve.step":
                        kids.setdefault(sp.name, []).append(sp.ms)
                w.update(step_host_ms=s["step_host_ms"],
                         lane_device_ms=s["lane_device_ms"],
                         steps=len(s["steps"]),
                         step_wall_ms=statistics.median(
                             x["wall_ms"] for x in s["steps"]),
                         step_lanes_ms=statistics.median(
                             x["lanes_ms"] for x in s["steps"]),
                         child_ms={k: statistics.median(v)
                                   for k, v in kids.items()},
                         phase_us=s["phase_us"],
                         replay_gap_us=s["replay_gap_us"])
                line += (f"; {w['steps']} steps: wall {w['step_wall_ms']:.1f}"
                         f" ms, lanes marked {w['step_lanes_ms']:.1f}, host "
                         f"{w['step_host_ms']:.2f}; lane-tick "
                         f"{w['lane_device_ms']:.4f} ms; children "
                         + ", ".join(f"{k} {v:.2f}"
                                     for k, v in w["child_ms"].items())
                         + "; phases " + ", ".join(
                             f"{p} {v:.1f}" for p, v in s["phase_us"].items()))
            out["windows"].append(w)
            print(line, flush=True)
    off = [w["p90_ms"] for w in out["windows"] if not w["on"]]
    on = [w["p90_ms"] for w in out["windows"] if w["on"]]
    out["cost"] = statistics.median(on) / statistics.median(off) - 1
    print(f"{name}: p90 off {statistics.median(off):.1f} ms, on "
          f"{statistics.median(on):.1f}: cost {out['cost']:+.3%}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=[
        "human256.drive4", "rodent.drive4", "human256.recall"])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=3_141_592_653)
    ap.add_argument("--recall-seconds", type=float, default=20.0)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "span_probe.json"))
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    from repro_torch.kernels import _build
    _build.build_all()
    result = {"card": smi, "seed": args.seed}
    for name in args.cells:
        if name.endswith(".recall"):
            result[name] = recall(name, args.pairs, args.seed,
                                  args.recall_seconds)
        else:
            result[name] = drive(name, args.pairs, args.seed)
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
