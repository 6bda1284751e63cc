#!/usr/bin/env python3
"""Find the recall service's knee: one set-up of a recall cell, then the
open loop of its mix at each given rate in turn, on one card.

    python3 h100_bench/sweep_recall.py --workload human256.recall \\
        --seed 1 --seconds 20 --rates 8 10 12 14 16

For each rate it prints one JSON line: sessions offered, rejected, the
p50 / p90 / p95 sojourn (ms, from due), the backlog (sessions queued or in a lane)
when the last session was offered, the steps and the wall seconds. The
knee is the highest rate with no rejection and a backlog that stays within
the lanes; the cell's rate is about four fifths of it. Not a benchmark
run: it checks no output.
"""
import argparse
import json
import logging
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="human256.recall")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows at each rate, each with another seed")
    ap.add_argument("--dump", default=None,
                    help="also write each window's sojourns (ms) to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from h100_bench import generator, harness
    from h100_bench.drivers import recall as RC
    logging.getLogger("repro_torch").setLevel(logging.ERROR)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, config, mix, limits, _, _ = harness.resolve(bench, args.workload, ROOT)
    harness.check_cards(cell["chips"])
    ctx = harness.Ctx(args.workload, cell["chips"], config, mix, limits,
                      args.seed, args.seconds, False, False, "cuda",
                      time.perf_counter())
    n, R = int(config["n_hcu"]), int(config["rows"])
    patterns, sessions = generator.recall_traffic(mix, n, R, args.seed,
                                                  args.seconds)
    svc = RC.Service(ctx, patterns)
    svc.warm(sessions, int(mix["warmup_sessions"]))
    dumped = []
    for rate, rep in [(r, k) for r in args.rates for k in range(args.repeat)]:
        _, sessions = generator.recall_traffic(dict(mix, rate_per_s=rate), n,
                                               R, args.seed + rep, args.seconds)
        steps = svc.srv.steps
        out = svc.open_loop(sessions, args.seconds)
        ms, rejected, unanswered = RC.sojourns(sessions, out["reqs"])
        dumped.append({"rate_per_s": rate, "seed": args.seed + rep,
                       "sojourn_ms": ms})
        print(json.dumps({
            "rate_per_s": rate, "seed": args.seed + rep,
            "sessions": len(sessions),
            "rejected": rejected, "unanswered": unanswered,
            "p50_ms": RC.percentile(ms, 50), "p90_ms": RC.percentile(ms, 90),
            "p95_ms": RC.percentile(ms, 95),
            "backlog_at_last_arrival": out["backlog"],
            "lateness_max_ms": max(out["lateness"], default=0) * 1e3,
            "steps": svc.srv.steps - steps, "wall_s": out["wall"]}),
            flush=True)
    if args.dump:
        pathlib.Path(args.dump).write_text(json.dumps(dumped))
    return 0


if __name__ == "__main__":
    sys.exit(main())
