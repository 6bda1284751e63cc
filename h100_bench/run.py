#!/usr/bin/env python3
"""The port's benchmark: run one cell once.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout with one CUDA card (see `harness`). The cells
are the ``workloads`` of BENCHMARK.json. The last line on standard output
is the result; without the cards a cell asks for, or without the program
(``src/repro_torch``), it exits non-zero and prints no result.
"""
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("h100_bench: the program src/repro_torch is not in this "
              "checkout; no result", file=sys.stderr)
        sys.exit(2)
    # every cache the run writes stays in the checkout, at fixed paths
    cache = ROOT / "build" / "h100_bench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from h100_bench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
