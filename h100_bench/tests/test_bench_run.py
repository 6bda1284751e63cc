"""`h100_bench/run.py` as the benchmark's command runs it: a tiny cell on
the CPU prints the contract's result line; without a card, or in a
directory that holds only the benchmark, it prints no result and fails."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench.tests.conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(args, cwd=ROOT, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "h100_bench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("cell,trace", [("human256.drive4", "0"),
                                        ("human256.recall", "1")])
def test_tiny_cell_prints_the_result_line(tiny_bench, cell, trace):
    p = run(["--workload", cell, "--seed", str(2**31 + 99), "--seconds", "1",
             "--trace", trace, "--device", "cpu", "--bench", str(tiny_bench)])
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS[:5] and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace == "1":
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "peak_gib"} <= set(res["metrics"])
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    checks = [line for line in p.stderr.splitlines() if line.startswith("check ")]
    assert len(checks) == len(res["checks"]) and \
        p.stderr.strip().splitlines()[-len(checks):] == checks


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = run(["--workload", "human256.drive4", "--seed", "1", "--seconds", "1",
             "--trace", "0"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(["--workload", "human256.drive4", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
