"""Fixtures of the benchmark's CPU tests: a benchmark file of tiny cells
beside copies of the real cells' mixes and limits."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


TINY = dict(n_hcu=12, rows=64, cols=16, fanout=8, active_queue=8, max_delay=8,
            out_rate=0.3, simulator={"worklist": True})


def write_tiny(root: pathlib.Path, **mix_overrides) -> pathlib.Path:
    """A benchmark file whose cells are the real ones on a 12-HCU network
    (the worklist path forced, as at full size), with the real mixes cut
    to short chunks and the real limits. Returns the file's path."""
    data = root / "h100_bench"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((BENCH / "configs" / "bcpnn-human-256.json").read_text())
    cfg.update(TINY, name="tiny")
    cfg["serving"] = dict(cfg["serving"], cap_fire=TINY["n_hcu"], slots=2)
    (data / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tests",
                         "file": "h100_bench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    for w in bench["workloads"]:
        w["config"] = "tiny"
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        if "sample_hcus" in lim:
            lim["sample_hcus"] = 5
        (data / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    for name in {w["traffic"] for w in bench["workloads"]}:
        mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        if mix["driver"] == "sim":
            mix.update(chunk=16, warmup_chunks=1, trace_chunks=1)
        else:
            mix.update(rate_per_s=20.0, warmup_sessions=4, snapshots=3,
                       train_reps=2, trace_steps=1)
        mix.update(mix_overrides)
        (data / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_bench(tmp_path):
    return write_tiny(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
