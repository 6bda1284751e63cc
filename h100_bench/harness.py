"""Run one cell of the benchmark once and print its result line.

A cell is an entry of ``workloads`` in BENCHMARK.json. Everything it needs
is found by name:

  configs[<config>].file           the configuration (JSON)
  traffic/<traffic>.json           the traffic mix; its ``driver`` names
                                   the module under ``drivers/`` that runs
                                   it
  limits/<workload>.json           the limit of each number compared for
                                   ``correct``, and how much is sampled
  metrics/<metric>.py              one reader per per-layer metric

The run: set-up (timed as ``setup_s`` from the start of the process),
the measured window, then the comparison with the plain reference
(`reference`), which decides ``correct``. With ``--trace 1`` part of the
run is traced and the cell's per-layer metrics are reported instead of its
end-to-end ones. The last line on standard output is the result, a JSON
object; the numbers compared, each beside its limit, are the last lines on
standard error and the last key of the result.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files and the run's arguments."""
    workload: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: str
    t_start: float


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``e2e``: end-to-end metric values by name;
    ``layer_ctx``: what the per-layer readers read; ``checks``: name ->
    (value, limit); ``control``: the control's readings, name -> value."""
    e2e: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict
    layer_ctx: object = None
    trace: object = None
    control: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, base: pathlib.Path):
    """The cell's entry, configuration, mix, limits and metric lists."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(base / cfg_entry["file"])
    data = base / HERE.name         # the folder beside the benchmark file
    mix = load_json(data / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(data / "limits" / f"{workload}.json")

    def mine(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) in (True, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) or (mine(m) is None and m["moves"] in names)]
    return cell, config, mix, limits, e2e, layer


def program_params(cls, cfg: dict, overrides: dict | None = None):
    """The program's parameter dataclass ``cls`` from the configuration's
    top-level numbers of its fields, with ``overrides``."""
    vals = {f.name: cfg[f.name] for f in dataclasses.fields(cls)
            if f.name in cfg}
    return cls(**{**vals, **(overrides or {})})


def reader(name: str):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {chips}")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(chips: int, memory_peak: int, device: str) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": memory_peak}


def judge(checks: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(not math.isnan(v) and v <= lim for v, lim in checks.values())


def verdict(out: Outcome) -> tuple[bool, dict]:
    """(correct, the numbers compared with their limits). In a control run
    the control stands in the program's place: its readings replace the
    program's where it has them, under the same limits, and the others
    (the check's own capacity and coverage, the fire draws, which the
    control is teacher-forced on) stay."""
    checks = dict(out.checks)
    if out.control is not None:
        for k, v in out.control.items():
            checks[k] = (v, out.checks[k][1])
    return judge(checks), checks


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the lower-precision control in the "
                         "program's place (not a benchmark run)")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu runs the tests' tiny cells without a card")
    ap.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"),
                    help="the benchmark file (the tests point at their own)")
    args = ap.parse_args(argv)
    bench_path = pathlib.Path(args.bench)
    bench = load_json(bench_path)
    cell, config, mix, limits, e2e, layer = resolve(bench, args.workload,
                                                    bench_path.parent)
    if args.device != "cpu":
        try:
            check_cards(cell["chips"])
        except NoDevice as e:
            print(f"h100_bench: {e}; no result", file=sys.stderr)
            return 3
    ctx = Ctx(args.workload, cell["chips"], config, mix, limits, args.seed,
              args.seconds, bool(args.trace), bool(args.control), args.device,
              t_start)
    driver = importlib.import_module(f"h100_bench.drivers.{mix['driver']}")
    out = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    correct, checks = verdict(out)
    if args.trace:
        metrics = {}
        for m in layer:
            v = reader(m["name"])(out.layer_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in out.e2e}
    device = device_info(cell["chips"], out.memory_peak_bytes, args.device)
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    for k, v in out.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    if out.control is not None:
        for k, (v, lim) in out.checks.items():
            print(f"program {k} {v!r} limit {lim!r}", file=sys.stderr)
        print("the control stands in the program's place below",
              file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0
