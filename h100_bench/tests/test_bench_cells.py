"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files by name."""
import json
import re

import pytest

from h100_bench import harness
from h100_bench.tests.conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "h100_bench/run.py"]
    assert SPEC["paths"] == ["h100_bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = {m["name"]: m for m in SPEC["end_to_end"]}["setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])


def test_metric_names_and_shares():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w, config, mix, limits, e2e, layer = harness.resolve(SPEC, cell, ROOT)
    assert config["name"] == w["config"]
    assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.reader(m["name"]))
        assert harness.reader(m["name"])(None) is None
    for k in ("fire_mismatch", "int_mismatch", "wta_gap", "state_err"):
        assert k in limits


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert cfg["file"].startswith("h100_bench/")
    for k in cfg["reduced"]:
        assert k in data and NAME.match(k)
    from repro_torch.core.params import BCPNNParams
    p = harness.program_params(BCPNNParams, data)
    assert (p.n_hcu, p.rows, p.cols) == (data["n_hcu"], data["rows"],
                                         data["cols"])
