"""The comparison that decides ``correct`` fails what it must: a run of
the benchmark's command with the control (the reference with bfloat16
planes) in the program's place prints ``correct`` false in each cell, and
a run of the real harness whose timed path is broken underneath comes out
not correct, for each fault a cell can have:
a step that leaves its state unchanged, half of the HCUs left out of the
row phase, the fan-out (the exchange of spikes between HCUs) left out,
and a fired minicolumn altered where the WTA produces it. Tiny cells on
the CPU; the limits are the committed ones."""
import importlib
import json

import pytest
import torch

from h100_bench import harness
from h100_bench.tests.test_bench_run import run as run_command

CELLS = ["human256.drive4", "human256.recall"]


def outcome(bench, cell, seed=2**31 + 17):
    spec = json.loads(bench.read_text())
    w, config, mix, limits, _, _ = harness.resolve(spec, cell, bench.parent)
    ctx = harness.Ctx(cell, 1, config, mix, limits, seed, 0.5, False, False,
                      "cpu", 0.0)
    torch.exp(torch.ones(4))
    return importlib.import_module(f"h100_bench.drivers.{mix['driver']}").run(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    out = outcome(tiny_bench, cell)
    assert harness.verdict(out)[0], out.checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_bench, cell):
    p = run_command(["--workload", cell, "--seed", str(2**31 + 17),
                     "--seconds", "0.5", "--trace", "0", "--control", "1",
                     "--device", "cpu", "--bench", str(tiny_bench)])
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
    failed = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    assert failed and set(failed) <= {"wta_gap", "state_err", "int_mismatch"}


def stuck(monkeypatch):
    from repro_torch.core import network as N
    run = N.network_run

    def network_run(state, *a, **k):
        keep = N.tree_map(torch.clone, state)
        _, fired = run(state, *a, **k)
        return keep, fired
    monkeypatch.setattr(N, "network_run", network_run)


def half_rows(monkeypatch):
    from repro_torch.core import engine as E
    rows_phase = E.worklist_lazy_rows

    def worklist_lazy_rows(hcus, rows, t, p, **k):
        rows = rows.clone()
        rows[rows.shape[0] // 2:] = p.rows
        return rows_phase(hcus, rows, t, p, **k)
    monkeypatch.setattr(E, "worklist_lazy_rows", worklist_lazy_rows)


def no_fanout(monkeypatch):
    from repro_torch.core import network as N
    monkeypatch.setattr(N, "enqueue_spikes", lambda state, *a, **k: state)


def altered_winner(monkeypatch):
    from repro_torch.core import hcu as H
    wta = H.periodic_update

    def periodic_update(st, w_rows, counts, key, p):
        st, fired = wta(st, w_rows, counts, key, p)
        return st, torch.where(fired >= 0, (fired + 1) % p.cols, fired)
    monkeypatch.setattr(H, "periodic_update", periodic_update)


FAULTS = {"state_unchanged": stuck, "half_the_hcus": half_rows,
          "no_fanout": no_fanout, "winner_altered": altered_winner}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = outcome(tiny_bench, cell)
    assert not harness.verdict(out)[0], out.checks
