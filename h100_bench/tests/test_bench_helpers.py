"""The yardstick's frozen counts against the port's own at small shapes:
the fused phases' bytes (`chip_smoke.py`), the tick's touched cells, bytes
and operations (`repro_torch.launch.dryrun`), the graph-node counter."""
import importlib.util

import pytest

from h100_bench import graphs, roofline as RL
from h100_bench.tests.conftest import ROOT


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nv,W,n,C", [(0, 40, 4, 16), (10, 40, 4, 16),
                                      (3584, 11264, 256, 100),
                                      (448000, 1408000, 32000, 70)])
def test_row_phase_bytes(nv, W, n, C):
    assert RL.row_phase_bytes(nv, W, n, C) == smoke().row_phase_bytes(
        nv, W, n, C, C * 4)


@pytest.mark.parametrize("nf,K,R", [(0, 5, 64), (3, 5, 64), (26, 90, 10000),
                                    (3200, 11201, 1200)])
def test_col_phase_bytes(nf, K, R):
    assert RL.col_phase_bytes(nf, K, R) == smoke().col_phase_bytes(
        nf, K, R, R * 4)


def test_ops_per_cell_and_peaks():
    cs = smoke()
    assert RL.OPS_PER_CELL == cs.OPS_PER_CELL
    assert RL.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert RL.F32_FLOPS == cs.FP32_OPS_PER_S


@pytest.mark.parametrize("scale,n", [("rodent", 64), ("human", 8)])
def test_tick_counts_match_the_dry_run(scale, n):
    from repro_torch.launch.dryrun import lower_bcpnn
    rec = lower_bcpnn(scale, multi_pod=False, n_hcu=n, ranks=1)
    import importlib
    p = importlib.import_module(f"repro_torch.configs.bcpnn_{scale}").CONFIG
    # the dry run counts the dimensioned rates: in_rate rows and out_rate
    # fired minicolumns an HCU a tick
    cells = RL.tick_cells(p.in_rate * n, p.cols, p.out_rate * n, p.rows)
    assert cells * RL.TICK_BYTES_PER_CELL == pytest.approx(
        rec["lazy_bytes_per_tick"], rel=1e-12)
    assert cells * RL.TICK_FLOPS_PER_CELL == pytest.approx(
        rec["model_flops"], rel=1e-12)


def test_bound_takes_the_larger_term():
    assert RL.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert RL.bound_s(0, 67e12) == pytest.approx(1.0)
    assert RL.tick_bound_s(1000) == pytest.approx(40_000 / 3.35e12)


@pytest.mark.cuda
def test_graph_nodes_match_the_port(cuda_device):
    import torch
    from repro_torch.core import Simulator
    from repro_torch.core.params import test_scale
    sim = Simulator(test_scale(), key=0, device=cuda_device, worklist=True)
    ext = torch.full((8, 4, 2), 64, dtype=torch.int32, device=cuda_device)
    sim.run(ext, chunk=8)
    g = sim.graphs.captured[8]
    assert graphs.graph_nodes(g) == smoke().graph_nodes(g) > 8
