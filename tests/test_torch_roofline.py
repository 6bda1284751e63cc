"""The port's roofline arithmetic (`repro_torch.launch.roofline`) against
the JAX package's (`repro.launch.roofline`, in a child process through
`tests/torch_jax_ref.run_jax`), on the same inputs:

* `scan_factor` for all ten LM ids (and with whisper's encoder repeats);
* `model_flops` for every id and shape, train and serve;
* `outside_loop_costs` and `corrected_costs` for every id, train and
  serve kinds, on two meshes;
* `Roofline` with the JAX package's v5e constants substituted for the
  H100's (its properties, `row` and `HEADER`), on a spread of inputs.

The H100 constants themselves are the data sheet's, checked here by value.
"""
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.shapes import SHAPES
from torch_jax_ref import run_jax

KINDS = (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 32768))
CHIPS = ((256, 16), (512, 16))
# (hlo_flops, hlo_bytes, coll_bytes, model_flops, chips)
ROOFLINES = ((3.4e13, 2.2e12, 6.7e10, 3.2e15, 256),
             (1.2e9, 1.9e8, 7.1e5, 5.1e10, 512),
             (0.0, 1.0, 0.0, 0.0, 1),
             (6.5e13, 9.8e12, 1.9e12, 9.7e15, 256))

BODY = """
from repro.configs import ARCH_IDS, get_config
from repro.launch import roofline as RL
from repro.launch.shapes import SHAPES
KINDS = (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 32768))
for a in ARCH_IDS:
    cfg = get_config(a)
    OUT[f"scan/{a}"] = np.float64(RL.scan_factor(cfg))
    OUT[f"scan32/{a}"] = np.float64(RL.scan_factor(cfg, extra_repeats=32))
    for s, sh in SHAPES.items():
        for train in (True, False):
            OUT[f"mf/{a}/{s}/{train}"] = np.float64(RL.model_flops(
                cfg, s, sh["batch"] * sh["seq"], train))
    for kind, b, sq in KINDS:
        for chips, tp in ((256, 16), (512, 16)):
            OUT[f"out/{a}/{kind}/{chips}"] = np.asarray(
                RL.outside_loop_costs(cfg, kind, b, sq, chips, tp), np.float64)
            OUT[f"cor/{a}/{kind}/{chips}"] = np.asarray(RL.corrected_costs(
                cfg, kind, 3.1e13, 2.2e12, b, sq, chips, 28.0, tp), np.float64)
rows = []
for i, (f, by, c, m, chips) in enumerate(IN["roof"].tolist()):
    r = RL.Roofline("a" * (i + 3), "train_4k", "pod16x16", int(chips), f, by,
                    c, m)
    OUT[f"roof/{i}"] = np.asarray([r.t_compute, r.t_memory, r.t_collective,
                                   r.t_step, r.useful_fraction,
                                   r.mfu_at_roofline], np.float64)
    OUT[f"row/{i}"] = np.frombuffer(r.row().encode(), np.uint8)
    OUT[f"bneck/{i}"] = np.frombuffer(r.bottleneck.encode(), np.uint8)
OUT["header"] = np.frombuffer(RL.Roofline.HEADER.encode(), np.uint8)
OUT["consts"] = np.asarray([RL.PEAK_FLOPS, RL.HBM_BW, RL.ICI_BW, RL.ICI_LINKS])
"""


@pytest.fixture(scope="module")
def jax_out():
    return run_jax(BODY, {"roof": np.asarray(ROOFLINES, np.float64)},
                   timeout=300)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scan_factor_matches_jax(jax_out, arch):
    cfg = get_config(arch)
    assert RL.scan_factor(cfg) == jax_out[f"scan/{arch}"]
    assert RL.scan_factor(cfg, extra_repeats=32) == jax_out[f"scan32/{arch}"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_matches_jax(jax_out, arch):
    cfg = get_config(arch)
    for s, sh in SHAPES.items():
        for train in (True, False):
            assert RL.model_flops(cfg, s, sh["batch"] * sh["seq"], train) \
                == jax_out[f"mf/{arch}/{s}/{train}"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_outside_and_corrected_costs_match_jax(jax_out, arch):
    cfg = get_config(arch)
    for kind, b, sq in KINDS:
        for chips, tp in CHIPS:
            np.testing.assert_array_equal(
                RL.outside_loop_costs(cfg, kind, b, sq, chips, tp),
                jax_out[f"out/{arch}/{kind}/{chips}"])
            np.testing.assert_array_equal(
                RL.corrected_costs(cfg, kind, 3.1e13, 2.2e12, b, sq, chips,
                                   28.0, tp),
                jax_out[f"cor/{arch}/{kind}/{chips}"])


def test_roofline_with_jax_constants_matches_jax(jax_out, monkeypatch):
    peak, hbm, ici, links = jax_out["consts"].tolist()
    monkeypatch.setattr(RL, "PEAK_FLOPS", peak)
    monkeypatch.setattr(RL, "HBM_BW", hbm)
    monkeypatch.setattr(RL, "NVLINK_BW", ici * links)
    assert RL.Roofline.HEADER == jax_out["header"].tobytes().decode()
    for i, (f, by, c, m, chips) in enumerate(ROOFLINES):
        r = RL.Roofline("a" * (i + 3), "train_4k", "pod16x16", int(chips), f,
                        by, c, m)
        got = [r.t_compute, r.t_memory, r.t_collective, r.t_step,
               r.useful_fraction, r.mfu_at_roofline]
        np.testing.assert_array_equal(got, jax_out[f"roof/{i}"])
        assert r.row() == jax_out[f"row/{i}"].tobytes().decode()
        assert r.bottleneck == jax_out[f"bneck/{i}"].tobytes().decode()


def test_h100_constants_and_pricing():
    assert (RL.PEAK_FLOPS, RL.FP32_FLOPS, RL.HBM_BW) == (989e12, 67e12,
                                                         3.35e12)
    assert (RL.NVLINK_BW, RL.NIC_BW, RL.NODE_RANKS) == (450e9, 50e9, 8)
    r = RL.Roofline("bcpnn-rodent", "tick_1ms", "ranks1", 1, 67e9, 3.35e9,
                    450e9, 0.0, coll_nic_bytes=50e9, peak="float32")
    assert (r.t_compute, r.t_memory) == (1e-3, 1e-3)
    assert r.t_collective == 2.0 and r.bottleneck == "collective"
