"""The port's BCPNN presets and registry (`repro_torch.configs`:
bcpnn_human, bcpnn_rodent, `BCPNN_IDS`, `get_config`, `get_smoke_config`)
against the JAX package's (`repro.configs`, in a child process through
`tests/torch_jax_ref.run_jax`): CONFIG, SMOKE and DRYRUN_N_HCU field for
field, the id lists, and the derived storage numbers."""
import dataclasses

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.core.params import BCPNNParams
from torch_jax_ref import run_jax

BODY = """
import dataclasses, importlib
from repro import configs
OUT["bcpnn_ids"] = np.asarray(configs.BCPNN_IDS)
OUT["arch_ids"] = np.asarray(configs.ARCH_IDS)
for bid in configs.BCPNN_IDS:
    mod = importlib.import_module(f"repro.configs.{configs._MODULES[bid]}")
    OUT[f"{bid}/dryrun"] = np.asarray(mod.DRYRUN_N_HCU)
    for which, p in (("config", configs.get_config(bid)),
                     ("smoke", configs.get_smoke_config(bid))):
        for f, v in dataclasses.asdict(p).items():
            OUT[f"{bid}/{which}/{f}"] = np.asarray(v)
        OUT[f"{bid}/{which}/storage"] = np.asarray(
            [p.cell_bytes, p.hcu_storage_bytes, p.network_storage_bytes],
            np.int64)
"""


@pytest.fixture(scope="module")
def jax_out():
    return run_jax(BODY, timeout=120)


def test_id_lists_match_jax(jax_out):
    assert configs.BCPNN_IDS == jax_out["bcpnn_ids"].tolist()
    assert configs.ARCH_IDS == jax_out["arch_ids"].tolist()


@pytest.mark.parametrize("which", ("config", "smoke"))
@pytest.mark.parametrize("bid", ["bcpnn-human", "bcpnn-rodent"])
def test_preset_matches_jax(jax_out, bid, which):
    p = (configs.get_config if which == "config"
         else configs.get_smoke_config)(bid)
    assert isinstance(p, BCPNNParams)
    for f, v in dataclasses.asdict(p).items():
        assert v == jax_out[f"{bid}/{which}/{f}"], f
    np.testing.assert_array_equal(
        [p.cell_bytes, p.hcu_storage_bytes, p.network_storage_bytes],
        jax_out[f"{bid}/{which}/storage"])


@pytest.mark.parametrize("bid", ["bcpnn-human", "bcpnn-rodent"])
def test_dryrun_size_matches_jax(jax_out, bid):
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{configs._MODULES[bid]}")
    assert mod.DRYRUN_N_HCU == int(jax_out[f"{bid}/dryrun"])


def test_rodent_fits_one_card():
    """The docstrings' numbers: 20 bytes a cell in the port, 1.68 MB an HCU
    at rodent width, 20 MB at human width, 53.76 GB of rodent planes."""
    rodent = configs.get_config("bcpnn-rodent")
    human = configs.get_config("bcpnn-human")
    assert rodent.n_hcu == 32_000
    assert rodent.rows * rodent.cols * 20 == 1_680_000
    assert human.rows * human.cols * 20 == 20_000_000
    assert rodent.n_hcu * rodent.rows * rodent.cols * 20 == 53_760_000_000
