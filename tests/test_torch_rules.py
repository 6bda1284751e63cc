"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
it runs on CUDA unless the caller asks for the CPU, and every part that is
not ported yet raises instead of running something else."""
import ast
import pathlib

import pytest
import torch

from repro_torch.core import Simulator, select_backend
from repro_torch.core.params import test_scale as tiny_scale

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_simulator_defaults_to_cuda():
    p = tiny_scale(4, 64, 16)
    if torch.cuda.is_available():
        assert Simulator(p).state.hcus.zij.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Simulator(p)


@pytest.mark.parametrize("kw", [dict(eager=True), dict(merged=True),
                                dict(layout="blocked"), dict(worklist=False),
                                dict(fused=False), dict(fused_cols=False)],
                         ids=lambda kw: next(iter(kw)))
def test_unported_backends_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_backend(tiny_scale(), **kw)


@pytest.mark.parametrize("method", ["run_sharded", "save", "load"])
def test_unported_simulator_methods_raise(method):
    sim = Simulator(tiny_scale(4, 64, 16), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(sim, method)("ckpt")
