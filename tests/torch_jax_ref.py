"""Run the JAX reference package in a child process for the PyTorch port's
tests (tests/test_torch_*.py).

The JAX package runs only in a child, never in the pytest worker: the two
settings it needs would otherwise leak into the JAX tests that share the
worker.

  * ``jax_threefry_partitionable=False`` — the legacy threefry mode the
    head fixtures were captured in, and the mode the port's
    `repro_torch.core.rng` reproduces;
  * a shim around the `repro.core` import: on jax 0.9,
    `jax.interpreters.batching.primitive_batchers` is a write-only proxy,
    and `repro/core/hcu.py` applies ``in`` to it at import. During the
    import the shim answers ``in`` from
    `jax._src.interpreters.batching.fancy_primitive_batchers` and forwards
    writes to the proxy; the original object is restored afterwards.

`run_jax(body, inputs)` saves ``inputs`` (numpy arrays) to an npz file,
runs ``body`` in a child with ``IN`` bound to them, and returns the dict
``OUT`` that the body fills with numpy arrays.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PRELUDE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_threefry_partitionable", False)
from jax.interpreters import batching as _batching
from jax._src.interpreters import batching as _batching_src


class _BatchersShim:
    def __init__(self, proxy):
        self._proxy = proxy

    def __contains__(self, prim):
        return prim in _batching_src.fancy_primitive_batchers

    def __setitem__(self, prim, rule):
        self._proxy[prim] = rule


_orig = _batching.primitive_batchers
_batching.primitive_batchers = _BatchersShim(_orig)
try:
    import repro.core  # noqa: F401
finally:
    _batching.primitive_batchers = _orig

IN = dict(np.load(sys.argv[1]))
OUT = {}
"""

_EPILOGUE = """
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in OUT.items()})
"""


def run_jax(body: str, inputs: dict | None = None, timeout: float = 120.0,
            n_devices: int = 1) -> dict:
    """Run ``body`` against the JAX package in a child; return its OUT.
    ``n_devices`` > 1 forces that many host devices in the child (the JAX
    package's sharded runtime needs a mesh of them)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **(inputs or {}))
        script = _PRELUDE + textwrap.dedent(body) + _EPILOGUE
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "JAX_PLATFORMS": "cpu"}
        if n_devices > 1:
            env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                                f"{n_devices}")
        r = subprocess.run([sys.executable, "-c", script, src, dst], env=env,
                           capture_output=True, text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(f"JAX reference child failed:\n{r.stderr[-4000:]}")
        return dict(np.load(dst))
