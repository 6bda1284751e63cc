"""Capture the JAX package's dry-run records into
tests/fixtures/dryrun_cells.json.

Run from the repo root:

    PYTHONPATH=src:tests python tests/fixtures/capture_dryrun.py

Each cell of CELLS is lowered and compiled by `repro.launch.dryrun`
(`lower_cell`, or `lower_bcpnn` for the "bcpnn-*" ids) on 512 forced host
devices, in a child process of its own (`tests/torch_jax_ref.run_jax`,
which applies the import shim). The file holds, per cell, the record's
keys the port's dry run is held to (`tests/test_torch_dryrun.py`):
``memory`` (XLA's memory analysis), ``cost``, ``collectives``,
``model_flops``, ``scan_factor``, ``chips`` and, for BCPNN, ``n_hcu``,
``h_local`` and ``lazy_bytes_per_tick``.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from torch_jax_ref import run_jax  # noqa: E402

OUT = HERE / "dryrun_cells.json"
# (arch, shape, multi_pod): the JAX test's own cell, a train cell, a
# prefill and a decode cell of an attention model, and the rodent tick
CELLS = (("xlstm-125m", "decode_32k", True),
         ("qwen2-1.5b", "train_4k", False),
         ("qwen2-1.5b", "prefill_32k", False),
         ("qwen2-1.5b", "decode_32k", False),
         ("bcpnn-rodent", "tick_1ms", False))

BODY = """
import json
from repro.launch import dryrun as D
arch, shape, mp = str(IN["arch"]), str(IN["shape"]), bool(IN["mp"])
if arch.startswith("bcpnn-"):
    _, _, rec = D.lower_bcpnn(arch.split("-")[1], multi_pod=mp)
else:
    _, _, rec = D.lower_cell(arch, shape, multi_pod=mp)
OUT["rec"] = np.frombuffer(json.dumps(rec).encode(), np.uint8)
"""


def capture(arch, shape, mp):
    import numpy as np
    out = run_jax(BODY, {"arch": np.asarray(arch), "shape": np.asarray(shape),
                         "mp": np.asarray(mp)}, timeout=900, n_devices=512)
    return json.loads(out["rec"].tobytes().decode())


def main():
    recs = {}
    for arch, shape, mp in CELLS:
        t0 = time.time()
        rec = capture(arch, shape, mp)
        rec.pop("collectives_raw", None)
        recs[f"{arch}__{shape}__{rec['mesh']}"] = rec
        print(f"{arch} {shape} {rec['mesh']}: {time.time() - t0:.1f} s",
              flush=True)
    OUT.write_text(json.dumps(recs, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
