#!/usr/bin/env python3
"""Time the kernels of several trees in turns on one card: phases 3 and 6
of each tree's `chip_smoke.py`.

    python3 tools/kernel_ab.py TREE [TREE ...]

Run on a machine with one CUDA card. Each TREE is the root of a checkout
of this repository (for a parent-against-change comparison, unpack the
parent with `git archive` into a git-ignored directory and name it beside
``.``, as ``parent . . parent``). For each TREE in the order given, one
child process imports that tree's `chip_smoke.py` and `repro_torch`,
builds its kernels into its own `build/`, and runs its phase 3
(`phase_kernels` at `human_scale(n_hcu=256)`: the BCPNN kernels against
their plain versions, then timed under every layout) and phase 6
(`phase_flash`: the flash kernels at every shape); its lines are printed
with the tree's name in front. Exits non-zero if a child fails.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

CHILD = """
import subprocess, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.core.params import human_scale
torch.backends.cuda.matmul.allow_tf32 = False
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
_build.build_all()
dev = torch.device("cuda")
cs.phase_kernels(human_scale(n_hcu=256), dev)
cs.phase_flash(dev)
"""


def main(argv=None) -> int:
    trees = (argv if argv is not None else sys.argv[1:]) or ["."]
    for tree in trees:
        root = str(pathlib.Path(tree).resolve())
        proc = subprocess.run([sys.executable, "-c", CHILD, root],
                              capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[{tree}] {line}")
        if proc.returncode:
            print(f"kernel_ab: {tree} failed with exit code {proc.returncode}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
