#!/usr/bin/env python3
"""Static instruction mix of the port's CUDA kernels, from their SASS.

    python3 tools/sass_mix.py [source] [--match NAME]

Run from the repository root on a machine with the CUDA toolkit. Builds
`src/repro_torch/kernels/csrc/<source>.cu` (default flash_attention) as the
port builds it (`repro_torch.kernels._build`), disassembles the library
with `cuobjdump -sass` and prints, for every kernel whose name holds
``--match`` (default flash_fwd_kernel), its instruction count and the
share of each opcode class: float32 FMA (FFMA), other float32 arithmetic,
shared loads and stores (LDS / STS), asynchronous copies (LDGSTS),
shuffles, special functions (MUFU), barriers and the rest (its eight
most frequent opcodes by name).

The counts are static: every instruction of the function once, not
weighted by how often it issues. The float32 kernels unroll their tile
loop's two products completely, so the loop body dominates the count and
its mix stands in for the issued mix, which `ncu` would give where it
runs.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CLASSES = (("ffma", ("FFMA",)), ("float_other", ("FADD", "FMUL", "FMNMX",
                                                   "FSETP", "FSEL", "FCHK")),
           ("lds", ("LDS",)), ("sts", ("STS",)), ("ldgsts", ("LDGSTS",)),
           ("shfl", ("SHFL",)), ("mufu", ("MUFU",)), ("bar", ("BAR",)))


def opcode(line: str) -> str | None:
    m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                 line)
    return m.group(1).split(".")[0] if m else None


def mix(sass: str, match: str) -> dict:
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = collections.Counter() if match in name else None
            continue
        if name is None or out.get(name) is None:
            continue
        op = opcode(line)
        if op is not None and op != "NOP":
            out[name][op] += 1
    rows = {}
    for fn, ops in out.items():
        if ops is None:
            continue
        total = sum(ops.values())
        row = {"instructions": total}
        rest = total
        for cls, names in CLASSES:
            n = sum(ops[o] for o in names)
            row[cls] = n
            rest -= n
        row["other"] = rest
        named = {o for _, names in CLASSES for o in names}
        row["other_top"] = dict(collections.Counter(
            {o: n for o, n in ops.items() if o not in named}).most_common(8))
        row["ffma_share"] = round(row["ffma"] / total, 4) if total else 0.0
        row["ffma_per_lds"] = (round(row["ffma"] / row["lds"], 2)
                               if row["lds"] else None)
        rows[fn] = row
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?", default="flash_attention")
    ap.add_argument("--match", default="flash_fwd_kernel")
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build
    lib = _build._finish(args.source, *_build._start(args.source))
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    rows = mix(sass, args.match)
    if not rows:
        print(f"sass_mix: no kernel of {lib.name} matches {args.match!r}",
              file=sys.stderr)
        return 1
    for fn, row in rows.items():
        print(f"{fn[:110]}: {json.dumps(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
