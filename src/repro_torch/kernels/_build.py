"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled at first use, with its own `nvcc`
process, into `build/repro_torch/lib<name>-<digest>.so` under the
repository root (a git-ignored directory); the digest covers the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
`build_all` starts one `nvcc` per source at once and waits for all of them.

The libraries have a plain C interface and are loaded with `ctypes`
(no PyTorch headers, so a build takes seconds). A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per-source flags: the BCPNN kernels repeat their plain versions' float32
# operations one for one, so no multiply-add may be contracted there; the
# flash kernels report their registers and spills (ptxas -v)
SOURCE_FLAGS = {"bcpnn_update": ("-fmad=false",),
                "flash_attention": ("-Xptxas", "-v")}

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output of each source built by this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (process or None, temporary output, final path)."""
    out = _target(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp, out) -> pathlib.Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        build_log[name] = log
        os.replace(tmp, out)
    return out


def build_all() -> list[str]:
    """Compile every csrc/*.cu in parallel (one nvcc each) and load them.
    Returns the source names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names if n not in _loaded}
    for n, job in started.items():
        _loaded[n] = ctypes.CDLL(str(_finish(n, *job)))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
    return _loaded[name]
