"""The tick's soft winner-take-all as one CUDA call (`csrc/wta_draw.cu`),
its ctypes wrapper and its launch counter.

`repro_torch.core.hcu.wta_draw` is the one entry point: on the CPU it
runs its plain PyTorch version (`hcu.wta_draw_plain`, the `rng` calls
that the JAX package's stream is held against), on CUDA it calls
`wta_draw_kernel`, which launches or raises; there is no fallback. The
kernel replaces no TPU kernel (the JAX package's keys, fire draw and
Gumbel noise are XLA glue); the source's note says why it exists and what
bounds it.

`launches["wta_draw"]` counts the wrapper's calls: one per call that
launched (a call of no HCU launches nothing), so a run can show that its
WTA went through the kernel (a CUDA-graph capture counts each captured
tick once, a replay nothing).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bcpnn_update import (_check, _check_cuda,
                                              _check_one, _raise_on)

launches = {"wta_draw": 0}

# the most minicolumns an HCU may have: 128 Gumbel pairs, four a lane
MAX_COLS = 256

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


@functools.cache
def _lib():
    lib = _build.load("wta_draw")
    lib.wta_draw.argtypes = ([_P] * 7 + [_LL] + [_P] * 2 + [_I] * 3
                             + [_F] * 4 + [_P])
    lib.wta_draw.restype = ctypes.c_int
    return lib


def wta_draw_kernel(h_vec, pj, w_rows, counts, keys, *, decay: float,
                    eps: float, inv_temp: float, thresh: float):
    """The support integration and soft WTA of every HCU on CUDA; the
    function of `hcu.wta_draw_plain`, bit for bit.

    h_vec, pj (H, C) float32; w_rows (H, A, C) float32 with counts (H, A)
    float32, or w_rows (H, 1, C) the drive itself with counts None;
    ``keys`` an `hcu.TickKeys` (base_key (2,) int64, t an int32
    one-element tensor, both read on the device, and gid_base an int) or
    the per-HCU keys (H, 2) int64. All contiguous on one CUDA device. The
    float32 scalars: the support's decay a tick, the bias's eps, 1 / the
    WTA temperature and the fire threshold. Returns new (h' (H, C),
    fired (H,) int32); the inputs are not written. Launches on the
    current stream and never synchronises.
    """
    _check_cuda(h_vec)
    dev = h_vec.device
    if h_vec.dim() != 2:
        raise ValueError(f"h_vec must be (H, C), got {tuple(h_vec.shape)}")
    n, C = h_vec.shape
    if not 1 <= C <= MAX_COLS:
        raise ValueError(f"{C} minicolumns: the kernel takes 1 to {MAX_COLS}")
    A = w_rows.shape[1] if torch.is_tensor(w_rows) and w_rows.dim() == 3 else -1
    if n * max(A, 1) * C >= 2 ** 31:
        raise ValueError(f"{n}x{A}x{C} weights exceed int32")
    f32 = torch.float32
    _check("h_vec", h_vec, f32, (n, C), dev)
    _check("pj", pj, f32, (n, C), dev)
    _check("w_rows", w_rows, f32, (n, A, C), dev)
    if counts is None:
        if A != 1:
            raise ValueError(f"a drive is (H, 1, C), got {tuple(w_rows.shape)}")
    else:
        _check("counts", counts, f32, (n, A), dev)
    if torch.is_tensor(keys):
        _check("keys", keys, torch.int64, (n, 2), dev)
        base_key = t = None
        gid_base = 0
    else:
        base_key, t, gid_base = keys
        _check("base_key", base_key, torch.int64, (2,), dev)
        _check_one("t", t, dev)
        keys = None
    h_out = torch.empty_like(h_vec)
    fired = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().wta_draw(
        ptr(h_vec), ptr(pj), ptr(w_rows), ptr(counts), ptr(base_key),
        ptr(t), ptr(keys), int(gid_base), ptr(h_out), ptr(fired), n, A, C,
        decay, eps, inv_temp, thresh, stream)
    _raise_on(rc, "wta_draw")
    if n:
        launches["wta_draw"] += 1
    return h_out, fired
