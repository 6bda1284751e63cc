"""The delay-queue enqueue of the tick's fan-out as one CUDA call
(`csrc/spike_enqueue.cu`), its ctypes wrapper and its launch counter.

`repro_torch.core.network.enqueue_spikes` is the one entry point: on the
CPU it runs its plain PyTorch version (`network.enqueue_spikes_plain`),
on CUDA it calls `enqueue_spikes_kernel`, which launches or raises; there
is no fallback. The kernel replaces no TPU kernel (the JAX package's
enqueue is XLA glue); the source's note says why it exists and what
bounds it.

`launches["spike_enqueue"]` counts the wrapper's calls: one per call that
launched, so a run can show that its fan-out went through the kernel (a
CUDA-graph capture counts each captured tick once, a replay nothing).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bcpnn_update import (_check, _check_cuda,
                                              _check_one, _raise_on)

launches = {"spike_enqueue": 0}

# the most slots a bucket may hold: a large key keeps its A smallest
# positions beside a 1024-position chunk in 2048 ints of shared memory
MAX_ACTIVE_QUEUE = 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = _build.load("spike_enqueue")
    lib.spike_enqueue.argtypes = [_P] * 12 + [_LL, _I, _I, _I, _P]
    lib.spike_enqueue.restype = ctypes.c_int
    return lib


def enqueue_spikes_kernel(delay_rows, delay_count, drops_in, t, dest_h,
                          dest_row, delay, valid):
    """Insert a flat batch of M spike messages into the delay queues on
    CUDA; the function of `network.enqueue_spikes_plain`, bit for bit.

    delay_rows (H, D, A) int32 and delay_count (H, D) int32, the queues
    and their counts; drops_in and t int32 one-element tensors (read on
    the device); dest_h / dest_row / delay (M,) int32 and valid (M,) bool;
    all contiguous on one CUDA device. Returns new (delay_rows',
    delay_count', drops_in'); the inputs are not written. Launches on the
    current stream and never synchronises.
    """
    _check_cuda(delay_rows)
    dev = delay_rows.device
    if delay_rows.dim() != 3 or min(delay_rows.shape) < 1:
        raise ValueError(f"delay_rows must be (H, D, A) with every dim at "
                         f"least 1, got {tuple(delay_rows.shape)}")
    n, D, A = delay_rows.shape
    if A > MAX_ACTIVE_QUEUE:
        raise ValueError(f"buckets of {A} slots: the kernel takes at most "
                         f"{MAX_ACTIVE_QUEUE}")
    M = dest_h.shape[0] if torch.is_tensor(dest_h) and dest_h.dim() == 1 else -1
    if n * D * A >= 2 ** 31 or M >= 2 ** 31 - 1:
        raise ValueError(f"{n}x{D}x{A} slots or {M} messages exceed int32")
    _check("delay_rows", delay_rows, torch.int32, (n, D, A), dev)
    _check("delay_count", delay_count, torch.int32, (n, D), dev)
    _check_one("drops_in", drops_in, dev)
    _check_one("t", t, dev)
    for name, x in (("dest_h", dest_h), ("dest_row", dest_row),
                    ("delay", delay)):
        _check(name, x, torch.int32, (M,), dev)
    _check("valid", valid, torch.bool, (M,), dev)
    rows = torch.empty_like(delay_rows)
    count = torch.empty_like(delay_count)
    drops = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(3 * n * D + 2 + 2 * M, dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (delay_rows, rows, delay_count, count,
                                   drops_in, drops, t, dest_h, dest_row,
                                   delay, valid, scratch)]
    rc = _lib().spike_enqueue(*ptrs, M, n, D, A, stream)
    _raise_on(rc, "spike_enqueue")
    launches["spike_enqueue"] += 1
    return rows, count, drops
