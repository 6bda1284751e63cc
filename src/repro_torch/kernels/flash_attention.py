"""Forward flash attention: the Hopper kernel (`csrc/flash_attention.cu`),
its ctypes wrapper and its plain PyTorch version.

Both compute what the JAX package's Pallas `flash_attention`
(`_flash_kernel`) computes: for q (BH, Sq, hd) and k / v (BH, Skv, hd),
logits = (q . k) * scale in float32, then ``tanh(logits / softcap) *
softcap`` where a softcap is given, then NEG_INF (-1e30, not -inf) where a
key is masked: at or past ``kv_len``, after the query (``causal``), or
``window`` or more positions before it. Query positions count from 0 at
the first row. The softmax runs online in float32, PV in float32, and the
output is acc / max(l, 1e-30) in q's dtype. With -1e30 a row's masked
blocks before its first valid key add exp(0) = 1 to the running sums,
which the first valid block's correction exp(-1e30 - m) = 0 erases; a row
with no valid key at all averages v over every key, as the JAX kernel
does.

The wrapper counts its launches in `launches["flash_attention"]`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK = 128                  # the JAX kernel's bq = bk; Sq and Skv multiples of it
MAX_HEAD_DIM = 256

launches = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P] * 4 + [_I] * 9 + [_F, _F, _P]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check_shapes(q, k, v, kv_len):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, hd)")
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    if tuple(k.shape) != (BH, Skv, hd) or tuple(v.shape) != (BH, Skv, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Sq % BLOCK or Skv % BLOCK:
        raise ValueError(f"Sq ({Sq}) and Skv ({Skv}) must be multiples of "
                         f"{BLOCK} (the caller pads)")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {Skv}]")
    return BH, Sq, Skv, hd, kv_len


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None, kv_len=None):
    """The plain PyTorch version: an online-softmax loop over 128-wide KV
    blocks, every query row at once, as `_flash_kernel` runs its kv grid
    axis. ``kv_len`` is a Python int (default Skv)."""
    BH, Sq, Skv, hd, kv_len = _check_shapes(q, k, v, kv_len)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((BH, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, BLOCK):
        kb = k[:, k0:k0 + BLOCK].float()
        vb = v[:, k0:k0 + BLOCK].float()
        logits = torch.matmul(qf, kb.transpose(1, 2)) * scale
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        k_pos = k0 + torch.arange(BLOCK, device=dev)[None, :]
        mask = k_pos < kv_len
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_kernel(q, k, v, *, scale: float, causal: bool = True,
                           window: int | None = None,
                           softcap: float | None = None, kv_len=None):
    """Forward attention as one CUDA launch (`flash_fwd_kernel`).

    Replaces `repro/kernels/flash_attention.py:flash_attention`
    (`_flash_kernel`). Bound on the H100: at the prefill shapes the
    causally needed products (4*hd FLOPs per valid (q, k) pair) over the
    bytes of q, k, v and o are ~240 FLOP/byte, near the bf16 ridge; this
    first kernel runs them on the CUDA cores in float32, so it sits far
    above either bound (PERF.md). Design: one block per (bh, 64-row query
    tile), 8 warps of 8 query rows each; 32-key K / V tiles staged through
    shared memory in float32 (K transposed, so lane j reads key j without
    bank conflicts); running max, sum and accumulator in float32
    registers, the accumulator spread over the lanes by head dim; key
    tiles that are masked for every row of the query tile are skipped
    when every row has a valid key elsewhere (which leaves the result
    unchanged, see the module docstring).

    q / k / v: contiguous (BH, S, hd) CUDA tensors of one dtype, float32
    or bfloat16; hd a multiple of 4 up to 256; Sq and Skv multiples of
    128. ``kv_len`` a Python int (no device read). Returns a new (BH, Sq,
    hd) tensor in q's dtype. Launches on the current stream and never
    synchronises.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.device.type != "cuda":
            where = t.device if torch.is_tensor(t) else type(t).__name__
            raise ValueError(f"the CUDA kernel takes CUDA tensors, {name} is on {where}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; q, k, v must share "
                            "float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    BH, Sq, Skv, hd, kv_len = _check_shapes(q, k, v, kv_len)
    if hd > MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 4 "
                         f"up to {MAX_HEAD_DIM}")
    if BH > 65535:
        raise ValueError(f"BH {BH} > 65535 (the grid's y extent)")
    out = torch.empty_like(q)
    if BH == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        BH, Sq, Skv, hd, kv_len, int(bool(causal)), int(window is not None),
        0 if window is None else int(window), int(q.dtype == torch.bfloat16),
        float(scale), float(softcap) if softcap else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError {rc}")
    launches["flash_attention"] += 1
    return out
