"""Forward flash attention: the Hopper kernels (`csrc/flash_attention.cu`),
their ctypes wrapper and their plain PyTorch version.

Both compute what the JAX package's Pallas `flash_attention`
(`_flash_kernel`) computes, on the model's own layout: q (B, Sq, H, hd),
k / v (B, Skv, Kv, hd) with H % Kv == 0, where query head h reads kv head
h // (H // Kv) (the order `jnp.repeat` gives the JAX model's G-fold copy),
and o (B, Sq, H, hd). Each input may be any strided view with a
contiguous last dim, so the model passes its KV cache as it lies. The
JAX-shaped call, (BH, S, hd) tensors, is the view H = Kv = 1.

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

Two kernels, chosen by dtype and head dim alone (`route`):
``flash_mma_kernel`` (bf16 tensor cores) for bfloat16 with hd a multiple
of 16, ``flash_fwd_kernel`` (float32 on the CUDA cores: register-blocked
float32 products, cp.async double-buffered K / V) for float32 and for
bfloat16 with another hd. Both launch a (B * H, Sq / 64) grid. The
wrapper counts its launches in `launches["flash_attention"]` and, by
kernel, in `routes`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK = 128                  # the JAX kernel's bq = bk; Sq and Skv multiples of it
MAX_HEAD_DIM = 256
LOG2E = 1.4426950408889634

launches = {"flash_attention": 0}
# launches by kernel: "mma" flash_mma_kernel, "simt" flash_fwd_kernel
routes = {"mma": 0, "simt": 0}

_LL = ctypes.c_longlong


class _Args(ctypes.Structure):
    """`FlashArgs` of the CUDA source: pointers, element strides of (batch,
    sequence, head), sizes and the mask."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{d}", _LL) for t in "qkvo" for d in "bsh"]
                + [(n, ctypes.c_int) for n in (
                    "B", "H", "Kv", "Sq", "Skv", "hd", "kv_len", "causal",
                    "has_window", "window")]
                + [(n, ctypes.c_float) for n in (
                    "scale", "softcap", "mma_scale", "inv_softcap",
                    "mma_softcap")])


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def route(dtype, hd: int) -> str:
    """The kernel that takes (dtype, hd): "mma" (`flash_mma_kernel`) for
    bfloat16 with hd a multiple of 16, "simt" (`flash_fwd_kernel`) for
    float32 and for bfloat16 with another multiple of 4; hd up to 256.
    Raises on anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype}: the kernels take float32 or bfloat16")
    if not 0 < hd <= MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"head dim {hd}: the kernels take multiples of 4 "
                         f"up to {MAX_HEAD_DIM}")
    return "mma" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt"


def _as_heads(q, k, v):
    """(q, k, v, squeeze): 4-d inputs as they are; 3-d (BH, S, hd) inputs
    as the views (BH, S, 1, hd), with squeeze True."""
    dims = {q.dim(), k.dim(), v.dim()}
    if dims == {4}:
        return q, k, v, False
    if dims == {3}:
        return q[:, :, None], k[:, :, None], v[:, :, None], True
    raise ValueError("q, k, v must be (B, S, H, hd) / (B, S, Kv, hd), or "
                     "all (BH, S, hd)")


def _check_shapes(q, k, v, kv_len):
    """Sizes of 4-d q, k, v: (B, Sq, H, Skv, Kv, hd, kv_len)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Kv == 0 or H % Kv:
        raise ValueError(f"{H} query heads over {Kv} kv heads")
    if Sq % BLOCK or Skv % BLOCK:
        raise ValueError(f"Sq ({Sq}) and Skv ({Skv}) must be multiples of "
                         f"{BLOCK} (the caller pads)")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {Skv}]")
    return B, Sq, H, Skv, Kv, hd, kv_len


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None, kv_len=None):
    """The plain PyTorch version: an online-softmax loop over 128-wide KV
    blocks, every query row at once, as `_flash_kernel` runs its kv grid
    axis; a kv head's block is broadcast over its query heads. ``kv_len``
    is a Python int (default Skv). Returns a new tensor of q's shape."""
    q4, k4, v4, squeeze = _as_heads(q, k, v)
    B, Sq, H, Skv, Kv, hd, kv_len = _check_shapes(q4, k4, v4, kv_len)
    G = H // Kv
    dev = q.device
    # (B, Kv, G, Sq, hd): query head h = kv head h // G, group h % G
    qf = q4.float().reshape(B, Sq, Kv, G, hd).permute(0, 2, 3, 1, 4)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Kv, G, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, BLOCK):
        # (B, Kv, 1, BLOCK, hd)
        kb, vb = (t[:, k0:k0 + BLOCK].float().permute(0, 2, 1, 3)[:, :, None]
                  for t in (k4, v4))
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * scale
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
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out[:, :, 0] if squeeze else out


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_kernel(q, k, v, *, scale: float, causal: bool = True,
                           window: int | None = None,
                           softcap: float | None = None, kv_len=None):
    """Forward attention as one CUDA launch.

    Replaces `repro/kernels/flash_attention.py:flash_attention`
    (`_flash_kernel`). bfloat16 inputs with hd a multiple of 16 take
    `flash_mma_kernel`: FlashAttention-2 on mma.sync bf16 tensor cores
    with float32 accumulation, 64 query rows a block and 32-key K / V
    tiles by cp.async in a two-stage swizzled ring, P V as two products
    (P's bf16 hi and lo parts) against the exact V so that PV keeps
    float32 accuracy, the heaviest query tiles of every head launched
    first; at the prefill shapes the tensor cores bound it. float32
    inputs, and bfloat16 with another hd, take `flash_fwd_kernel`:
    float32 on the CUDA cores, bound by their 67 TFLOP/s;
    FlashAttention-2 with both products as register-blocked micro-tiles
    (a lane holds 2 x 4 logits and a 2-row slice of the output, fed by
    float4 shared loads), P staged once a tile in shared memory, 32-key
    K / V tiles by cp.async in a two-stage ring. Both skip key tiles
    outside a query tile's reach where that cannot change the result
    (module docstring); the source note has the designs.

    q (B, Sq, H, hd), k / v (B, Skv, Kv, hd), or all (BH, S, hd): CUDA
    tensors of one dtype, each any view with a contiguous last dim (the
    mma kernel also needs 16-byte aligned rows: every stride a multiple of
    8 elements); Sq and Skv multiples of 128; hd a multiple of 4 up to
    256. ``kv_len`` a Python int (no device read). Returns a new tensor of
    q's shape and dtype. Launches on the current stream and never
    synchronises. The kernel has no backward (nor has the JAX package's):
    where autograd records through q, k or v, the output's backward
    raises instead of leaving their gradients silently out.
    """
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              kv_len=kv_len)
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad
                                       for t in (q, k, v)):
        return _NoBackward.apply(kw, q, k, v)
    return _launch(q, k, v, **kw)


class _NoBackward(torch.autograd.Function):
    """The kernel as a node of the autograd graph whose backward raises."""

    @staticmethod
    def forward(ctx, kw, q, k, v):
        return _launch(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward; train with "
            "attn_impl='dense' (the default), as the JAX package does")


def _launch(q, k, v, *, scale: float, causal: bool = True, window=None,
            softcap=None, kv_len=None):
    """One launch of the forward kernel (`flash_attention_kernel`)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.device.type != "cuda":
            where = t.device if torch.is_tensor(t) else type(t).__name__
            raise ValueError(f"the CUDA kernel takes CUDA tensors, {name} is on {where}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    q4, k4, v4, squeeze = _as_heads(q, k, v)
    B, Sq, H, Skv, Kv, hd, kv_len = _check_shapes(q4, k4, v4, kv_len)
    kind = route(q.dtype, hd)
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")
        if kind == "mma" and (t.data_ptr() % 16 or any(
                s % 8 for s, n in zip(_strides(t), t.shape) if n > 1)):
            raise ValueError(f"{name}: rows must be 16-byte aligned for the "
                             "bf16 kernel (strides multiples of 8)")
    # both kernels launch a (B * H, Sq / 64) grid: y at most 65535
    if Sq // 64 > 65535 or B * H > 2**31 - 1:
        raise ValueError(f"grid too large for B {B}, H {H}, Sq {Sq}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel():
        cap = float(softcap) if softcap else 0.0
        args = _Args(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                     out.data_ptr(), *_strides(q4), *_strides(k4),
                     *_strides(v4), *_strides(out), B, H, Kv, Sq, Skv, hd,
                     kv_len, int(bool(causal)), int(window is not None),
                     0 if window is None else int(window), float(scale), cap,
                     # the mma kernel's logits in log2 units
                     float(scale) * (1.0 if cap else LOG2E),
                     1 / cap if cap else 0.0,
                     cap * LOG2E)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_fwd(ctypes.byref(args),
                                        int(kind == "mma"),
                                        int(q.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention: kernel launch failed with "
                               f"cudaError {rc}")
        launches["flash_attention"] += 1
        routes[kind] += 1
    return out[:, :, 0] if squeeze else out
