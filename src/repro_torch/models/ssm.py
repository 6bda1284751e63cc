"""State-space and recurrent mixers (the port of `repro.models.ssm`):
Mamba2 (chunked SSD), mLSTM and sLSTM, the backbones of zamba2-7b and
xlstm-125m.

Each mixer has ``init_*`` (parameters), ``*_seq`` (the whole sequence:
prefill and forward; ``return_state=True`` also returns the recurrent
state at the last position) and ``*_step`` (one token against the
recurrent state: decode). The recurrent state is the mixer's cache, O(1)
in the sequence length.

Mamba2 runs the chunked SSD algorithm: quadratic within chunks of
``CHUNK`` = 128 positions, linear across them. The JAX package combines the
chunk summaries with an associative scan; here a loop over the chunks
carries the state, the same sums in the same order per step. The SSD
einsums run in float32 (on the card they need TF32 off to stay within
the CPU's tolerance). ``a_log``, ``d_skip``, ``dt_bias``, ``wif``,
``if_bias`` and the sLSTM ``b`` are float32 whatever ``param_dtype`` is,
as in the JAX package.

Under a mesh the ``*_seq`` mixers run on each rank's rows of the batch,
on plain tensors with their parameters gathered (`_rows_under_mesh`):
DTensor has no rule for their chunked scans and loops. The Mamba2 output
then takes the JAX package's hint.

`softplus` and `log_sigmoid` are JAX's (``logaddexp(x, 0)`` and its
negation at -x), not torch's thresholded softplus.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.base import ArchConfig, dense_init
from repro_torch.models.sharding import active_mesh, hint, local_region

CHUNK = 128
HEAD_DIM = 64                 # Mamba2's head dim P


def silu(x):
    """`jax.nn.silu` as XLA computes it: x * (1 / (1 + exp(-x))), each
    operation rounded to x's dtype. `F.silu` rounds once, and at bfloat16
    differs from JAX's result in 37% of elements, which the recurrences
    carry along the sequence (0.0226 of Mamba2's output); the MLPs keep
    `F.silu`, one pass where this is five."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x):
    return -softplus(-x)


def _gated_norm(y, norm_w, cd):
    """RMS over the last dim (eps 1e-6) times (1 + norm_w), in float32,
    back to ``cd``."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * (1.0 + norm_w.float())).to(cd)


def _params(cfg, generator, device, shapes, fixed):
    """nn.ParameterDict of dense_init draws (name -> (shape, dtype or None
    for pdtype, scale)) and fixed float32 tensors (name -> tensor)."""
    p = {name: nn.Parameter(dense_init(shape, dtype or cfg.pdtype, generator,
                                       device, scale=scale))
         for name, (shape, dtype, scale) in shapes.items()}
    p.update({name: nn.Parameter(t) for name, t in fixed.items()})
    return nn.ParameterDict(p)


# ================================ Mamba2 (SSD) ===============================

def mamba_dims(cfg: ArchConfig):
    """(inner, N, P, H): inner width, state size, head dim, heads."""
    inner = cfg.ssm_expand * cfg.d_model
    return inner, cfg.ssm_state, HEAD_DIM, inner // HEAD_DIM


def init_mamba2(cfg: ArchConfig, generator, device):
    D = cfg.d_model
    inner, N, P, H = mamba_dims(cfg)
    f32 = lambda fill: torch.full((H,), fill, dtype=torch.float32,
                                  device=device)
    shapes = {"in_proj": ((D, 2 * inner + 2 * N + H), None, None),
              "conv": ((4, inner + 2 * N), None, 0.3),
              "out_proj": ((inner, D), None, None)}
    p = _params(cfg, generator, device, shapes,
                {"a_log": f32(0.0), "d_skip": f32(1.0), "dt_bias": f32(0.0)})
    p["norm_w"] = nn.Parameter(torch.zeros(inner, dtype=cfg.pdtype,
                                           device=device))
    return p


def _mamba_projections(params, x, cfg: ArchConfig):
    inner, N, P, H = mamba_dims(cfg)
    zxbcdt = x @ params["in_proj"].to(cfg.cdtype)
    z, xc, Bm, Cm, dt = torch.split(zxbcdt, [inner, inner, N, N, H], dim=-1)
    return z, xc, Bm, Cm, dt, (inner, N, P, H)


def _causal_conv(u, w):
    """Depthwise causal conv, window 4. u: (B, S, C), w: (4, C)."""
    S = u.shape[1]
    pad = F.pad(u, (0, 0, 3, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, 4):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out


def _mamba_out(params, y, z, cd):
    """Gated RMSNorm, then the out projection."""
    y = _gated_norm(y * silu(z), params["norm_w"], cd)
    return y @ params["out_proj"].to(cd)


def _rows_under_mesh(out_axes=None):
    """Under a mesh, run the decorated mixer on each rank's batch rows
    (`sharding.local_region`) and hint its output to ``out_axes``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(params, x, cfg, *args, **kw):
            if active_mesh() is None:
                return fn(params, x, cfg, *args, **kw)
            out = local_region(fn, params, x, cfg, *args, **kw)
            if out_axes is None:
                return out
            if isinstance(out, tuple):
                return (hint(out[0], *out_axes),) + out[1:]
            return hint(out, *out_axes)
        return wrapped
    return deco


@_rows_under_mesh(("batch", None, "model_d"))
def mamba2_seq(params, x, cfg: ArchConfig, state=None, return_state=False):
    """Chunked SSD over the full sequence. x: (B, S, D). With
    ``return_state`` also returns (h_final (B, H, P, N) float32, the last
    three conv inputs (B, 3, C)), the decode hand-off."""
    B, S, D = x.shape
    cd = cfg.cdtype
    z, xc, Bm, Cm, dt, (inner, N, P, H) = _mamba_projections(params, x, cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out = silu(_causal_conv(conv_in, params["conv"].to(cd)))
    xc, Bm, Cm = torch.split(conv_out, [inner, N, N], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"])                      # (B,S,H)
    a = -torch.exp(params["a_log"].float())                            # (H,)
    dA_log = dt * a[None, None, :]

    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    xh = xc.reshape(B, nc, Q, H, P).float()
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H)
    dAc = dA_log.reshape(B, nc, Q, H)

    cum = torch.cumsum(dAc, dim=2)                                     # (B,nc,Q,H)
    # intra-chunk: L[t, s] = exp(cum_t - cum_s) for s <= t
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]                # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(rel), 0.0)
    G = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    W = G[..., None] * L
    xdt = xh * dtc[..., None]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", W, xdt)

    # chunk summaries: the state each chunk contributes at its end
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_to_end * dtc, xh, Bc)

    # inter-chunk: h_c = exp(sum dA_c) h_{c-1} + S_c, from the incoming state
    chunk_decay = torch.exp(cum[:, :, -1, :])                          # (B,nc,H)
    if state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32,
                            device=x.device)
    h = state
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_before = torch.stack(h_before, dim=1)                            # (B,nc,H,P,N)

    decay_from_start = torch.exp(cum)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_before,
                           decay_from_start)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params["d_skip"][None, None, :, None] * xh.reshape(B, S, H, P)
    y = y.reshape(B, S, inner).to(cd)
    out = _mamba_out(params, y, z, cd)
    if return_state:
        return out, (h, conv_in[:, -3:, :])
    return out


def mamba2_step(params, x_t, state, cfg: ArchConfig, conv_buf=None):
    """One decode step. x_t (B, 1, D); state (B, H, P, N); conv_buf
    (B, 3, C). Returns (out (B, 1, D), state, conv_buf)."""
    B = x_t.shape[0]
    cd = cfg.cdtype
    z, xc, Bm, Cm, dt, (inner, N, P, H) = _mamba_projections(params, x_t, cfg)
    u = torch.cat([xc, Bm, Cm], dim=-1)                                # (B,1,C)
    if conv_buf is None:
        conv_buf = torch.zeros((B, 3, u.shape[-1]), dtype=u.dtype,
                               device=u.device)
    window = torch.cat([conv_buf, u], dim=1)                           # (B,4,C)
    w = params["conv"].to(cd)
    conv_out = silu(torch.einsum("bwc,wc->bc", window, w))[:, None, :]
    new_buf = window[:, 1:, :]
    xc, Bm, Cm = torch.split(conv_out, [inner, N, N], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"])[:, 0]                # (B,H)
    a = -torch.exp(params["a_log"].float())
    dA = torch.exp(dt * a[None, :])
    xh = xc.reshape(B, H, P).float()
    Bv = Bm[:, 0, :].float()
    Cv = Cm[:, 0, :].float()
    state = state * dA[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cv) \
        + params["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, inner).to(cd)
    return _mamba_out(params, y, z, cd), state, new_buf


# ================================== mLSTM ====================================

def mlstm_head_dim(cfg: ArchConfig) -> int:
    inner = cfg.ssm_expand * cfg.d_model
    if inner % cfg.n_heads:
        raise ValueError(f"mLSTM inner width {inner} over {cfg.n_heads} heads")
    return inner // cfg.n_heads


def init_mlstm(cfg: ArchConfig, generator, device):
    D = cfg.d_model
    inner = cfg.ssm_expand * D
    Hh = cfg.n_heads
    hd = mlstm_head_dim(cfg)
    shapes = {"up": ((D, 2 * inner), None, None),
              "wq": ((inner, Hh * hd), None, None),
              "wk": ((inner, Hh * hd), None, None),
              "wv": ((inner, Hh * hd), None, None),
              "wif": ((inner, 2 * Hh), torch.float32, 0.02),
              "down": ((Hh * hd, D), None, None)}
    p = _params(cfg, generator, device, shapes, {
        "if_bias": torch.zeros(2 * Hh, dtype=torch.float32, device=device)})
    p["norm_w"] = nn.Parameter(torch.zeros(Hh * hd, dtype=cfg.pdtype,
                                           device=device))
    return p


def _mlstm_out(params, y, gate, cd):
    y = _gated_norm(y, params["norm_w"], cd) * silu(gate)
    return y @ params["down"].to(cd)


@_rows_under_mesh()
def mlstm_seq(params, x, cfg: ArchConfig, return_state: bool = False):
    """Parallel (attention-like) stabilised mLSTM. x: (B, S, D). With
    ``return_state`` also returns the recurrent state at position S-1,
    (C (B, H, dk, dv), n (B, H, dk), m (B, H)), rebuilt from the parallel
    form."""
    B, S, D = x.shape
    cd = cfg.cdtype
    Hh = cfg.n_heads
    up = x @ params["up"].to(cd)
    u, gate = torch.chunk(up, 2, dim=-1)
    q = (u @ params["wq"].to(cd)).reshape(B, S, Hh, -1)
    k = (u @ params["wk"].to(cd)).reshape(B, S, Hh, -1)
    v = (u @ params["wv"].to(cd)).reshape(B, S, Hh, -1)
    hd = q.shape[-1]
    gates = u.float() @ params["wif"].float() + params["if_bias"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)                       # (B,S,H)
    cumf = torch.cumsum(log_sigmoid(f_pre), dim=1)
    # a[t, s] = cumf_t - cumf_s + i_s  (s <= t)
    a = cumf[:, :, None, :] - cumf[:, None, :, :] + i_pre[:, None, :, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    a = torch.where(mask[None, :, :, None], a, float("-inf"))
    m = torch.amax(a, dim=2, keepdim=True)                             # (B,S,1,H)
    Dmat = torch.exp(a - m)
    kf, vf = k.float(), v.float()
    qk = torch.einsum("bqhd,bshd->bqsh", q.float(), kf) * hd ** -0.5
    C = qk * Dmat
    n = torch.maximum(torch.abs(C.sum(dim=2)), torch.exp(-m[:, :, 0, :]))
    y = torch.einsum("bqsh,bshd->bqhd", C, vf) / n[..., None]
    y = y.reshape(B, S, Hh * hd).to(cd)
    out = _mlstm_out(params, y, gate, cd)
    if return_state:
        aT = a[:, -1, :, :]                                            # (B,S,H)
        mT = m[:, -1, 0, :]                                            # (B,H)
        wgt = torch.exp(aT - mT[:, None, :])
        Cmat = torch.einsum("bsh,bshk,bshv->bhkv", wgt, kf, vf)
        nvec = torch.einsum("bsh,bshk->bhk", wgt, kf)
        return out, (Cmat, nvec, mT)
    return out


def mlstm_step(params, x_t, state, cfg: ArchConfig):
    """One recurrent step. state = (C (B, H, dk, dv), n (B, H, dk),
    m (B, H)); returns (out (B, 1, D), state)."""
    B = x_t.shape[0]
    cd = cfg.cdtype
    Hh = cfg.n_heads
    up = x_t @ params["up"].to(cd)
    u, gate = torch.chunk(up, 2, dim=-1)
    q = (u @ params["wq"].to(cd)).reshape(B, Hh, -1).float()
    k = (u @ params["wk"].to(cd)).reshape(B, Hh, -1).float()
    v = (u @ params["wv"].to(cd)).reshape(B, Hh, -1).float()
    hd = q.shape[-1]
    gates = u[:, 0].float() @ params["wif"].float() + params["if_bias"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)                       # (B,H)
    logf = log_sigmoid(f_pre)
    Cm, n, m = state
    m_new = torch.maximum(logf + m, i_pre)
    fdec = torch.exp(logf + m - m_new)
    iamp = torch.exp(i_pre - m_new)
    Cm = Cm * fdec[..., None, None] \
        + iamp[..., None, None] * k[:, :, :, None] * v[:, :, None, :]
    n = n * fdec[..., None] + iamp[..., None] * k
    qs = q * hd ** -0.5
    num = torch.einsum("bhk,bhkv->bhv", qs, Cm)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qs, n)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, Hh * hd).to(cd)
    return _mlstm_out(params, y, gate, cd), (Cm, n, m_new)


# ================================== sLSTM ====================================

def init_slstm(cfg: ArchConfig, generator, device):
    D = cfg.d_model
    shapes = {"w": ((D, 4 * D), None, None),
              "r": ((4, D), None, 0.02),                # diagonal recurrence
              "down": ((D, D), None, None)}
    return _params(cfg, generator, device, shapes, {
        "b": torch.zeros(4 * D, dtype=torch.float32, device=device)})


def _slstm_cell(params, u_t, carry):
    """u_t (B, 4D) preactivations; carry = (h, c, n, m), each (B, D)."""
    h, c, n, m = carry
    D = h.shape[-1]
    r = params["r"].float()
    rec = h[:, None, :] * r[None, :, :]                                # (B,4,D)
    pre = u_t.reshape(-1, 4, D).float() + rec \
        + params["b"].float().reshape(4, D)[None]
    zi, ii, fi, oi = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    logf = log_sigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(logf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(zi)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_init_state(B: int, D: int, device):
    z = lambda: torch.zeros((B, D), dtype=torch.float32, device=device)
    return (z(), z(), z(), torch.full((B, D), -1e30, dtype=torch.float32,
                                      device=device))


@_rows_under_mesh()
def slstm_seq(params, x, cfg: ArchConfig, return_state: bool = False):
    """The sLSTM recurrence over the sequence, one position at a time."""
    B, S, D = x.shape
    cd = cfg.cdtype
    u = x @ params["w"].to(cd)
    carry = slstm_init_state(B, D, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_cell(params, u[:, t], carry)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).to(cd)
    out = y @ params["down"].to(cd)
    if return_state:
        return out, carry
    return out


def slstm_step(params, x_t, state, cfg: ArchConfig):
    cd = cfg.cdtype
    u = (x_t @ params["w"].to(cd))[:, 0]
    carry = _slstm_cell(params, u, state)
    y = carry[0][:, None, :].to(cd)
    return y @ params["down"].to(cd), carry
