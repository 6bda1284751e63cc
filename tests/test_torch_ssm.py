"""The port's recurrent mixers (`repro_torch.models.ssm`) against the JAX
package's (`repro.models.ssm`, run in one child process,
`tests/torch_jax_ref.py`).

On the same numpy parameters and inputs, at float32 compute, for Mamba2
(the zamba2-7b smoke config: d_model 64, 2 heads of 64, state 16), mLSTM
and sLSTM (the xlstm-125m smoke config: d_model 64, 4 heads):

* ``*_seq`` at S = 64 (one chunk) and S = 256 (two Mamba2 chunks, the
  inter-chunk hand-off);
* ``*_seq(return_state=True)`` at S = 256, then three ``*_step`` calls on
  that state: outputs and states, against JAX's prefill-then-step (not
  against ``*_seq`` of the longer sequence);
* ``*_step`` from the empty state.

A second Mamba2 case (``mamba2_bigdt``) sets dt_bias 25 on one head, so
softplus runs past torch's threshold of 20 (the port uses JAX's
``logaddexp(x, 0)``), at S = 64 (prefill, steps and the step from the
empty state). Its cumulative decay reaches about -1600 within the chunk,
where a float32 ulp is 1.2e-4, so past one chunk both frameworks leave
float64 by up to 7e-4 (measured at S = 256: torch 7.3e-4, XLA 2.3e-4);
the S = 256 cases run at the realistic dt of the first case.
Tolerance: rtol = atol = 1e-4 on outputs and states (the largest measured
gap is 9.4e-5 on an mLSTM state of magnitude 8.9, and 4.5e-5 on the
big-dt Mamba2 output, from float32 exps and sums in another order).

At bfloat16 compute (`BF16_CASES`, S = 64, the input in bf16 as the
model's residual stream is): ``*_seq``, then ``*_seq(return_state=True)``
and three ``*_step`` calls, outputs and states, each held by max |diff| /
max |reference| against JAX's bf16 run (`BF16_BOUND`). The bounds start
from the dense family's 0.03 (tests/test_torch_lm.py), which the JAX
package's own bf16-vs-float32 gap at this level already reaches for
Mamba2 (0.0345; mLSTM 0.0154, sLSTM 0.0050), so they are sized instead
from the measured port-vs-JAX gap, as the float32 bound is: Mamba2 0
on every output (the port's `layers.silu` rounds as `jax.nn.silu` does;
with `F.silu` the gap was 0.0226), mLSTM 0.0020, sLSTM 0.00047, all on
``*_seq``; the steps and states lie within 1.3e-6. A bf16 rounding moved
to another place shows: rounding the Mamba2 intra-chunk term, its dt or
its step decay to bf16 moves the gap to 0.0056 / 0.0056 / 0.0036, the
mLSTM gates or its C matrix 0.008 / 0.004, the sLSTM recurrent weights
0.006.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-4)
# case -> (mixer, arch, seq lengths, prefill length)
MIXERS = {"mamba2": ("mamba2", "zamba2-7b", (64, 256), 256),
          "mamba2_bigdt": ("mamba2", "zamba2-7b", (64,), 64),
          "mlstm": ("mlstm", "xlstm-125m", (64, 256), 256),
          "slstm": ("slstm", "xlstm-125m", (64, 256), 256)}
LENGTHS = (64, 256)
SEQ_CASES = [(name, S) for name, (_, _, lens, _) in MIXERS.items()
             for S in lens]
N_STEPS = 3
B = 2
BF16_CASES = ("mamba2", "mlstm", "slstm")
BF16_BOUND = {"mamba2": 1e-3, "mlstm": 3e-3, "slstm": 1e-3}

BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.models import ssm

for case, (mixer, arch, lens, plen) in MIXERS.items():
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    p = {k.split("/")[2]: jnp.asarray(v) for k, v in IN.items()
         if k.startswith(case + "/p/")}
    seq = getattr(ssm, mixer + "_seq")
    step = getattr(ssm, mixer + "_step")
    for S in lens:
        OUT[f"{case}/seq{S}"] = seq(p, jnp.asarray(IN[f"x{S}"]), cfg)
    out, state = seq(p, jnp.asarray(IN[f"x{plen}"]), cfg, return_state=True)
    OUT[f"{case}/prefill"] = out
    for i, s in enumerate(jax.tree.leaves(state)):
        OUT[f"{case}/prefill_state{i}"] = s
    for t in range(N_STEPS):
        xt = jnp.asarray(IN["xs"][:, t:t + 1])
        if mixer == "mamba2":
            y, h, buf = step(p, xt, state[0], cfg, state[1])
            state = (h, buf)
        else:
            y, state = step(p, xt, state, cfg)
        OUT[f"{case}/step{t}"] = y
    for i, s in enumerate(jax.tree.leaves(state)):
        OUT[f"{case}/state{i}"] = s
    # one step from the empty state
    xt = jnp.asarray(IN["xs"][:, :1])
    if mixer == "mamba2":
        inner = cfg.ssm_expand * cfg.d_model
        h0 = jnp.zeros((xt.shape[0], inner // 64, 64, cfg.ssm_state))
        OUT[f"{case}/step_empty"] = step(p, xt, h0, cfg)[0]
    elif mixer == "mlstm":
        hd = cfg.ssm_expand * cfg.d_model // cfg.n_heads
        st = (jnp.zeros((xt.shape[0], cfg.n_heads, hd, hd)),
              jnp.zeros((xt.shape[0], cfg.n_heads, hd)),
              jnp.full((xt.shape[0], cfg.n_heads), -1e30))
        OUT[f"{case}/step_empty"] = step(p, xt, st, cfg)[0]
    else:
        D = cfg.d_model
        st = (jnp.zeros((xt.shape[0], D)),) * 3 + (jnp.full((xt.shape[0], D), -1e30),)
        OUT[f"{case}/step_empty"] = step(p, xt, st, cfg)[0]

# bfloat16 compute at S = 64
for case in BF16_CASES:
    mixer, arch = MIXERS[case][:2]
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    p = {k.split("/")[2]: jnp.asarray(v) for k, v in IN.items()
         if k.startswith(case + "/p/")}
    seq = getattr(ssm, mixer + "_seq")
    step = getattr(ssm, mixer + "_step")
    tag = f"{case}/bfloat16"
    x = jnp.asarray(IN["x64"]).astype(cfg.cdtype)
    OUT[f"{tag}/seq"] = seq(p, x, cfg).astype(jnp.float32)
    out, state = seq(p, x, cfg, return_state=True)
    OUT[f"{tag}/prefill"] = out.astype(jnp.float32)
    for t in range(N_STEPS):
        xt = jnp.asarray(IN["xs"][:, t:t + 1]).astype(cfg.cdtype)
        if mixer == "mamba2":
            y, h, buf = step(p, xt, state[0], cfg, state[1])
            state = (h, buf)
        else:
            y, state = step(p, xt, state, cfg)
        OUT[f"{tag}/step{t}"] = y.astype(jnp.float32)
    for i, s in enumerate(jax.tree.leaves(state)):
        OUT[f"{tag}/state{i}"] = s.astype(jnp.float32)
"""


def _cfg(case):
    return dataclasses.replace(get_smoke_config(MIXERS[case][1]),
                               compute_dtype="float32")


def _param_shapes(case):
    mixer = MIXERS[case][0]
    cfg = _cfg(case)
    D = cfg.d_model
    if mixer == "mamba2":
        inner, N, P, H = ssm.mamba_dims(cfg)
        return {"in_proj": (D, 2 * inner + 2 * N + H), "conv": (4, inner + 2 * N),
                "a_log": (H,), "d_skip": (H,), "dt_bias": (H,),
                "norm_w": (inner,), "out_proj": (inner, D)}
    if mixer == "mlstm":
        inner = cfg.ssm_expand * D
        Hh = cfg.n_heads
        hd = inner // Hh
        return {"up": (D, 2 * inner), "wq": (inner, Hh * hd),
                "wk": (inner, Hh * hd), "wv": (inner, Hh * hd),
                "wif": (inner, 2 * Hh), "if_bias": (2 * Hh,),
                "norm_w": (Hh * hd,), "down": (Hh * hd, D)}
    return {"w": (D, 4 * D), "r": (4, D), "b": (4 * D,), "down": (D, D)}


def _inputs():
    rs = np.random.default_rng(21)
    d = {}
    for case in MIXERS:
        for name, shape in _param_shapes(case).items():
            scale = shape[0] ** -0.5 if len(shape) == 2 else 0.3
            d[f"{case}/p/{name}"] = (rs.normal(size=shape) * scale).astype(
                np.float32)
    # one Mamba2 head's dt beyond torch's softplus threshold (20)
    d["mamba2_bigdt/p/dt_bias"][0] = 25.0
    D = _cfg("mamba2").d_model
    for S in LENGTHS:
        d[f"x{S}"] = rs.normal(size=(B, S, D)).astype(np.float32)
    d["xs"] = rs.normal(size=(B, N_STEPS, D)).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def ref():
    ins = _inputs()
    head = (f"MIXERS = {MIXERS!r}\nLENGTHS = {LENGTHS!r}\n"
            f"N_STEPS = {N_STEPS}\nBF16_CASES = {BF16_CASES!r}\n")
    return ins, run_jax(head + BODY, ins)


def _params(ins, case):
    return {k.split("/")[2]: torch.from_numpy(v) for k, v in ins.items()
            if k.startswith(case + "/p/")}


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), want, err_msg=what, **TOL)


def _flat_state(state):
    return [state[0], state[1]] if len(state) == 2 else list(state)


def _step(mixer, p, xt, state, cfg):
    if mixer == "mamba2":
        y, h, buf = ssm.mamba2_step(p, xt, state[0], cfg, state[1])
        return y, (h, buf)
    return getattr(ssm, mixer + "_step")(p, xt, state, cfg)


@pytest.mark.parametrize("case,S", SEQ_CASES)
def test_seq_matches_jax(ref, case, S):
    ins, want = ref
    out = getattr(ssm, MIXERS[case][0] + "_seq")(
        _params(ins, case), torch.from_numpy(ins[f"x{S}"]), _cfg(case))
    _close(out, want[f"{case}/seq{S}"], f"{case} seq {S}")


@pytest.mark.parametrize("case", list(MIXERS))
def test_prefill_then_steps_match_jax(ref, case):
    ins, want = ref
    mixer, _, _, plen = MIXERS[case]
    cfg = _cfg(case)
    p = _params(ins, case)
    out, state = getattr(ssm, mixer + "_seq")(
        p, torch.from_numpy(ins[f"x{plen}"]), cfg, return_state=True)
    _close(out, want[f"{case}/prefill"], "prefill")
    for i, s in enumerate(_flat_state(state)):
        _close(s, want[f"{case}/prefill_state{i}"], f"prefill state {i}")
    for t in range(N_STEPS):
        y, state = _step(mixer, p, torch.from_numpy(ins["xs"][:, t:t + 1]),
                         state, cfg)
        assert y.shape == (B, 1, cfg.d_model)
        _close(y, want[f"{case}/step{t}"], f"step {t}")
    for i, s in enumerate(_flat_state(state)):
        _close(s, want[f"{case}/state{i}"], f"state {i}")


@pytest.mark.parametrize("case", list(MIXERS))
def test_step_from_the_empty_state_matches_jax(ref, case):
    ins, want = ref
    mixer = MIXERS[case][0]
    cfg = _cfg(case)
    from repro_torch.models.transformer import init_cache_for_kind
    kind = "mamba" if mixer == "mamba2" else mixer
    state = init_cache_for_kind(cfg, kind, B, 8, "cpu")
    if mixer == "mamba2":   # JAX's step starts from an empty conv window too
        state = (state[0], None)
    y, _ = _step(mixer, _params(ins, case),
                 torch.from_numpy(ins["xs"][:, :1]), state, cfg)
    _close(y, want[f"{case}/step_empty"], "step from empty")


def _bf16_run(ins, case):
    """The port's bf16 seq, prefill, steps and state at S = 64."""
    mixer = MIXERS[case][0]
    cfg = dataclasses.replace(_cfg(case), compute_dtype="bfloat16")
    p = _params(ins, case)
    seq = getattr(ssm, mixer + "_seq")
    x = torch.from_numpy(ins["x64"]).bfloat16()
    got = {"seq": seq(p, x, cfg)}
    got["prefill"], state = seq(p, x, cfg, return_state=True)
    for t in range(N_STEPS):
        xt = torch.from_numpy(ins["xs"][:, t:t + 1]).bfloat16()
        got[f"step{t}"], state = _step(mixer, p, xt, state, cfg)
    for i, s in enumerate(_flat_state(state)):
        got[f"state{i}"] = s
    return got


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_matches_jax(ref, case):
    ins, want = ref
    got = _bf16_run(ins, case)
    for k, v in got.items():
        if k.startswith(("seq", "prefill", "step")):
            assert v.dtype == torch.bfloat16, k
        rel = _rel(v.float().numpy(), want[f"{case}/bfloat16/{k}"])
        assert rel < BF16_BOUND[case], (k, rel)


def test_softplus_and_log_sigmoid_are_jaxs():
    """softplus = logaddexp(x, 0) at every x (torch's F.softplus returns x
    above 20); log_sigmoid = -softplus(-x)."""
    x = torch.tensor([-100.0, -20.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0, 100.0])
    want = np.logaddexp(x.double().numpy(), 0.0)
    # atol: exp(-100) is subnormal in float32
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want, rtol=1e-7,
                               atol=1e-44)
    np.testing.assert_allclose(ssm.log_sigmoid(x).numpy(),
                               -np.logaddexp(-x.double().numpy(), 0.0),
                               rtol=1e-7, atol=1e-44)


def test_mamba2_rejects_a_ragged_chunk():
    cfg = _cfg("mamba2")
    p = _params(_inputs(), "mamba2")
    with pytest.raises(ValueError, match="not divisible"):
        ssm.mamba2_seq(p, torch.zeros(1, 200, cfg.d_model), cfg)
