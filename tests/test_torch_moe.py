"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe`, run in a child process, `tests/torch_jax_ref.py`).

On the same numpy parameters and inputs, at the smoke configs of
qwen3-moe-235b-a22b (top-2 of 8 experts) and llama4-maverick-400b-a17b
(top-1 and a shared expert):

* `moe_ffn`'s ``out``, ``lb_loss`` and ``drop_frac`` at float32 compute
  (rtol = atol = 2e-5; the measured gap is below 1e-6, from sums in
  another order), on random tokens and on two cases where capacity binds:
  a router that sends every token to the same experts (so the ranks of
  equal expert ids, that is the stable sort, decide which tokens are
  dropped), and a llama4 batch of 80 tokens whose capacity,
  round(80 / 8 * 1.25) = round(12.5), rounds half to even (12, not 13).
* At bfloat16 compute the routing decisions (top-k experts of each token)
  must be equal first; then the outputs agree to max |diff| / max |ref|
  < 0.03, the bound of tests/test_torch_lm.py (measured: 0.0077).
* `_rank_within_sorted_key` on keys with many duplicates.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL = 0.03

# case -> (arch, B, S, biased router)
CASES = {
    "qwen3": ("qwen3-moe-235b-a22b", 2, 16, False),
    "llama4": ("llama4-maverick-400b-a17b", 2, 16, False),
    "qwen3_cap_binds": ("qwen3-moe-235b-a22b", 2, 16, True),
    "llama4_cap_half": ("llama4-maverick-400b-a17b", 2, 40, True),
}
BF16_CASES = ("qwen3", "llama4")

BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.models import moe

for name, (arch, B, S, biased) in CASES.items():
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16" and name not in BF16_CASES:
            continue
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
        p = {k[len(name) + 3:]: jnp.asarray(v) for k, v in IN.items()
             if k.startswith(name + "/p/") and "/shared/" not in k}
        shared = {k.rsplit("/", 1)[1]: jnp.asarray(v) for k, v in IN.items()
                  if k.startswith(name + "/p/shared/")}
        if shared:
            p["shared"] = shared
        x = jnp.asarray(IN[name + "/x"]).astype(cfg.cdtype)
        out, aux = moe.moe_ffn(p, x, cfg)
        tag = f"{name}/{dtype}"
        OUT[tag + "/out"] = out.astype(jnp.float32)
        OUT[tag + "/lb_loss"] = aux["lb_loss"]
        OUT[tag + "/drop_frac"] = aux["drop_frac"]
        probs = jax.nn.softmax(x.reshape(B * S, -1).astype(jnp.float32)
                               @ p["router"], axis=-1)
        OUT[tag + "/top_e"] = jax.lax.top_k(probs, cfg.top_k)[1]
keys = jnp.asarray(IN["rank_keys"])
order = jnp.argsort(keys)
OUT["rank"] = moe._rank_within_sorted_key(keys, order)
"""


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)


def _inputs():
    rs = np.random.default_rng(5)
    d = {}
    for name, (arch, B, S, biased) in CASES.items():
        cfg = _cfg(arch)
        D, E, Fd = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        x = rs.normal(size=(B, S, D)).astype(np.float32)
        router = rs.normal(size=(D, E)).astype(np.float32) * 0.3
        if biased:
            # every token prefers the last experts, in one fixed order
            x = np.abs(x)
            router = np.broadcast_to(np.arange(1, E + 1, dtype=np.float32)
                                     * 0.05, (D, E)).copy()
        d[f"{name}/x"] = x
        d[f"{name}/p/router"] = router
        for w, shape in (("wi", (E, D, Fd)), ("wg", (E, D, Fd)),
                         ("wo", (E, Fd, D))):
            d[f"{name}/p/{w}"] = (rs.normal(size=shape)
                                  * shape[1] ** -0.5).astype(np.float32)
        if cfg.n_shared_experts:
            Fs = Fd * cfg.n_shared_experts
            for w, shape in (("wi", (D, Fs)), ("wg", (D, Fs)), ("wo", (Fs, D))):
                d[f"{name}/p/shared/{w}"] = (rs.normal(size=shape)
                                             * shape[0] ** -0.5).astype(
                                                 np.float32)
    d["rank_keys"] = rs.integers(0, 5, 200).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def case():
    ins = _inputs()
    head = f"CASES = {CASES!r}\nBF16_CASES = {BF16_CASES!r}\n"
    return ins, run_jax(head + BODY, ins)


def _params(ins, name):
    p = {k[len(name) + 3:]: torch.from_numpy(v) for k, v in ins.items()
         if k.startswith(name + "/p/") and "/shared/" not in k}
    shared = {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in ins.items()
              if k.startswith(name + "/p/shared/")}
    if shared:
        p["shared"] = shared
    return p


def _run(ins, name, dtype):
    arch = CASES[name][0]
    cfg = _cfg(arch, dtype)
    x = torch.from_numpy(ins[f"{name}/x"]).to(cfg.cdtype)
    return cfg, x, moe.moe_ffn(_params(ins, name), x, cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax_f32(case, name):
    ins, ref = case
    cfg, x, (out, aux) = _run(ins, name, "float32")
    tag = f"{name}/float32"
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref[tag + "/out"], **F32_TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), ref[tag + "/lb_loss"],
                               rtol=1e-6)
    assert float(aux["drop_frac"]) == float(ref[tag + "/drop_frac"])


@pytest.mark.parametrize("name", ["qwen3_cap_binds", "llama4_cap_half"])
def test_binding_capacity_drops_the_later_tokens(case, name):
    """Every token picks the same experts, so each expert keeps the first
    ``cap`` tokens in token order (the stable sort) and drops the rest."""
    ins, ref = case
    arch, B, S, _ = CASES[name]
    cfg = _cfg(arch)
    T = B * S
    cap = moe.capacity(cfg, T)
    if name == "llama4_cap_half":
        assert T * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor == 12.5
        assert cap == 12
    want_drop = 1.0 - min(cap, T) / T
    _, x, (out, aux) = _run(ins, name, "float32")
    assert float(aux["drop_frac"]) == pytest.approx(want_drop, abs=1e-7)
    assert float(ref[f"{name}/float32/drop_frac"]) == pytest.approx(
        want_drop, abs=1e-7)
    # tokens past the capacity get nothing from the routed experts
    routed = out.reshape(T, -1)
    if not cfg.n_shared_experts:
        assert torch.count_nonzero(routed[cap:]) == 0
        assert torch.count_nonzero(routed[:cap].abs().sum(-1)) == cap


@pytest.mark.parametrize("name", BF16_CASES)
def test_moe_ffn_matches_jax_bf16(case, name):
    ins, ref = case
    cfg, x, (out, aux) = _run(ins, name, "bfloat16")
    tag = f"{name}/bfloat16"
    _, _, top_e = moe.route(_params(ins, name), x.reshape(-1, cfg.d_model),
                            cfg)
    np.testing.assert_array_equal(top_e.numpy(), ref[tag + "/top_e"])
    assert out.dtype == torch.bfloat16
    want = ref[tag + "/out"]
    err = np.abs(out.float().numpy() - want).max()
    assert err / np.abs(want).max() < BF16_REL, err
    np.testing.assert_allclose(float(aux["lb_loss"]), ref[tag + "/lb_loss"],
                               rtol=1e-5)
    assert float(aux["drop_frac"]) == float(ref[tag + "/drop_frac"])


def test_rank_within_sorted_key_matches_jax(case):
    ins, ref = case
    keys = torch.from_numpy(ins["rank_keys"]).long()
    order = torch.argsort(keys, stable=True)
    got = moe._rank_within_sorted_key(keys, order)
    np.testing.assert_array_equal(got.numpy(), ref["rank"])
