"""The port's flash attention against the JAX package's Pallas kernel.

* On the CPU, `repro_torch.kernels.ops.flash_attention` (its plain PyTorch
  version, an online-softmax loop over 128-wide KV blocks) against the JAX
  `repro.kernels.flash_attention.flash_attention` in interpret mode, run
  in one child process: Sq / Skv in {128, 256, 384, 512}, causal and not,
  sliding windows, softcap 50, ``kv_len`` < Skv (where the JAX oracle
  `flash_attention_ref` has no ``kv_len``, so the Pallas kernel is the
  reference), rows with no valid key at all, head dims 16 to 256, and
  bf16 inputs and outputs.
* On a CUDA device (skipped without one), the CUDA kernel against the
  plain version on the same inputs, and its launch count.
* The device decides the path: a non-CPU tensor never reaches the plain
  version.

Tolerance, as the JAX package's own flash tests: float32 rtol = atol =
2e-5 (the sums run in another order: XLA's dot, torch's matmul, the
kernel's per-lane loop); bf16 I/O rtol = atol = 2e-2 (one bf16 rounding of
the output, 2^-8 relative, plus the float32 gap). The CUDA kernel against
the plain version, both computing in float32 from the same inputs: float32
as above; bf16 rtol 8e-3 (one bf16 ulp, under 2^-7 relative), atol 1e-4.
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

# name -> (BH, Sq, Skv, hd, dtype, flash kwargs)
CASES = {
    "causal128": (2, 128, 128, 64, "float32", dict(causal=True)),
    "causal256": (2, 256, 256, 64, "float32", dict(causal=True)),
    "causal384": (2, 384, 384, 64, "float32", dict(causal=True)),
    "causal512": (1, 512, 512, 64, "float32", dict(causal=True)),
    "noncausal256x512": (2, 256, 512, 64, "float32", dict(causal=False)),
    "noncausal384x128": (2, 384, 128, 64, "float32", dict(causal=False)),
    "window": (2, 256, 256, 64, "float32", dict(causal=True, window=64)),
    "softcap": (2, 256, 256, 64, "float32", dict(causal=True, softcap=50.0)),
    "prefill_kvlen": (3, 128, 256, 128, "float32",
                      dict(causal=True, kv_len=128)),
    "short_kvlen": (2, 256, 384, 16, "float32", dict(causal=True, kv_len=100)),
    "gemma_layer": (2, 256, 384, 256, "float32",
                    dict(causal=True, window=96, softcap=50.0, kv_len=256)),
    "rows_without_keys": (2, 128, 256, 64, "float32",
                          dict(causal=True, window=8, kv_len=64)),
    "no_valid_key": (1, 128, 128, 64, "float32", dict(causal=False, kv_len=0)),
    "bf16": (2, 128, 128, 64, "bfloat16", dict(causal=True)),
    "bf16_gemma": (2, 256, 384, 64, "bfloat16",
                   dict(causal=True, window=64, softcap=50.0, kv_len=256)),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KERNEL_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}  # (rtol, atol)

JAX_BODY = """
from repro.kernels.flash_attention import flash_attention
for name, (dtype, kw) in CASES.items():
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(IN[f"{name}_{t}"]).astype(dt) for t in "qkv")
    out = flash_attention(q, k, v, interpret=True, **kw)
    OUT[name] = np.asarray(out.astype(jnp.float32))
"""


def _inputs(name):
    BH, Sq, Skv, hd, dtype, kw = CASES[name]
    rs = np.random.default_rng(sum(map(ord, name)))
    d = {t: rs.normal(size=(BH, s, hd)).astype(np.float32)
         for t, s in (("q", Sq), ("k", Skv), ("v", Skv))}
    return d, dtype, dict(kw, scale=hd ** -0.5)


@pytest.fixture(scope="module")
def jax_out():
    ins, spec = {}, {}
    for name in CASES:
        d, dtype, kw = _inputs(name)
        ins.update({f"{name}_{t}": a for t, a in d.items()})
        spec[name] = (dtype, kw)
    return run_jax(f"CASES = {spec!r}\n" + JAX_BODY, ins)


def _torch_qkv(d, dtype, device):
    dt = getattr(torch, dtype)
    return [torch.from_numpy(d[t]).to(device=device, dtype=dt) for t in "qkv"]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_flash_matches_jax_kernel(jax_out, name):
    d, dtype, kw = _inputs(name)
    out = ops.flash_attention(*_torch_qkv(d, dtype, "cpu"), **kw)
    assert out.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), jax_out[name],
                               rtol=tol, atol=tol)


def test_rows_without_keys_average_v():
    """A row with no valid key averages v over every key, as the JAX
    kernel's -1e30 masking does (exp(0) = 1 for every masked logit)."""
    d, dtype, kw = _inputs("no_valid_key")
    q, k, v = _torch_qkv(d, dtype, "cpu")
    out = FA.flash_attention_plain(q, k, v, **kw)
    want = v.mean(dim=1, keepdim=True).expand_as(out)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", [dict(Sq=100), dict(Skv=200), dict(kv_len=300)])
def test_shapes_the_kernel_does_not_take_raise(bad):
    Sq, Skv = bad.get("Sq", 128), bad.get("Skv", 256)
    q = torch.zeros(1, Sq, 16)
    k = v = torch.zeros(1, Skv, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, scale=0.25, kv_len=bad.get("kv_len"))


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    calls = []
    monkeypatch.setattr(FA, "flash_attention_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(FA, "flash_attention_kernel",
                        lambda *a, **k: calls.append("kernel"))
    q = torch.zeros(1, 128, 16, device="meta")
    ops.flash_attention(q, q, q, scale=0.25)
    ops.flash_attention(torch.zeros(1, 128, 16), torch.zeros(1, 128, 16),
                        torch.zeros(1, 128, 16), scale=0.25)
    assert calls == ["kernel", "plain"]


def test_kernel_rejects_cpu_tensors():
    q = torch.zeros(1, 128, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_kernel(q, q, q, scale=0.25)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_flash_kernel_matches_plain(name):
    dev = _cuda()
    d, dtype, kw = _inputs(name)
    q, k, v = _torch_qkv(d, dtype, dev)
    before = FA.launches["flash_attention"]
    got = FA.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == before + 1
    want = FA.flash_attention_plain(q, k, v, **kw)
    rtol, atol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol, atol=atol)
