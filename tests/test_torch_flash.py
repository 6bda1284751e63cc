"""The port's flash attention against the JAX package's Pallas kernel.

* On the CPU, `repro_torch.kernels.ops.flash_attention` (its plain PyTorch
  version, an online-softmax loop over 128-wide KV blocks) against the JAX
  `repro.kernels.flash_attention.flash_attention` in interpret mode, run
  in one child process: Sq / Skv in {128, 256, 384, 512}, causal and not,
  sliding windows, softcap 50, ``kv_len`` < Skv (where the JAX oracle
  `flash_attention_ref` has no ``kv_len``, so the Pallas kernel is the
  reference), rows with no valid key at all, head dims 16 to 256, and
  bf16 inputs and outputs. The JAX-shaped (BH, S, hd) calls (`CASES`),
  and GQA calls on the model's layout (`GQA_CASES`: q (B, Sq, H, hd), k /
  v (B, Skv, Kv, hd), some as strided views of a KV cache), which the JAX
  child folds into BH with k / v `jnp.repeat`-ed G times, as
  `repro.models.layers._sdpa_flash` does.
* On a CUDA device (skipped without one), the CUDA kernels against the
  plain version on the same inputs, every case in bf16 and in float32,
  with the launch count and the wrapper's record of the kernel it took;
  and the float32 kernel at the edges of its tiling (`FWD_EDGES`).
* The device decides the path: a non-CPU tensor never reaches the plain
  version.

Tolerance, as the JAX package's own flash tests: float32 rtol = atol =
2e-5 (the sums run in another order: XLA's dot, torch's matmul, the
kernel's loops); bf16 I/O rtol = atol = 2e-2 (one bf16 rounding of the
output, 2^-8 relative, plus the float32 gap). The CUDA kernels against
the plain version, both computing in float32 from the same inputs (the
bf16 kernel's P V in hi + lo parts, ~2^-17 relative): float32 as above;
bf16 rtol 8e-3 (one bf16 ulp, under 2^-7 relative), atol 1e-4.
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

# name -> (BH, Sq, Skv, hd, dtype, flash kwargs): (BH, S, hd) inputs
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
    # hd not a multiple of 16 (the CUDA-core kernel in bf16 too), and one
    # the bf16 kernel pads (80 runs as 128)
    "hd40": (2, 128, 256, 40, "bfloat16", dict(causal=True, kv_len=200)),
    "hd80": (2, 128, 256, 80, "float32", dict(causal=False, window=100)),
}
# name -> (B, H, Kv, Sq, Skv, hd, dtype, flash kwargs, cache slots): q (B,
# Sq, H, hd), k / v (B, Skv, Kv, hd); with cache slots, k / v are the
# first Skv rows of a (B, slots, Kv, hd) cache and q the first H heads of
# a fused (B, Sq, H + 2 Kv, hd) projection, all strided views
GQA_CASES = {
    "gqa6_hd128_kvlen": (2, 12, 2, 128, 256, 128, "bfloat16",
                         dict(causal=True, kv_len=200), None),
    "gqa2_hd256_window_softcap": (1, 4, 2, 256, 256, 256, "float32",
                                  dict(causal=True, window=96, softcap=50.0),
                                  None),
    "gqa4_hd16": (1, 8, 2, 128, 256, 16, "float32", dict(causal=False), None),
    "cache_view": (2, 4, 2, 128, 256, 64, "float32",
                   dict(causal=True, kv_len=160), 384),
}
ALL = list(CASES) + list(GQA_CASES)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KERNEL_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}  # (rtol, atol)

JAX_BODY = """
from repro.kernels.flash_attention import flash_attention
for name, (dtype, kw, heads) in CASES.items():
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(IN[f"{name}_{t}"]).astype(dt) for t in "qkv")
    if heads:   # (B, S, H|Kv, hd), folded as repro.models.layers does
        B, Sq, H, hd = q.shape
        Skv, Kv = k.shape[1], k.shape[2]
        G = H // Kv
        q = q.transpose(0, 2, 1, 3).reshape(B * H, Sq, hd)
        k, v = (jnp.repeat(t.transpose(0, 2, 1, 3), G, axis=1).reshape(
            B * H, Skv, hd) for t in (k, v))
    out = flash_attention(q, k, v, interpret=True, **kw)
    if heads:
        out = out.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    OUT[name] = np.asarray(out.astype(jnp.float32))
"""


def _inputs(name):
    """(numpy arrays, dtype, kwargs): q / k / v, plus "qkv" and the caches
    for a cache-view case."""
    rs = np.random.default_rng(sum(map(ord, name)))
    if name in CASES:
        BH, Sq, Skv, hd, dtype, kw = CASES[name]
        d = {t: rs.normal(size=(BH, s, hd)).astype(np.float32)
             for t, s in (("q", Sq), ("k", Skv), ("v", Skv))}
        return d, dtype, dict(kw, scale=hd ** -0.5)
    B, H, Kv, Sq, Skv, hd, dtype, kw, slots = GQA_CASES[name]
    normal = lambda *s: rs.normal(size=s).astype(np.float32)
    if slots is None:
        d = {"q": normal(B, Sq, H, hd), "k": normal(B, Skv, Kv, hd),
             "v": normal(B, Skv, Kv, hd)}
    else:
        d = {"qkv": normal(B, Sq, H + 2 * Kv, hd),
             "cache_k": normal(B, slots, Kv, hd),
             "cache_v": normal(B, slots, Kv, hd)}
        d.update(q=d["qkv"][:, :, :H], k=d["cache_k"][:, :Skv],
                 v=d["cache_v"][:, :Skv])
    return d, dtype, dict(kw, scale=hd ** -0.5)


@pytest.fixture(scope="module")
def jax_out():
    ins, spec = {}, {}
    for name in ALL:
        d, dtype, kw = _inputs(name)
        ins.update({f"{name}_{t}": np.ascontiguousarray(d[t]) for t in "qkv"})
        spec[name] = (dtype, kw, name in GQA_CASES)
    return run_jax(f"CASES = {spec!r}\n" + JAX_BODY, ins)


def _torch_qkv(d, dtype, device):
    """q, k, v on ``device`` in ``dtype``; the views of a cache-view case
    are cut from its fused projection and caches there."""
    dt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                               dtype=dt)
    if "qkv" not in d:
        return [t(d[n]) for n in "qkv"]
    H, Skv = d["q"].shape[2], d["k"].shape[1]
    qkv, ck, cv = t(d["qkv"]), t(d["cache_k"]), t(d["cache_v"])
    return [qkv[:, :, :H], ck[:, :Skv], cv[:, :Skv]]


@pytest.mark.parametrize("name", ALL)
def test_plain_flash_matches_jax_kernel(jax_out, name):
    d, dtype, kw = _inputs(name)
    q, k, v = _torch_qkv(d, dtype, "cpu")
    if name in GQA_CASES and GQA_CASES[name][-1]:
        assert not (q.is_contiguous() or k.is_contiguous()
                    or v.is_contiguous())
    out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), jax_out[name],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(GQA_CASES))
def test_gqa_layout_equals_the_folded_call(name):
    """The model's layout is a view of the JAX-shaped call: folding (B, H)
    into BH with k / v repeated G times per kv head gives the same
    output."""
    d, dtype, kw = _inputs(name)
    q, k, v = _torch_qkv(d, "float32", "cpu")
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    fold = lambda t, n: t.permute(0, 2, 1, 3).reshape(B * H, n, hd)
    kf, vf = (fold(t.repeat_interleave(H // Kv, dim=2), Skv) for t in (k, v))
    want = FA.flash_attention_plain(fold(q, Sq), kf, vf, **kw)
    got = FA.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(fold(got, Sq).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("H,Kv", [(6, 4), (4, 0)])
def test_query_heads_must_share_kv_heads_evenly(H, Kv):
    q = torch.zeros(1, 128, H, 16)
    k = v = torch.zeros(1, 128, Kv, 16)
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, k, v, scale=0.25)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 80, "mma"),
    (torch.bfloat16, 40, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 4, "simt")])
def test_route_by_dtype_and_head_dim(dtype, hd, want):
    assert FA.route(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.float16, 128, TypeError), (torch.bfloat16, 272, ValueError),
    (torch.float32, 6, ValueError), (torch.bfloat16, 0, ValueError)])
def test_route_raises_on_what_no_kernel_takes(dtype, hd, err):
    with pytest.raises(err):
        FA.route(dtype, hd)


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ALL)
def test_cuda_flash_kernel_matches_plain(name, dtype):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    d, _, kw = _inputs(name)
    q, k, v = _torch_qkv(d, dtype, dev)
    hd = q.shape[-1]
    kind = "mma" if dtype == "bfloat16" and hd % 16 == 0 else "simt"
    before = FA.launches["flash_attention"], dict(FA.routes)
    got = FA.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == before[0] + 1
    assert FA.routes == {r: n + (r == kind) for r, n in before[1].items()}
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape == q.shape
    rtol, atol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol, atol=atol)


# the float32 kernel's edges (the CUDA-core route): name -> (B, H, Kv, Sq,
# Skv, hd, dtype, flash kwargs, misaligned). Its key tiles are 32 wide and
# its head dims padded to 64, 128 or 256; a misaligned case reads q, k and
# v as views one float off 16-byte alignment (the 4-byte copies)
FWD_EDGES = {
    "kvlen_in_tile": (2, 4, 2, 128, 256, 128, "float32",
                      dict(causal=True, kv_len=200), False),
    "window_in_tile": (1, 4, 1, 256, 256, 64, "float32",
                       dict(causal=True, window=40), False),
    "hd4": (1, 2, 1, 128, 128, 4, "float32", dict(causal=True), False),
    "hd40": (2, 2, 2, 128, 256, 40, "float32",
             dict(causal=False, kv_len=170), False),
    "hd112": (1, 6, 2, 128, 128, 112, "float32", dict(causal=True), False),
    "hd256": (1, 2, 1, 256, 384, 256, "float32",
              dict(causal=True, kv_len=300), False),
    "softcap": (1, 4, 2, 256, 256, 128, "float32",
                dict(causal=True, softcap=50.0, window=100), False),
    "bf16_hd40": (2, 4, 2, 128, 256, 40, "bfloat16",
                  dict(causal=True, kv_len=150), False),
    "tile_without_keys": (1, 2, 1, 256, 256, 64, "float32",
                          dict(causal=True, window=8, kv_len=64), False),
    "misaligned": (2, 4, 2, 128, 256, 64, "float32",
                   dict(causal=True, kv_len=220), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FWD_EDGES))
def test_cuda_flash_fwd_kernel_edges_match_plain(name):
    """`flash_fwd_kernel` against the plain version where its tiling has
    an edge: kv_len and a window boundary inside a 32-key tile, head dims
    4, 40, 112 (padded) and 256, a softcap, bf16 at hd 40, a 64-row query
    tile whose rows have no valid key (they average v), and views off
    16-byte alignment."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Kv, Sq, Skv, hd, dtype, kw, misaligned = FWD_EDGES[name]
    rs = np.random.default_rng(sum(map(ord, name)))
    dt = getattr(torch, dtype)
    off = int(misaligned)

    def make(S, heads):
        a = rs.normal(size=(B, S, heads, hd + off)).astype(np.float32)
        return torch.from_numpy(a).to(device=dev, dtype=dt)[..., off:]
    q, k, v = make(Sq, H), make(Skv, Kv), make(Skv, Kv)
    assert (q.data_ptr() % 16 != 0) == misaligned
    kw = dict(kw, scale=hd ** -0.5)
    before = dict(FA.routes)
    got = FA.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.routes == {r: n + (r == "simt") for r, n in before.items()}
    want = FA.flash_attention_plain(q, k, v, **kw)
    rtol, atol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
