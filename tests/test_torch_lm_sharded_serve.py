"""The port's sharded prefill and decode (`Model.prefill` /
`Model.decode_step` on DTensors, `launch.shardings.shard_caches`,
`train.serve_step.generate(..., mesh=)`) on 4 gloo ranks of the CPU,
against the one-device port.

For every smoke id at float32 compute (the port's seed-0 init; 4 prompts
of 128 tokens, llama-3.2-vision's and whisper's with seeded stub
``patch_embeds`` / ``frames``), on meshes (4, 1), (1, 4) and (2, 2):
the prefill's last-position logits within the model-logit tolerances of
tests/test_torch_lm.py (`LOGIT_ATOL`, xlstm's `FAMILY_LOGIT_ATOL`), and 6
greedy tokens (a prefill and 5 decode steps into a 256-slot cache) equal
to the one-device run's. qwen2 and gemma2 also run under
``attn_impl="pallas_flash"``: the flash path (its plain version on the
CPU) must then be taken once per causal self-attention layer of each
prefill, each time on one rank's plain tensors (`sharding.local_flash`),
and the KV cache must stay a DTensor laid out by `cache_specs`.

Measured (torch 2.13 CPU): tokens equal everywhere; logits within 7.1e-6
(zamba2 on (1, 4)) of one device's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as SH
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.sharding import DEFAULT_RULES, use_rules
from repro_torch.models.transformer import Model, layer_kinds
from repro_torch.train.serve_step import generate
from test_torch_lm import FAMILY_LOGIT_ATOL, LOGIT_ATOL

WORLD = 4
MESHES = ((4, 1), (1, 4), (2, 2))
BATCH, PROMPT, NEW, MAX_LEN = 4, 128, 6, 256
FLASH_ARCHS = ("qwen2-1.5b", "gemma2-9b")
CASES = [(a, "dense") for a in ARCH_IDS] + \
    [(a, "pallas_flash") for a in FLASH_ARCHS]


def config(arch, impl):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    return cfg if impl == "dense" else dataclasses.replace(cfg, attn_impl=impl)


def batch_of(cfg):
    rs = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(
        rs.integers(0, cfg.vocab, (BATCH, PROMPT))).to(torch.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(rs.normal(size=(
            BATCH, cfg.n_patches, cfg.vision_dim)).astype(np.float32))
    if cfg.enc_dec:
        b["frames"] = torch.from_numpy(rs.normal(size=(
            BATCH, cfg.n_enc_frames, cfg.vision_dim)).astype(np.float32))
    return b


def run(arch, impl, mesh=None):
    """(greedy tokens, prefill logits) of the smoke model, on ``mesh`` or
    on one device; on a mesh also whether the caches were DTensors."""
    cfg = config(arch, impl)
    model = Model(cfg, device="cpu", seed=0)
    b = batch_of(cfg)
    if mesh is None:
        with torch.no_grad():
            logits, _ = model.prefill(b, model.init_cache(BATCH, MAX_LEN))
        return generate(model, b, NEW, MAX_LEN).numpy(), logits.numpy(), None
    with use_rules(DEFAULT_RULES, mesh):
        SH.shard_params(model, cfg, mesh)
        toks = generate(model, b, NEW, MAX_LEN, mesh=mesh).numpy()
        caches = SH.shard_caches(model.init_cache(BATCH, MAX_LEN), cfg, mesh)
        with torch.no_grad():
            logits, caches = model.prefill(SH.shard_batch(b, mesh), caches)
        # every cache leaf a DTensor; the self-attention KV caches filled
        # with the prompt (a cross-attention layer's is never written)
        leaves = [t for c in caches if c is not None
                  for t in (c[:2] if hasattr(c, "k") else c)]
        lengths = {c.length for c in caches if hasattr(c, "k")}
        placed = all(hasattr(t, "device_mesh") for t in leaves) and \
            (not lengths or (PROMPT in lengths and lengths <= {0, PROMPT}))
        return toks, logits.full_tensor().numpy(), placed


def ranks_main(rank, world):
    torch.set_num_threads(1)
    torch.exp(torch.zeros(4))      # warm the first exp on a small tensor
    from repro_torch.kernels import ops
    calls = {"plain": 0, "dtensor": 0}
    flash = ops.flash_attention

    def counting(q, k, v, **kw):
        calls["dtensor" if any(hasattr(t, "device_mesh")
                               for t in (q, k, v)) else "plain"] += 1
        return flash(q, k, v, **kw)
    ops.flash_attention = counting
    meshes = {s: M.make_host_mesh(s, device="cpu") for s in MESHES}
    out = {}
    for arch, impl in CASES:
        for shape, mesh in meshes.items():
            before = dict(calls)
            out[(arch, impl, shape)] = run(arch, impl, mesh)
            out[(arch, impl, shape, "flash")] = {
                k: calls[k] - before[k] for k in calls}
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(ranks_main, WORLD, timeout_s=600)


@pytest.fixture(scope="module")
def reference():
    torch.exp(torch.zeros(4))
    return {c: run(*c) for c in CASES}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,impl", CASES,
                         ids=[f"{a}-{i}" for a, i in CASES])
def test_sharded_serving_matches_one_device(ranks, reference, arch, impl,
                                            mesh):
    toks, logits, placed = ranks[0][(arch, impl, mesh)]
    want_toks, want_logits, _ = reference[(arch, impl)]
    assert placed, "the KV caches must stay DTensors, filled in place"
    np.testing.assert_array_equal(toks, want_toks)
    np.testing.assert_allclose(logits, want_logits, rtol=0,
                               atol=FAMILY_LOGIT_ATOL.get(arch, LOGIT_ATOL))
    # every rank reads the same tokens
    np.testing.assert_array_equal(ranks[WORLD - 1][(arch, impl, mesh)][0],
                                  toks)
    calls = ranks[0][(arch, impl, mesh, "flash")]
    assert calls["dtensor"] == 0
    if impl == "pallas_flash":
        n_attn = sum(k in ("attn", "attn_local")
                     for k in layer_kinds(config(arch, impl)))
        # one prefill inside generate, one more for the logits
        assert calls["plain"] == 2 * n_attn
    else:
        assert calls["plain"] == 0
