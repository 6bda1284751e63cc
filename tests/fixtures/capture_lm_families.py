"""Capture the JAX package's serving reference for the MoE, SSM / hybrid,
VLM and audio families into tests/fixtures/lm_families_smoke.npz.

Run from the repo root:

    PYTHONPATH=src:tests python tests/fixtures/capture_lm_families.py

For the smoke configs of qwen3-moe-235b-a22b, llama4-maverick-400b-a17b,
zamba2-7b, xlstm-125m, llama-3.2-vision-11b and whisper-large-v3 at
float32 compute with ``attn_impl="pallas_flash"`` (the Pallas flash
kernel in interpret mode), the JAX package (run through
`tests/torch_jax_ref.run_jax`) serves two prompts of 128 tokens with a
256-slot cache: the token-only families through `ServingEngine` (two
slots: one wave), the VLM and audio families through `generate` with
their memory inputs. The file holds, per arch (key prefix ``<arch>/``):

  * ``param<keystr>``: the flattened parameters (`jax.tree_util.keystr`
    paths), initialised from PRNGKey(0) and rounded to bfloat16, stored as
    their bfloat16 bit patterns (uint16); the JAX run uses exactly these
    values, widened to float32; llama-3.2-vision's cross gates (tanh
    gates, 0 at init, which would hide the cross-attention) are opened
    to 0.5;
  * ``patch_embeds`` (2, 16, 32) / ``frames`` (2, 16, 64), float32, for
    llama-3.2-vision / whisper;
  * ``logits``: the prefill logits (2, 1, vocab) of `Model.prefill`;
  * ``tokens``: the 8 greedy tokens per prompt;

and ``prompts`` (2, 128) int32, the same for every arch. The port replays
it in tests/test_torch_serve.py (CPU, and CUDA where there is one) and
chip_smoke.py phase 7b (H100), where the machine has no JAX.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from torch_jax_ref import run_jax  # noqa: E402

OUT = HERE / "lm_families_smoke.npz"
ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "zamba2-7b",
         "xlstm-125m", "llama-3.2-vision-11b", "whisper-large-v3")
N_PROMPTS, PROMPT_LEN, MAX_LEN, MAX_NEW = 2, 128, 256, 8

BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.launch.serve import Request, ServingEngine
from repro.models.transformer import Model
from repro.train.serve_step import generate

prompts = IN["prompts"]
for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="pallas_flash")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # the cross layers' tanh gates start at 0, which hides cross-attention
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 if "gate_" in jax.tree_util.keystr(p) else a,
        params)
    # bfloat16-representable values, so the file can hold them in 16 bits
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        bits = np.asarray(leaf.astype(jnp.bfloat16)).view(np.uint16)
        OUT[f"{arch}/param{jax.tree_util.keystr(path)}"] = bits
    batch = {"tokens": jnp.asarray(prompts)}
    for k in ("patch_embeds", "frames"):
        if f"{arch}/{k}" in IN:
            batch[k] = jnp.asarray(IN[f"{arch}/{k}"])
    caches = model.init_cache(prompts.shape[0], MAX_LEN)
    logits, _ = jax.jit(model.prefill)(params, batch, caches)
    OUT[f"{arch}/logits"] = np.asarray(logits, np.float32)
    if len(batch) == 1:
        eng = ServingEngine(model, params, prompts.shape[0], MAX_LEN)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, MAX_NEW))
        done = sorted(eng.run(), key=lambda r: r.rid)
        OUT[f"{arch}/tokens"] = np.array([r.out for r in done], np.int32)
    else:
        OUT[f"{arch}/tokens"] = np.asarray(
            generate(model, params, batch, MAX_NEW, MAX_LEN), np.int32)
"""


def memory_inputs():
    """patch_embeds / frames of the VLM / audio smoke configs."""
    rs = np.random.default_rng(1)
    return {
        "llama-3.2-vision-11b/patch_embeds":
            rs.normal(size=(N_PROMPTS, 16, 32)).astype(np.float32),
        "whisper-large-v3/frames":
            rs.normal(size=(N_PROMPTS, 16, 64)).astype(np.float32),
    }


def main():
    prompts = np.random.default_rng(0).integers(
        0, 512, (N_PROMPTS, PROMPT_LEN)).astype(np.int32)
    mem = memory_inputs()
    head = f"ARCHS = {ARCHS!r}\nMAX_LEN, MAX_NEW = {MAX_LEN}, {MAX_NEW}\n"
    out = run_jax(head + BODY, {"prompts": prompts, **mem}, timeout=900)
    np.savez_compressed(OUT, prompts=prompts, **mem, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, "
          f"{len(out) + len(mem) + 1} arrays)")


if __name__ == "__main__":
    main()
