"""Capture the LM serving reference of the JAX package into
tests/fixtures/lm_serve_smoke.npz.

Run from the repo root:

    PYTHONPATH=src:tests python tests/fixtures/capture_lm.py

For the smoke configs of qwen2-1.5b and gemma2-9b at float32 compute with
``attn_impl="pallas_flash"`` (the Pallas flash kernel in interpret mode),
the JAX package (run through `tests/torch_jax_ref.run_jax`) serves two
prompts of 128 tokens with a 256-slot cache, so every prefill goes through
the flash kernel with kv_len 128 < Skv 256. The file holds, per arch (key
prefix ``<arch>/``):

  * ``param<keystr>``: the flattened parameters (`jax.tree_util.keystr`
    paths), initialised from PRNGKey(0) and rounded to bfloat16, stored as
    their bfloat16 bit patterns (uint16) to keep the file small; the JAX
    run uses exactly these values, widened to float32;
  * ``logits``: the prefill logits (2, 1, vocab) of `Model.prefill`;
  * ``tokens``: the 8 greedy tokens per prompt of `ServingEngine`;

and ``prompts`` (2, 128) int32, the same for both. The port replays it in
tests/test_torch_serve.py (CPU) and chip_smoke.py (H100), where the
machine has no JAX.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from torch_jax_ref import run_jax  # noqa: E402

OUT = HERE / "lm_serve_smoke.npz"
ARCHS = ("qwen2-1.5b", "gemma2-9b")
N_PROMPTS, PROMPT_LEN, MAX_LEN, MAX_NEW = 2, 128, 256, 8

BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.launch.serve import Request, ServingEngine
from repro.models.transformer import Model

prompts = IN["prompts"]
for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="pallas_flash")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # bfloat16-representable values, so the file can hold them in 16 bits
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        bits = np.asarray(leaf.astype(jnp.bfloat16)).view(np.uint16)
        OUT[f"{arch}/param{jax.tree_util.keystr(path)}"] = bits
    caches = model.init_cache(prompts.shape[0], MAX_LEN)
    logits, _ = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(prompts)},
                                       caches)
    OUT[f"{arch}/logits"] = np.asarray(logits, np.float32)
    eng = ServingEngine(model, params, prompts.shape[0], MAX_LEN)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, MAX_NEW))
    done = sorted(eng.run(), key=lambda r: r.rid)
    OUT[f"{arch}/tokens"] = np.array([r.out for r in done], np.int32)
"""


def main():
    prompts = np.random.default_rng(0).integers(
        0, 512, (N_PROMPTS, PROMPT_LEN)).astype(np.int32)
    head = f"ARCHS = {ARCHS!r}\nMAX_LEN, MAX_NEW = {MAX_LEN}, {MAX_NEW}\n"
    out = run_jax(head + BODY, {"prompts": prompts}, timeout=600)
    np.savez_compressed(OUT, prompts=prompts, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {len(out) + 1} arrays)")


if __name__ == "__main__":
    main()
