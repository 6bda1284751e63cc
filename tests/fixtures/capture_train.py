"""Capture the JAX package's training reference into
tests/fixtures/train_smoke.npz.

Run from the repo root:

    PYTHONPATH=src:tests python tests/fixtures/capture_train.py

For the smoke config of every LM id at float32 compute, the JAX package
(run through `tests/torch_jax_ref.run_jax`) takes STEPS steps of
``jax.jit(make_train_step(Model(cfg), AdamW(lr=1e-3, warmup_steps=5)))``
on ``MarkovLM(vocab, seed=0).batch(step, 4, 16)``; llama-3.2-vision and
whisper get stub ``patch_embeds`` (4, 16, 32) / ``frames`` (4, 16, 64)
in every batch, which the JAX launcher does not make.

The initial parameters are the JAX package's init from PRNGKey(0),
rounded to bfloat16 (so the files hold them in 16 bits), as the serving
fixtures store them: the families in lm_serve_smoke.npz and
lm_families_smoke.npz start from those files' ``<arch>/param<keystr>``
(llama-3.2-vision's cross gates opened to 0.5 there), and this file holds
the rest (``<arch>/init<keystr>``, bfloat16 bit patterns). The file holds,
per arch (key prefix ``<arch>/``):

  * ``loss``, ``total``, ``aux``, ``grad_norm``, ``lr``: (STEPS,) float32,
    each step's metrics;
  * ``norm_grad0<keystr>`` and ``sample_grad0<keystr>``: the gradient
    of the first step's total loss, per leaf its L2 norm and its values
    at SAMPLE evenly spaced flat indices;
  * for FULL_ARCHS, ``param<keystr>``, ``mu<keystr>``, ``nu<keystr>``:
    every final leaf; for the others, per leaf ``norm_param<keystr>`` and
    ``sample_param<keystr>`` (and mu, nu), as for grad0;

and ``patch_embeds`` / ``frames``. The port replays it in
tests/test_torch_train.py (CPU) and chip_smoke.py's train phase (CUDA).
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from torch_jax_ref import run_jax  # noqa: E402

OUT = HERE / "train_smoke.npz"
INIT_FIXTURES = ("lm_serve_smoke.npz", "lm_families_smoke.npz")
ARCH_IDS = ("xlstm-125m", "internlm2-1.8b", "stablelm-3b", "qwen2-1.5b",
            "gemma2-9b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "llama-3.2-vision-11b", "zamba2-7b", "whisper-large-v3")
FULL_ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b")
STEPS, BATCH, SEQ, LR, WARMUP, SAMPLE = 20, 4, 16, 1e-3, 5, 16

BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.data import MarkovLM
from repro.models.transformer import Model
from repro.train import AdamW, make_loss_fn, make_train_step

keystr = jax.tree_util.keystr


def sample(name, leaf):
    a = np.asarray(leaf, np.float32)
    idx = np.linspace(0, a.size - 1, SAMPLE).astype(np.int64)
    OUT[f"{arch}/norm_{name}"] = np.float32(
        np.sqrt(np.sum(a.astype(np.float64) ** 2)))
    OUT[f"{arch}/sample_{name}"] = a.reshape(-1)[idx]


widen = lambda bits: (bits.astype(np.uint32) << 16).view(np.float32)
for arch in ARCH_IDS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    if f"{arch}/param['embed']" in IN:
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(widen(IN[f"{arch}/param{keystr(p)}"])),
            params)
    else:
        params = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            OUT[f"{arch}/init{keystr(path)}"] = np.asarray(
                leaf.astype(jnp.bfloat16)).view(np.uint16)
    opt = AdamW(lr=LR, warmup_steps=WARMUP)
    opt_state = opt.init(params)
    step_fn = jax.jit(make_train_step(model, opt))
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    hist = {k: [] for k in ("loss", "total", "aux", "grad_norm", "lr")}
    for s in range(STEPS):
        batch = data.batch(s, BATCH, SEQ)
        for k in ("patch_embeds", "frames"):
            if f"{arch}/{k}" in IN:
                batch[k] = jnp.asarray(IN[f"{arch}/{k}"])
        if s == 0:
            grads = jax.jit(jax.grad(
                lambda p, b: make_loss_fn(model)(p, b)[0]))(params, batch)
            for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
                sample(f"grad0{keystr(path)}", leaf)
        params, opt_state, m = step_fn(params, opt_state, batch)
        for k in hist:
            hist[k].append(float(m[k]))
    for k, v in hist.items():
        OUT[f"{arch}/{k}"] = np.asarray(v, np.float32)
    for tag, tree in (("param", params), ("mu", opt_state.mu),
                      ("nu", opt_state.nu)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            a = np.asarray(leaf, np.float32)
            name = f"{tag}{keystr(path)}"
            if arch in FULL_ARCHS:
                OUT[f"{arch}/{name}"] = a
            else:
                sample(name, a)
"""


def memory_inputs():
    """The stub patch_embeds / frames of the VLM / audio smoke configs."""
    rs = np.random.default_rng(1)
    return {"llama-3.2-vision-11b/patch_embeds":
                rs.normal(size=(BATCH, 16, 32)).astype(np.float32),
            "whisper-large-v3/frames":
                rs.normal(size=(BATCH, 16, 64)).astype(np.float32)}


def main():
    inits = {}
    for f in INIT_FIXTURES:
        with np.load(HERE / f) as d:
            inits.update({k: d[k] for k in d.files if "/param[" in k})
    mem = memory_inputs()
    head = (f"ARCH_IDS = {ARCH_IDS!r}\nFULL_ARCHS = {FULL_ARCHS!r}\n"
            f"STEPS, BATCH, SEQ, LR, WARMUP, SAMPLE = "
            f"{(STEPS, BATCH, SEQ, LR, WARMUP, SAMPLE)!r}\n")
    out = run_jax(head + BODY, {**inits, **mem}, timeout=1800)
    np.savez_compressed(OUT, **mem, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, "
          f"{len(out) + len(mem)} arrays)")


if __name__ == "__main__":
    main()
