"""Measure the JAX package's own sharded-vs-one-device training gap, which
sizes the bounds of tests/test_torch_lm_sharded.py.

    PYTHONPATH=src:tests python tests/jax_sharded_gaps.py

In one child process with 4 forced host devices (tests/torch_jax_ref.py),
for every LM id's smoke config at float32 compute: `Model.init(PRNGKey(0))`,
3 steps of the jitted `make_train_step(model, AdamW(lr=1e-3,
warmup_steps=5))` on `MarkovLM(vocab, seed=0).batch(step, 4, 16)` (stub
patch embeddings / frames for the VLM and audio families), once on one
device and once on each host mesh (2, 2), (4, 1) and (1, 4) under
`use_rules(DEFAULT_RULES, mesh)` with `param_specs` / `opt_specs`
in/out shardings, as `repro.launch.train` lays them out. Prints, per id
and mesh, the largest relative gap of the step losses and grad norms and
the largest absolute gap of the final parameters. About 6 minutes on a
CPU (40 jit compilations).
"""
import numpy as np

from torch_jax_ref import run_jax

BODY = r"""
import contextlib
import dataclasses
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, get_smoke_config
from repro.data import MarkovLM
from repro.launch import shardings as SH
from repro.launch.mesh import make_host_mesh
from repro.models.sharding import DEFAULT_RULES, use_rules
from repro.models.transformer import Model
from repro.train import AdamW, make_train_step

named = lambda mesh, t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                     is_leaf=lambda x: isinstance(x, P))
for arch in ARCH_IDS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = Model(cfg)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    data = MarkovLM(cfg.vocab, seed=0)
    rs = np.random.default_rng(0)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = rs.normal(
            size=(4, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.enc_dec:
        extra["frames"] = rs.normal(
            size=(4, cfg.n_enc_frames, cfg.vision_dim)).astype(np.float32)
    init = model.init(jax.random.PRNGKey(0))
    for tag, shape in (("one", None), ("2x2", (2, 2)), ("4x1", (4, 1)),
                       ("1x4", (1, 4))):
        params, st = init, opt.init(init)
        mesh = make_host_mesh(shape) if shape else None
        with contextlib.ExitStack() as es:
            if mesh is None:
                fn = jax.jit(make_train_step(model, opt))
            else:
                es.enter_context(mesh)
                es.enter_context(use_rules(DEFAULT_RULES, mesh))
                ps = SH.param_specs(params, cfg, mesh)
                os_ = SH.opt_specs(ps)
                params = jax.tree.map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                    params, ps)
                sh = (named(mesh, ps), named(mesh, os_))
                fn = jax.jit(make_train_step(model, opt),
                             in_shardings=sh + (None,),
                             out_shardings=sh + (None,))
            hist = []
            for s in range(3):
                params, st, m = fn(params, st, dict(data.batch(s, 4, 16),
                                                    **extra))
                hist.append((float(m["loss"]), float(m["grad_norm"])))
        OUT[f"{arch}/{tag}/hist"] = np.array(hist)
        OUT[f"{arch}/{tag}/params"] = np.concatenate(
            [np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(params)])
"""


def main():
    out = run_jax(BODY, timeout=1800, n_devices=4)
    archs = sorted({k.split("/")[0] for k in out})
    for a in archs:
        one, p1 = out[f"{a}/one/hist"], out[f"{a}/one/params"]
        for tag in ("2x2", "4x1", "1x4"):
            rel = np.abs(out[f"{a}/{tag}/hist"] - one) / np.abs(one)
            dp = np.abs(out[f"{a}/{tag}/params"] - p1).max()
            print(f"{a:28s} {tag}: loss {rel[:, 0].max():.2e} grad_norm "
                  f"{rel[:, 1].max():.2e} params {dp:.2e}")


if __name__ == "__main__":
    main()
