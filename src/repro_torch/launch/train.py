"""End-to-end training driver (the port of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 200 --batch 8 --seq 128 [--no-smoke] [--device cpu]

The production loop: synthetic Markov LM data, the train step (autograd,
remat, AdamW), async checkpointing, straggler monitoring and restart from
the newest checkpoint. It runs on CUDA unless the caller asks for the
CPU. As in the JAX package, ``--smoke`` is on by default and
``--no-smoke`` takes the published config.

With ``mesh`` (a DeviceMesh, `launch.mesh.make_host_mesh`; every rank of
it calls `train`) the parameters are DTensors placed by
`shardings.param_specs`, the moments by `shardings.opt_specs` (ZeRO over
"data" with ``zero=True``) and each batch by `shardings.batch_specs`, all
under `use_rules(DEFAULT_RULES, mesh)`, as the JAX launcher lays them out.
Every rank draws the same parameters and batches from ``seed`` and keeps
its shard. The device is the mesh's.

Checkpoints hold ``(params, opt_state)`` as the JAX package's tree
(`state_tree`): the parameter tree with each pattern position's layers
stacked, then `AdamWState(step, mu, nu)` with ``step`` int32. Either
package restores the other's. The VLM and audio families need
``patch_embeds`` / ``frames`` in the batch, which `MarkovLM` does not
make: their forward raises here, as the JAX launcher's fails.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch import convert
from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data import MarkovLM
from repro_torch.launch import shardings as SH
from repro_torch.models.sharding import (DEFAULT_RULES, mesh_device,
                                         placements, shard_tensor, use_rules)
from repro_torch.models.transformer import Model
from repro_torch.runtime import StragglerMonitor
from repro_torch.train import AdamW, AdamWState, make_train_step, model_params


def state_tree(params, opt_state: AdamWState, cfg):
    """``(params, opt_state)`` as the JAX package's checkpoint tree: the
    stacked leaves are new tensors on the parameters' device."""
    with torch.no_grad():
        tree = lambda d: convert.lm_tree(d, cfg)
        return (tree(params),
                AdamWState(opt_state.step, tree(opt_state.mu),
                           tree(opt_state.nu)))


def state_template(params, cfg):
    """A restore template of `state_tree`'s structure (host tensors, no
    copy)."""
    tmpl = lambda: convert.lm_tree_template(params, cfg)
    return (tmpl(), AdamWState(torch.zeros((), dtype=torch.int32), tmpl(),
                               tmpl()))


def load_state(tree, params, opt_state: AdamWState, cfg) -> AdamWState:
    """Copy a restored `state_tree` into ``params`` and ``opt_state`` in
    place (a DTensor takes its shard of the full leaf); returns the
    optimizer state with the restored step."""
    p_tree, st = tree
    with torch.no_grad():
        for dst, src in ((params, p_tree), (opt_state.mu, st.mu),
                         (opt_state.nu, st.nu)):
            for n, t in convert.lm_tree_leaves(src, cfg, dst).items():
                d = dst[n]
                t = torch.as_tensor(t)
                if isinstance(d, DTensor):
                    d, t = d.to_local(), shard_tensor(
                        t, d.device_mesh, d.placements).to_local()
                d.copy_(t)
    step = torch.as_tensor(st.step, dtype=torch.int32).to(
        opt_state.step.device)
    return AdamWState(step, opt_state.mu, opt_state.nu)


def shard_state(model: Model, opt: AdamW, mesh, *, zero: bool = False):
    """Place ``model`` on ``mesh`` for training, as the JAX launcher does:
    its parameters become DTensors by `shardings.param_specs` (each rank
    keeps its shard of the tensor it holds, the same on every rank), and
    fresh moments are laid out by `shardings.opt_specs`. Returns (params,
    opt_state, place_batch), ``place_batch`` laying a batch (the same on
    every rank) out by `shardings.batch_specs`."""
    cfg = model.cfg
    p_specs = SH.shard_params(model, cfg, mesh)
    params = model_params(model)
    o_specs = SH.opt_specs(p_specs, zero=zero, mesh=mesh,
                           params=SH.shape_tree(params, cfg))
    opt_state = opt.init(params, {
        n: placements(s, mesh)
        for n, s in SH.layer_specs(o_specs.mu, cfg, params).items()})

    def place_batch(b):
        specs = SH.batch_specs(b, mesh)
        return {k: shard_tensor(v, mesh, placements(specs[k], mesh))
                for k, v in b.items()}
    return params, opt_state, place_batch


def train(arch: str, steps: int, batch: int, seq: int, smoke: bool = True,
          ckpt_dir: str | None = None, lr: float = 3e-3, log_every: int = 10,
          mesh=None, seed: int = 0, device=None, on_step=None,
          zero: bool = False, cfg=None):
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint in
    ``ckpt_dir``, if any); returns (model, losses of the steps run).
    ``on_step(step, metrics, seconds)``, if given, sees each step's
    metrics as host floats and its seconds, from the call to the host
    read of its loss. ``mesh``: a DeviceMesh to train on (``device`` is
    then the mesh's); ``zero`` ZeRO-shards the moments over "data".
    ``cfg`` overrides the config ``arch`` and ``smoke`` name (a cut depth)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("train: mesh must be a DeviceMesh "
                        f"(launch.mesh.make_host_mesh), got {type(mesh)}")
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    device = resolve_device(device) if mesh is None else mesh_device(mesh)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(use_rules(DEFAULT_RULES, mesh))
        return _train(cfg, steps, batch, seq, ckpt_dir, lr, log_every, mesh,
                      seed, device, on_step, zero)


def _train(cfg, steps, batch, seq, ckpt_dir, lr, log_every, mesh, seed,
           device, on_step, zero):
    model = Model(cfg, device=device, seed=seed)
    opt = AdamW(lr=lr, warmup_steps=20)
    data = MarkovLM(vocab=cfg.vocab, seed=seed)
    if mesh is None:
        params = model_params(model)
        opt_state = opt.init(params)
        place_batch = lambda b: b
    else:
        params, opt_state, place_batch = shard_state(model, opt, mesh,
                                                     zero=zero)
    step_fn = make_train_step(model, opt)
    talk = mesh is None or dist.get_rank() == 0     # one log per run

    start = 0
    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        restored, s = restore_latest(ckpt_dir, state_template(params, cfg))
        if restored is not None:
            opt_state = load_state(restored, params, opt_state, cfg)
            del restored
            start = s
            if talk:
                print(f"[restore] resumed from step {s}")

    mon = StragglerMonitor(deadline_s=30.0)
    losses = []
    for step in range(start, steps):
        b = place_batch(data.batch(step, batch, seq, device=device))
        mon.start()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))    # the step's host read
        seconds = time.perf_counter() - t0
        mon.finish()
        if on_step is not None:
            on_step(step, {k: float(v) for k, v in metrics.items()}, seconds)
        if talk and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if ckpt and (step + 1) % 50 == 0:
            ckpt.save_async(step + 1, state_tree(params, opt_state, cfg))
    if ckpt:
        ckpt.save_async(steps, state_tree(params, opt_state, cfg))
        ckpt.wait()
        if mesh is not None:
            dist.barrier()       # the first rank's files are complete
    if talk:
        print(f"[straggler] {mon.summary()}")
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.steps, args.batch, args.seq,
                      smoke=args.smoke, ckpt_dir=args.ckpt, lr=args.lr,
                      device=args.device)
    n = max(len(losses) // 10, 1)
    print(f"loss first10={np.mean(losses[:n]):.4f} "
          f"last10={np.mean(losses[-n:]):.4f}")


if __name__ == "__main__":
    main()
