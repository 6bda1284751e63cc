"""Batched LM serving driver (the port of `repro.launch.serve`): a request
queue, batched prefill, step-synchronous decode with per-slot completion,
and waves of up to ``batch_slots`` requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 32 --max-new 32 [--device cpu]

As in the JAX package, ``--smoke`` is on by default (it cannot be turned
off), so ``main`` serves the smoke config; a full-width engine is built
directly (``ServingEngine(Model(get_config(...)), ...)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import rng
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import Model, layer_kinds
from repro_torch.train.serve_step import make_decode_step, make_prefill, sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Step-synchronous batching over a fixed slot count. Runs on
    ``device`` (None means CUDA, and raises where there is none); the model
    is moved there.

    The engine serves token-only batches, as the JAX package's does: the
    VLM and audio families need their memory ("patch_embeds" / "frames")
    and serve through `repro_torch.train.serve_step.generate`; the engine
    refuses them (the JAX engine fails at their first prefill)."""

    def __init__(self, model: Model, batch_slots: int, max_len: int,
                 temperature: float = 0.0, device=None):
        cfg = model.cfg
        if cfg.family == "vlm" or cfg.enc_dec:
            raise ValueError(
                f"{cfg.arch_id}: the engine serves token-only batches; the "
                f"{cfg.family} family serves through generate() with its "
                "patch_embeds / frames")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.slots = batch_slots
        self.max_len = max_len
        self.prefill = make_prefill(self.model)
        self.decode = make_decode_step(self.model, temperature)
        # a ragged wave (mixed prompt lengths) needs the pad mask to reach
        # every mixer of the stack; only the cached-attention kinds honour it
        self.ragged = set(layer_kinds(cfg)) <= {"attn", "attn_local",
                                                "attn_moe"}
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.steps = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _next_wave(self):
        if self.ragged:
            n = min(self.slots, len(self.queue))
            wave, self.queue = self.queue[:n], self.queue[n:]
            return wave
        # recurrent stacks: a wave of the first request's prompt length,
        # skipping over the others without reordering them
        wave, rest = [], []
        plen = len(self.queue[0].prompt)
        for r in self.queue:
            if len(wave) < self.slots and len(r.prompt) == plen:
                wave.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return wave

    def run(self):
        """Drain the queue in FIFO waves of up to ``slots`` requests.
        Attention-only stacks serve mixed prompt lengths in one wave
        (left-padded, the pad slots masked out of the KV cache); the others
        group each wave by equal prompt length."""
        while self.queue:
            self._run_wave(self._next_wave())
        return self.completed

    def wave_inputs(self, wave):
        """The wave's left-padded tokens {"tokens": (B, plen)} and pad
        lengths ((B,) or None when no row is padded), on the device."""
        plen = max(len(r.prompt) for r in wave)
        pad_np = np.array([plen - len(r.prompt) for r in wave], np.int64)
        if pad_np.any() and not self.ragged:
            raise ValueError("mixed prompt lengths need an attention-only "
                             "stack (recurrent mixers cannot mask left-pad)")
        toks = np.zeros((len(wave), plen), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt       # left-pad
        pad = torch.from_numpy(pad_np).to(self.device) if pad_np.any() else None
        return {"tokens": torch.from_numpy(toks).to(self.device)}, pad

    @torch.no_grad()
    def _run_wave(self, wave):
        batch, pad = self.wave_inputs(wave)
        plen = batch["tokens"].shape[1]
        caches = self.model.init_cache(len(wave), self.max_len)
        logits, caches = self.prefill(batch, caches, pad)
        key = rng.PRNGKey(0, self.device)
        tok = sample(logits, key)           # the first token is greedy
        for r, t in zip(wave, tok[:, 0].tolist()):
            r.out.append(t)
        max_new = max(r.max_new for r in wave)
        for step in range(max_new - 1):
            key = rng.fold_in(key, step)
            tok, logits, caches = self.decode(tok, plen + step, caches, key,
                                              None, None, pad)
            self.steps += 1
            for r, t in zip(wave, tok[:, 0].tolist()):
                if not r.done and len(r.out) < r.max_new:
                    r.out.append(t)
                if len(r.out) >= r.max_new:
                    r.done = True
            if all(r.done for r in wave):
                break
        for r in wave:
            r.done = True
            self.completed.append(r)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    eng = ServingEngine(Model(cfg, device=device, seed=0), args.batch,
                        args.prompt_len + args.max_new + 8, device=device)
    gen = np.random.default_rng(0)
    for rid in range(args.n_requests):
        eng.submit(Request(rid, gen.integers(0, cfg.vocab, args.prompt_len),
                           args.max_new))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    ntok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {ntok} tokens in {dt:.2f}s "
          f"({ntok/dt:.1f} tok/s) on {device}")


if __name__ == "__main__":
    main()
