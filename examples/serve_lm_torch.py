"""Batched serving on the PyTorch/CUDA port: continuous batching over the
`ServingEngine` (the port of examples/serve_lm.py).

  PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen2-1.5b]
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Submits a queue of requests with random prompts to the smoke config,
serves them in fixed-slot waves (prefill + step-synchronous decode with KV
caches) and checks that greedy engine output matches the reference
`generate()` path token for token. With ``--attn pallas_flash`` and
prompts of a multiple of 128 tokens the prefill takes the flash kernel.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import Request, ServingEngine
from repro_torch.models.transformer import Model
from repro_torch.train.serve_step import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--attn", default=None,
                    help="attn_impl override (dense, chunked, pallas_flash)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: CUDA)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    if args.attn:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    model = Model(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.n_requests)]
    # a multiple of 128 slots, so that a 128-aligned prompt can take flash
    max_len = -(-(args.prompt_len + args.max_new + 8) // 128) * 128

    eng = ServingEngine(model, args.batch, max_len, device=args.device)
    for rid, pr in enumerate(prompts):
        eng.submit(Request(rid, pr, args.max_new))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    ntok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {ntok} tokens in {dt:.2f}s "
          f"({ntok / dt:.1f} tok/s, smoke config on {eng.device})")

    # verify against the reference path (greedy) on the first wave's
    # prompts: the same batch shapes, so the same roundings at bf16 (a
    # batch of one takes other GEMM tilings, and greedy bf16 tokens can
    # part after a few steps)
    wave = [r for r in done if r.rid < args.batch]
    tokens = torch.as_tensor(np.stack([prompts[r.rid] for r in wave]),
                             dtype=torch.int32, device=eng.device)
    ref = generate(model, {"tokens": tokens}, max_new=args.max_new,
                   max_len=max_len).cpu()
    for i, r in enumerate(wave):
        ref_toks = [int(t) for t in ref[i]]
        assert r.out == ref_toks, \
            f"request {r.rid}: engine {r.out} != reference {ref_toks}"
    print("OK — engine output matches the reference decode path.")


if __name__ == "__main__":
    main()
