"""End-to-end LM training on the PyTorch/CUDA port (the port of
examples/train_lm.py): a ~100M-class model's smoke config for a few
hundred steps on synthetic data with the production loop (autograd with
remat, AdamW, async checkpoints, straggler monitor).

  PYTHONPATH=src python examples/train_lm_torch.py [--arch xlstm-125m] [--steps 200]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

Loss target: the Markov stream's entropy floor is log(4) ~ 1.39 nats;
anything approaching it from log(vocab) shows the whole substrate (model,
optimizer, data, checkpointing) learning. Checkpoints go to ``--ckpt``,
by default a temporary directory removed at the end.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        _, losses = train(args.arch, steps=args.steps, batch=args.batch,
                          seq=args.seq, smoke=True,
                          ckpt_dir=args.ckpt or tmp, lr=args.lr,
                          log_every=20, device=args.device)
    n = max(1, min(10, len(losses) // 2))
    first, last = np.mean(losses[:n]), np.mean(losses[-n:])
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"(entropy floor ~1.386; started near log(vocab))")
    assert last < first, "training must reduce loss"
    print("OK — training reduced the loss.")


if __name__ == "__main__":
    main()
