"""LM training through the mesh across the cards of one machine: one NCCL
rank per GPU, `launch.train.train(mesh=...)` on every (data, model) mesh
the cards allow.

    python3 tools/sharded_lm_cards.py              # every visible card
    python3 tools/sharded_lm_cards.py --cpu        # rehearsal: 4 gloo ranks on the CPU, smoke size

Spawns one rank per card (`launch.ranks.spawn_ranks`, NCCL), each on
``cuda:rank``. Rank 0 first trains the model alone on its card (no mesh),
the reference; then every rank trains it on each mesh of shape (d, m)
with d * m the card count: (n, 1) data parallel, (1, n) tensor parallel,
and (2, n / 2) where n is 4 or more, each also with ZeRO moments
(``zero=True``) where d > 1. The model is qwen2-1.5b at full width and
depth (28 layers, 1.54 B float32 parameters, bf16 compute, remat), batch
8 x seq 1024 of `MarkovLM(seed=0)`, AdamW at lr 5e-4 (warm-up 20), --steps
steps a run. Every run's losses must lie within rtol 5e-3 of the
reference's (chip_smoke.py phase 12b's bound: bf16 matmuls summed in
another order) and its grad norms within 5e-2. Prints the card's name
and power limit, ms a step (the median of steps 1 on, host clock to the
loss's host read), tokens/s and peak GiB by mesh and rank, and one JSON
line; exits non-zero on a difference beyond the bounds.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.ranks import spawn_ranks  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ARCH = "qwen2-1.5b"
LR = 5e-4
LOSS_RTOL, GNORM_RTOL = 5e-3, 5e-2


def meshes(n: int) -> list:
    """(shape, zero) of every run on n ranks."""
    shapes = [(n, 1), (1, n)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0
                                 else [])
    return [(s, z) for s in dict.fromkeys(shapes)
            for z in ((False, True) if s[0] > 1 else (False,))]


def one_run(cfg, steps, batch, seq, device, mesh=None, zero=False):
    got = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    _, losses = train(ARCH, steps, batch, seq, cfg=cfg, lr=LR, mesh=mesh,
                      zero=zero, device=device if mesh is None else None,
                      log_every=1000,
                      on_step=lambda st, m, s: got.append(
                          (m["grad_norm"], s)))
    ms = [s * 1e3 for _, s in got]
    return dict(losses=losses, gnorms=[g for g, _ in got], ms=ms,
                median_ms=statistics.median(ms[1:] or ms),
                wall=time.perf_counter() - t0,
                peak=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None))


def rank_main(rank, world, cfg, steps, batch, seq, cpu):
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if rank == 0:
        out["one"] = one_run(cfg, steps, batch, seq, dev)
    dist.barrier()
    for shape, zero in meshes(world):
        mesh = make_host_mesh(shape, device="cpu" if cpu else None)
        out[f"{shape[0]}x{shape[1]}{' zero' if zero else ''}"] = one_run(
            cfg, steps, batch, seq, dev, mesh, zero)
        if not cpu:
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="4 gloo ranks on the CPU at the smoke size")
    args = ap.parse_args(argv)
    if args.cpu:
        world, backend = 4, "gloo"
        cfg = dataclasses.replace(get_smoke_config(ARCH),
                                  compute_dtype="float32")
        batch, seq, smi = 4, 16, "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("sharded_lm_cards: no CUDA device", file=sys.stderr)
            return 2
        world, backend = torch.cuda.device_count(), "nccl"
        cfg, batch, seq = get_config(ARCH), 8, 1024
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; {world} ranks ({backend}); torch {torch.__version__}",
          flush=True)
    t0 = time.perf_counter()
    res = spawn_ranks(rank_main, world, backend=backend,
                      args=(cfg, args.steps, batch, seq, args.cpu),
                      timeout_s=3000)
    ref = res[0]["one"]
    bad = []
    report = {"device": smi, "ranks": world, "arch": ARCH,
              "layers": cfg.n_layers, "batch": batch, "seq": seq,
              "one_device": ref, "meshes": {}}
    print(f"one device: ms a step {ref['median_ms']:.2f}, losses "
          f"{[round(x, 5) for x in ref['losses']]}, peak {ref['peak']} GiB")
    for tag in (k for k in res[0] if k != "one"):
        runs = [res[r][tag] for r in range(world)]
        for r, x in enumerate(runs):
            loss = max(abs(a - b) / abs(b)
                       for a, b in zip(x["losses"], ref["losses"]))
            gn = max(abs(a - b) / abs(b)
                     for a, b in zip(x["gnorms"], ref["gnorms"]))
            if not np.isfinite(x["losses"]).all() or loss > LOSS_RTOL or \
                    gn > GNORM_RTOL:
                bad.append((tag, r, loss, gn))
        med = max(x["median_ms"] for x in runs)
        report["meshes"][tag] = runs
        print(f"mesh {tag}: ms a step by rank "
              f"{[round(x['median_ms'], 2) for x in runs]}, "
              f"{batch * seq / med * 1e3:.0f} tokens/s (the slowest rank), "
              f"peak GiB by rank {[x['peak'] and round(x['peak'], 2) for x in runs]}"
              f", losses {[round(v, 5) for v in runs[0]['losses']]}")
    print(json.dumps(report))
    print(f"sharded_lm_cards: {time.perf_counter() - t0:.1f} s")
    if bad:
        print(f"sharded_lm_cards: FAILED beyond the bounds: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
