"""The sharded runtime across the cards of one machine: one NCCL rank per
GPU, `Simulator.run_sharded` at human width through CUDA-graph chunks.

    python3 tools/sharded_cards.py                 # every visible card
    python3 tools/sharded_cards.py --cpu           # rehearsal: 4 gloo ranks on the CPU, tiny

Spawns one rank per card (`launch.ranks.spawn_ranks`, NCCL), each on
``cuda:rank``, for `human_scale(n_hcu = ranks x --hcu-per-rank)` (256 a
card by default: the per-chip density of the JAX package's human dry
run) under `lossless_route_config`, chunk_smoke's Poisson input (lambda 4,
width 8, seed 0). Each rank runs --ticks ticks that capture one graph
(the exchange's all_to_all inside), then --ticks replayed ticks timed on
the host clock from a barrier to the fired rows' host read. Rank 0 also
runs the same network locally on its card (`Simulator.run` at cap_fire
H, the lossless exchange's fired batch) and sends every rank its slice
of that state: the gathered fired history and every rank's slice of
every state leaf must equal it bit for bit. Then the exchange alone (an
all_to_all of the (ranks, cap_route) int32 words, 100 calls). Prints the
card's name and power limit, µs/tick by rank and one JSON line; exits
non-zero on any difference.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chip_smoke import ext_tensor  # noqa: E402
from repro_torch.core import Simulator  # noqa: E402
from repro_torch.core import distributed as DD  # noqa: E402
from repro_torch.core.params import human_scale, test_scale  # noqa: E402
from repro_torch.launch.mesh import make_bcpnn_mesh  # noqa: E402
from repro_torch.launch.ranks import spawn_ranks  # noqa: E402

EXCHANGE_CALLS = 100


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(rank, world, p, ticks, cpu):
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if cpu:
        torch.set_num_threads(1)
        torch.set_flush_denormal(True)
        torch.exp(torch.zeros(4))
    mesh = make_bcpnn_mesh(device=dev)
    rc = DD.lossless_route_config(p, p.n_hcu // world)
    ext = torch.from_numpy(ext_tensor(p, 2 * ticks)).to(dev)
    ref = None
    if rank == 0:
        ref = Simulator(p, key=0, device=dev, cap_fire=p.n_hcu)
        want = ref.run(ext).cpu()
    sim = Simulator(p, key=0, device=dev)
    t0 = time.perf_counter()
    first = sim.run_sharded(ext[:ticks], mesh, rc=rc).cpu()
    first_s = time.perf_counter() - t0
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    fired = sim.run_sharded(ext[ticks:], mesh, rc=rc).cpu()
    wall = time.perf_counter() - t0
    fired = torch.cat([first, fired])
    # rank 0's local state, each rank's part of it sent to the rank
    specs = DD._shard_specs()[0]
    mine = list(DD._spec_pairs(sim.state, specs))
    theirs = [] if ref is None else list(DD._spec_pairs(ref.state, specs))
    same = []
    for i, (x, spec) in enumerate(mine):
        if spec != DD.SHARD:
            continue
        if rank == 0:
            y = theirs[i][0]
            k = y.shape[0] // world
            for r in range(1, world):
                dist.send(y[r * k:(r + 1) * k].contiguous(), r,
                          group=mesh.group)
            y = y[:k]
        else:
            y = torch.empty_like(x)
            dist.recv(y, 0, group=mesh.group)
        same.append(bool(torch.equal(x, y)))
    del ref
    send = torch.zeros((world, rc.cap_route), dtype=torch.int32, device=dev)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    _sync(dev)
    t1 = time.perf_counter()
    for _ in range(EXCHANGE_CALLS):
        dist.all_to_all_single(recv, send, group=mesh.group)
    _sync(dev)
    exch = (time.perf_counter() - t1) / EXCHANGE_CALLS * 1e6
    out = {"us_per_tick": wall / ticks * 1e6, "first_call_s": first_s,
           "captured": sorted(sim.graphs.captured), "leaves_equal": all(same),
           "leaves": len(same), "exchange_us": exch,
           "drops": sim.drops(), "rows": sim.state.hcus.zij.shape[0]}
    if rank == 0:
        out["fired_equal"] = bool(torch.equal(fired, want))
        out["spikes"] = int((want >= 0).sum())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: every visible card; 4 with --cpu)")
    ap.add_argument("--hcu-per-rank", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on gloo ranks on the CPU at test_scale")
    a = ap.parse_args()
    if a.cpu:
        world = a.ranks or 4
        p = test_scale(n_hcu=2 * world, rows=64, cols=16)
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            sys.exit("sharded_cards: no CUDA device (--cpu rehearses)")
        world = a.ranks or torch.cuda.device_count()
        p = human_scale(n_hcu=world * a.hcu_per_rank)
        backend = "nccl"
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        from repro_torch.kernels import _build
        _build.build_all()
    t0 = time.perf_counter()
    res = spawn_ranks(rank_main, world, backend=backend,
                      args=(p, a.ticks, a.cpu), timeout_s=900)
    ok = res[0]["fired_equal"] and all(r["leaves_equal"] for r in res.values())
    print(f"sharded_cards: {world} {backend} ranks, H={p.n_hcu} "
          f"({p.n_hcu // world} a rank), {2 * a.ticks} ticks: fired history "
          f"{'bit for bit' if res[0]['fired_equal'] else 'NOT equal to'} the "
          f"local run's ({res[0]['spikes']} spikes), state slices "
          f"{'bit for bit' if ok else 'NOT all equal'}; us/tick by rank "
          f"{[round(res[r]['us_per_tick'], 1) for r in range(world)]}; "
          f"exchange alone {[round(res[r]['exchange_us'], 1) for r in range(world)]}"
          f" us; {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ranks": world, "backend": backend, "n_hcu": p.n_hcu,
                      "ok": ok, "by_rank": res}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
