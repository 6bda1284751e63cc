"""Quickstart on the PyTorch/CUDA port: a small BCPNN cortex network, end
to end (the port of examples/quickstart.py).

  PYTHONPATH=src python examples/quickstart_torch.py                # CUDA
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds an 8-HCU network behind the `Simulator` facade (connectivity, the
flat network state and the tick backend in one object), stages 200 ms of
Poisson input spikes, runs them through the chunked driver (one CUDA-graph
replay per 128-tick chunk on the card, tick by tick on the CPU) and prints
spike / queue / drop statistics plus a check of the lazy state's
invariants. At R*C = 8192 the size guard picks the dense backend, whose
row and column block kernels run on the card. The spike and drop counts
are the JAX example's.
"""
import argparse

import torch

from repro_torch.core import BCPNNParams, Simulator
from repro_torch.data import poisson_external_drive


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: CUDA)")
    args = ap.parse_args()

    p = BCPNNParams(n_hcu=8, rows=256, cols=32, fanout=8, active_queue=16,
                    max_delay=8, out_rate=0.3)
    sim = Simulator(p, key=0, device=args.device)

    fired = sim.run(poisson_external_drive(p, n_ticks=200, seed=42, lam=4.0,
                                           device=sim.device))
    fired_total = int((fired >= 0).sum())
    drops = sim.drops()

    print(f"ticks simulated     : {int(sim.state.t)} ms")
    print(f"output spikes fired : {fired_total}")
    print(f"input-queue drops   : {drops['in']}")
    print(f"fire-batch drops    : {drops['fire']}")

    # lazy state is exact: flush and verify a few invariants
    st = sim.flushed()
    assert bool(torch.isfinite(st.wij).all()), "weights must stay finite"
    assert bool((st.pij >= 0).all()), "P traces are probabilities"
    print(f"mean |w_ij|         : {float(st.wij.abs().mean()):.4f}")
    print(f"mean P_i            : {float(st.pi.mean()):.5f}")
    print("OK — lazy BCPNN network ran and stayed consistent.")


if __name__ == "__main__":
    main()
