"""Associative memory with BCPNN on the PyTorch/CUDA port (the port of
examples/bcpnn_assoc_memory.py).

  PYTHONPATH=src python examples/bcpnn_assoc_memory_torch.py              # CUDA
  PYTHONPATH=src python examples/bcpnn_assoc_memory_torch.py --device cpu

The paper's functional claim, end to end, through the `Simulator` facade:
train P random patterns (one active input row per HCU, repeated while the
WTA fires, so the Hebbian-Bayesian weights bind each pattern's rows to the
MCUs that won), record the attractor, cue with a partial pattern (60% of
the HCUs driven) and report how often the undriven HCUs' WTA recalls the
attractor's MCU. Chance is 1/C. The protocol is `repro_torch.experiments`
(the resilience benchmark re-runs recall under injected retention faults);
this is the plain, fault-free run, with the JAX example's sizes and seeds.
"""
import argparse

from repro_torch.core import Simulator
from repro_torch.core import network as N
from repro_torch.data import make_patterns
from repro_torch.experiments import assoc_params, recall_accuracy, train_assoc

N_PATTERNS = 3
PRESENT_MS = 6
CUE_FRACTION = 0.6


def main():
    import numpy as np
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: CUDA)")
    ap.add_argument("--reps", type=int, default=30,
                    help="presentations of each pattern")
    args = ap.parse_args()

    p = assoc_params()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=args.device)
    patterns = make_patterns(p, N_PATTERNS, seed=3)

    attractor = train_assoc(sim, patterns, reps=args.reps,
                            present_ms=PRESENT_MS)
    print("trained", N_PATTERNS, "patterns,", args.reps, "reps each")

    trained_state = N.tree_map(lambda t: t.cpu().clone(), sim.state)
    correct, total = recall_accuracy(sim, trained_state, patterns, attractor,
                                     cue_fraction=CUE_FRACTION,
                                     rng=np.random.default_rng(0))

    chance = 1.0 / p.cols
    acc = correct / max(total, 1)
    print(f"pattern completion: {correct}/{total} undriven HCUs recalled "
          f"their attractor MCU (acc={acc:.2f}, chance={chance:.2f})")
    assert total > 0, "recall must probe some undriven HCUs"
    if acc > 2 * chance:
        print("OK — associative recall well above chance.")
    else:
        print("WARN — recall near chance; try more --reps.")


if __name__ == "__main__":
    main()
