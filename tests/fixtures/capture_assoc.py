"""Capture the associative-memory and recall-serving reference of the JAX
package into tests/fixtures/assoc_serve_small.npz.

Run from the repo root:

    PYTHONPATH=src:tests python tests/fixtures/capture_assoc.py

The JAX package runs in a child (`tests/torch_jax_ref.run_jax`). The file
holds:

  * ``patterns`` (3, 12): `make_patterns(assoc_params(), 3, seed=3)`;
  * ``attractor`` (3, 12): `train_assoc` on `Simulator(assoc_params(),
    key=0, cap_fire=12)` (the dense backend), 10 reps;
  * ``recall`` (3, 2): `recall_accuracy`'s (correct, total) from the
    trained state, each with `rng=np.random.default_rng(0)`: plain, after
    `sram_loss`, and after `sram_loss` plus a wipe of every ij plane back
    to its init values (`wipe_planes`);
  * the toy server: `test_scale(n_hcu=4, rows=48, cols=8)` on the dense
    backend, `cap_fire=4`, warmed for 8 ticks of random rows
    (`np.random.default_rng(7)`, ``warm``), `BCPNNRecallServer(slots=3,
    queue_capacity=8, step_ticks=5)` draining 7 requests of budget 15
    (cue rows and 0.7-masks from `np.random.default_rng(0)`, ``cue_rows``
    / ``cue_mask``); per served session in completion order ``srv_rid``,
    ``srv_status`` (1 done, 0 expired), ``srv_ticks``, ``srv_drops``
    ((in, fire, route)), ``srv_winners`` and the fired trajectories
    concatenated (``srv_fired``, split by ``srv_ticks``).

The port replays it in tests/test_torch_experiments.py and
tests/test_torch_serve_bcpnn.py (CPU) and chip_smoke.py phase 8 (H100).
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from torch_jax_ref import run_jax  # noqa: E402

OUT = HERE / "assoc_serve_small.npz"

# the JAX side of the protocol, shared with the tests' live runs: IN holds
# ``patterns``, ``warm``, ``cue_rows`` and ``cue_mask``
BODY = """
from repro.core import Simulator, test_scale
from repro.experiments import (assoc_params, recall_accuracy, sram_loss,
                               train_assoc)
from repro.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest


def wipe_planes(state, p):
    h = state.hcus
    return state._replace(hcus=h._replace(
        zij=jnp.zeros_like(h.zij), eij=jnp.zeros_like(h.eij),
        pij=jnp.full_like(h.pij, p.p_init * p.p_init),
        wij=jnp.zeros_like(h.wij), tij=jnp.zeros_like(h.tij)))


p = assoc_params()
sim = Simulator(p, key=0, cap_fire=p.n_hcu)
patterns = IN["patterns"]
OUT["attractor"] = train_assoc(sim, patterns, reps=10)
trained = jax.tree.map(np.array, sim.state)
corrupts = (None, lambda s: sram_loss(s, p),
            lambda s: wipe_planes(sram_loss(s, p), p))
OUT["recall"] = np.array([recall_accuracy(
    sim, trained, patterns, OUT["attractor"], rng=np.random.default_rng(0),
    corrupt=c) for c in corrupts])

q = test_scale(n_hcu=4, rows=48, cols=8)
srv_sim = Simulator(q, key=0, cap_fire=q.n_hcu)
srv_sim.run(jnp.asarray(IN["warm"]))
srv = BCPNNRecallServer(srv_sim, slots=3, queue_capacity=8, step_ticks=5)
done = srv.run([RecallRequest(i, IN["cue_rows"][i], IN["cue_mask"][i],
                              budget_ticks=15)
                for i in range(IN["cue_rows"].shape[0])])
OUT["srv_rid"] = np.array([r.rid for r in done])
OUT["srv_status"] = np.array([r.status == "done" for r in done], np.int32)
OUT["srv_ticks"] = np.array([r.ticks for r in done])
OUT["srv_drops"] = np.array([[r.drops[k] for k in ("in", "fire", "route")]
                             for r in done])
OUT["srv_winners"] = np.stack([r.winners for r in done])
OUT["srv_fired"] = np.concatenate([r.fired for r in done])
"""


def inputs() -> dict:
    """The protocol's numpy inputs, from their seeds."""
    patterns = np.random.default_rng(3).integers(0, 64, (3, 12))
    warm = np.random.default_rng(7).integers(0, 48, (8, 4, 4)).astype(np.int32)
    rng = np.random.default_rng(0)
    rows, masks = [], []
    for _ in range(7):
        rows.append(rng.integers(0, 48, 4))
        masks.append(rng.random(4) < 0.7)
    return {"patterns": patterns, "warm": warm,
            "cue_rows": np.stack(rows).astype(np.int32),
            "cue_mask": np.stack(masks)}


def main() -> None:
    ins = inputs()
    out = run_jax(BODY, ins, timeout=600)
    np.savez_compressed(OUT, **ins, **out)
    print(f"wrote {OUT}: attractor {out['attractor'].tolist()}, recall "
          f"{out['recall'].tolist()}, {len(out['srv_rid'])} sessions")


if __name__ == "__main__":
    main()
