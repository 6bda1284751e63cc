"""The port's associative-memory protocol (`repro_torch.experiments`) on
the CPU.

* One case for each case of tests/test_experiments.py, on the same toy
  network (8 HCUs, 6 MCUs, trained once for the module): the train / cue /
  recall round trip, recall after `sram_loss`, its death under a plane
  wipe, the pj bias without `sram_loss`, and the helpers.
* Against the JAX package: the same toy protocol run live in a child
  (tests/torch_jax_ref.py) — attractor and the three recall scores
  exactly; and the committed fixture tests/fixtures/assoc_serve_small.npz
  (`assoc_params()`, written by tests/fixtures/capture_assoc.py from the
  JAX package), which chip_smoke.py replays on the card: the attractor
  and `recall_accuracy`'s (correct, total) plain, after `sram_loss` and
  after `sram_loss` plus a plane wipe, exactly.
* A recall copies its start state into the Simulator's held tensors in
  place (so the chunk graphs survive) and gives the bits of rebinding.
* `cuda`-marked: the fixture through the card's kernels.
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import ROOT, run_jax
from repro_torch.core import BCPNNParams, Simulator
from repro_torch.core import network as N
from repro_torch.experiments import (assoc_params, drive_frame,
                                     recall_accuracy, sram_loss, train_assoc,
                                     winners_from_fired)

FIXTURE = ROOT / "tests" / "fixtures" / "assoc_serve_small.npz"
# a faster sibling of `assoc_params`, as in tests/test_experiments.py
TOY = BCPNNParams(n_hcu=8, rows=48, cols=6, fanout=8, active_queue=16,
                  max_delay=4, mean_delay=1.5, out_rate=1.0,
                  wta_temp=0.25, tau_p=400.0)
N_PATTERNS = 3
CHANCE = 1.0 / TOY.cols


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def make_patterns(p, n_patterns, seed=0):
    """`repro.data.make_patterns`: the same numpy draw."""
    return np.random.default_rng(seed).integers(0, p.rows, (n_patterns,
                                                            p.n_hcu))


def wipe_planes(state, p):
    """Full ij-plane wipe: every DRAM-resident synaptic plane back to its
    init values (the limit case of total retention loss)."""
    h = state.hcus
    return state._replace(hcus=h._replace(
        zij=torch.zeros_like(h.zij), eij=torch.zeros_like(h.eij),
        pij=torch.full_like(h.pij, p.p_init * p.p_init),
        wij=torch.zeros_like(h.wij), tij=torch.zeros_like(h.tij)))


def corrupts(p):
    return (None, lambda s: sram_loss(s, p),
            lambda s: wipe_planes(sram_loss(s, p), p))


@pytest.fixture(scope="module")
def trained():
    """(sim, patterns, attractor, trained-state copy), trained once."""
    torch.set_flush_denormal(True)
    sim = Simulator(TOY, key=0, cap_fire=TOY.n_hcu, device="cpu")
    patterns = make_patterns(TOY, N_PATTERNS, seed=3)
    attractor = train_assoc(sim, patterns, reps=10)
    return sim, patterns, attractor, N.tree_map(torch.clone, sim.state)


def _score(trained, corrupt):
    sim, patterns, attractor, state = trained
    return recall_accuracy(sim, state, patterns, attractor,
                           rng=np.random.default_rng(0), corrupt=corrupt)


def _acc(trained, corrupt):
    correct, total = _score(trained, corrupt)
    assert total > 0
    return correct / total


# -- tests/test_experiments.py, case by case ---------------------------------

def test_train_recall_roundtrip(trained):
    """Partial cues complete to the trained attractor far above chance."""
    _, _, attractor, _ = trained
    assert attractor.shape == (N_PATTERNS, TOY.n_hcu)
    assert (attractor >= 0).all() and (attractor < TOY.cols).all()
    assert _acc(trained, corrupt=None) >= 0.6 > 2 * CHANCE


def test_recall_survives_sram_loss(trained):
    """After the volatile j-side reset, the DRAM planes alone complete the
    patterns — the paper's memory-split claim."""
    assert _acc(trained, corrupt=lambda s: sram_loss(s, TOY)) >= 0.6


def test_sram_loss_recall_dies_under_plane_wipe(trained):
    """sram_loss + full ij-plane wipe leaves nothing to recall from."""
    acc = _acc(trained, corrupt=lambda s: wipe_planes(sram_loss(s, TOY),
                                                      TOY))
    assert acc <= 0.25


def test_wipe_without_sram_loss_overstates_recall(trained):
    """WITHOUT sram_loss the trained pj bias keeps recalling above chance
    even with every plane wiped — the contract's reason to exist."""
    acc_bias = _acc(trained, corrupt=lambda s: wipe_planes(s, TOY))
    acc_planes_gone = _acc(trained,
                           corrupt=lambda s: wipe_planes(sram_loss(s, TOY),
                                                         TOY))
    assert acc_bias >= 1.5 * CHANCE
    assert acc_bias > acc_planes_gone


def test_assoc_params_protocol_shape():
    p = assoc_params()
    assert p.n_hcu == 12 and p.cols == 8
    assert p.tau_p > p.tau_e > p.tau_zi  # slow P traces hold the memory


def test_drive_frame_padding_semantics():
    p = TOY
    rows = np.arange(p.n_hcu, dtype=np.int64)
    mask = np.zeros(p.n_hcu, bool)
    mask[::2] = True
    frame = drive_frame(p, rows, mask, device="cpu")
    assert frame.dtype == torch.int32 and frame.device.type == "cpu"
    frame = frame.numpy()
    assert frame.shape[0] == p.n_hcu
    assert (frame[~mask] == p.rows).all()          # padding everywhere else
    assert (frame[mask, 0] == rows[mask]).all()    # cue row in slot 0
    assert (frame[mask, 1:] == p.rows).all()


def test_winners_from_fired_last_wins():
    fired = np.array([[1, -1], [-1, 3], [2, -1], [-1, -1]])
    assert winners_from_fired(fired).tolist() == [2, 3]
    assert winners_from_fired(np.full((4, 2), -1)).tolist() == [-1, -1]
    assert winners_from_fired(torch.from_numpy(fired)).tolist() == [2, 3]


def test_drive_frame_defaults_to_cuda():
    """Like every entry point of the port: CUDA unless asked for the CPU."""
    rows, mask = np.zeros(TOY.n_hcu, int), np.ones(TOY.n_hcu, bool)
    if torch.cuda.is_available():
        assert drive_frame(TOY, rows, mask).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            drive_frame(TOY, rows, mask)


# -- against the JAX package ---------------------------------------------------

_JAX_TOY = """
from repro.core import BCPNNParams, Simulator
from repro.experiments import recall_accuracy, sram_loss, train_assoc

p = BCPNNParams(n_hcu=8, rows=48, cols=6, fanout=8, active_queue=16,
                max_delay=4, mean_delay=1.5, out_rate=1.0, wta_temp=0.25,
                tau_p=400.0)


def wipe_planes(state, p):
    h = state.hcus
    return state._replace(hcus=h._replace(
        zij=jnp.zeros_like(h.zij), eij=jnp.zeros_like(h.eij),
        pij=jnp.full_like(h.pij, p.p_init * p.p_init),
        wij=jnp.zeros_like(h.wij), tij=jnp.zeros_like(h.tij)))


sim = Simulator(p, key=0, cap_fire=p.n_hcu)
OUT["attractor"] = train_assoc(sim, IN["patterns"], reps=10)
trained = jax.tree.map(np.array, sim.state)
corrupts = (None, lambda s: sram_loss(s, p),
            lambda s: wipe_planes(sram_loss(s, p), p),
            lambda s: wipe_planes(s, p))
OUT["recall"] = np.array([recall_accuracy(
    sim, trained, IN["patterns"], OUT["attractor"],
    rng=np.random.default_rng(0), corrupt=c) for c in corrupts])
"""


@pytest.fixture(scope="module")
def jax_toy():
    return run_jax(_JAX_TOY, {"patterns": make_patterns(TOY, N_PATTERNS, 3)},
                   timeout=300)


def test_train_assoc_matches_jax(trained, jax_toy):
    sim, _, attractor, _ = trained
    np.testing.assert_array_equal(attractor, jax_toy["attractor"])


def test_recall_accuracy_matches_jax(trained, jax_toy):
    """The four recall scores (plain, sram_loss, sram_loss + wipe, wipe)
    equal the JAX package's exactly."""
    got = [_score(trained, c) for c in
           corrupts(TOY) + (lambda s: wipe_planes(s, TOY),)]
    np.testing.assert_array_equal(np.array(got), jax_toy["recall"])


def _replay_fixture(device):
    d = dict(np.load(FIXTURE))
    p = assoc_params()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=device)
    attractor = train_assoc(sim, d["patterns"], reps=10)
    trained = N.tree_map(torch.clone, sim.state)
    recall = [recall_accuracy(sim, trained, d["patterns"], attractor,
                              rng=np.random.default_rng(0), corrupt=c)
              for c in corrupts(p)]
    return d, attractor, np.array(recall)


def test_assoc_fixture_reproduced():
    """`assoc_params()`: the JAX package's attractor and recall scores from
    the committed fixture, exactly (what chip_smoke.py's phase 8a holds on
    the card)."""
    d, attractor, recall = _replay_fixture("cpu")
    np.testing.assert_array_equal(attractor, d["attractor"])
    np.testing.assert_array_equal(recall, d["recall"])


def test_recall_copies_in_place_and_keeps_the_bits(trained):
    """A recall writes its start state into the held tensors: the state
    object and its storage stay, and the scores equal those of a
    Simulator whose state is rebound to a fresh copy before each cue."""
    sim, patterns, attractor, state = trained
    held = sim.state
    ptrs = [t.data_ptr() for t in N._leaves(held)]
    got = _score(trained, corrupt=lambda s: sram_loss(s, TOY))
    # on the CPU the driver returns new tensors; the held ones were written
    assert [t.data_ptr() for t in N._leaves(held)] == ptrs
    rng = np.random.default_rng(0)
    correct = total = 0
    for pid in range(len(patterns)):
        cue = rng.random(TOY.n_hcu) < 0.6
        frame = drive_frame(TOY, patterns[pid], cue, device="cpu")
        sim.state = sram_loss(N.tree_map(torch.clone, state), TOY)
        w = winners_from_fired(sim.run(frame.expand(12, -1, -1)))
        probe = ~cue & (w >= 0) & (attractor[pid] >= 0)
        correct += int((w[probe] == attractor[pid][probe]).sum())
        total += int(probe.sum())
    assert got == (correct, total)


@pytest.mark.cuda
def test_assoc_fixture_on_cuda():
    """The fixture through the dense backend's kernels on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, attractor, recall = _replay_fixture("cuda")
    np.testing.assert_array_equal(attractor, d["attractor"])
    np.testing.assert_array_equal(recall, d["recall"])
