"""The port's merged mode (`repro_torch.core.merged`, the paper's eBrainIII
ring-deferred columns) on the CPU.

* The functions of `repro.core.merged` against the port's, in a child
  process (tests/torch_jax_ref.py), on seeded random inputs: 3 HCUs of
  (12, 8), rings holding 0-8 spike times with empty slots, spikes before,
  inside and after each cell's (Tij, now] window. The JAX functions run
  under `jax.vmap` over the HCUs, the port's batched over them.
* The head fixtures `head_merged_dense.npz` (worklist=False) and
  `head_merged_worklist.npz` (worklist=True), 60 ticks of 4 HCUs of
  (24, 16), flat and with the planes stored in tiles (8, 4) and (7, 5):
  the fired history and every integer leaf, `jring` included, exactly;
  float leaves to the contract of tests/test_torch_engine.py.
* Merged against eager in the port, in tests/test_merged.py's regimes:
  equal fired histories and flushed states within 4e-4; in the
  ring-overflow regime (out_rate 1.0) the overflow flush is exercised.
* `Simulator(merged=True).run` equals `tick` and `run_host`; the chunked
  driver's copy-back pairs hold the rings; on a CUDA device (skipped
  without one) a merged fixture replays through the graphs.

The tolerances are the contract's (rtol 4e-6 / atol 4e-7, wij atol 4e-6,
h atol 1e-4): the merged fixtures' largest float gaps on the CPU are 11%
of them (eij, ei), from float32 exp differing by an ulp between XLA:CPU
and torch.
"""
import numpy as np
import pytest
import torch

from test_torch_engine import (DEFAULT_TOL, FIXTURES, FLOAT_TOL,
                               assert_contract, ext_tensor)
from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import Simulator, rng
from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import merged as M
from repro_torch.core import network as N
from repro_torch.core.params import BCPNNParams, human_scale
from repro_torch.core.params import test_scale as tiny_scale

MERGED_P = BCPNNParams(n_hcu=4, rows=24, cols=16, fanout=4, active_queue=8,
                       max_delay=8, out_rate=0.6)
MERGED_FIXTURES = {"merged_dense": dict(worklist=False),
                   "merged_worklist": dict(worklist=True)}
FN_P = BCPNNParams(n_hcu=3, rows=12, cols=8, fanout=3, active_queue=6,
                   max_delay=8, out_rate=0.6)
NOW = 20


@pytest.fixture(autouse=True)
def _flush_denormal():
    # as in tests/test_torch_engine.py: XLA flushes denormals to zero
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _close(got, want, name, field=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        tol = FLOAT_TOL.get(f"hcus_{field}", DEFAULT_TOL)
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# the functions of merged.py against the JAX package's
# ---------------------------------------------------------------------------

def _ring(rs, n, cols, lo, hi):
    """(n, cols, 8) rings, oldest first: 0-8 sorted spike times in
    [lo, hi], empty slots (RING_EMPTY) in front."""
    ring = np.full((n, cols, M.RING_DEPTH), M.RING_EMPTY, np.int32)
    for h in range(n):
        for j in range(cols):
            k = rs.integers(0, M.RING_DEPTH + 1)
            if k:
                ring[h, j, -k:] = np.sort(rs.choice(np.arange(lo, hi + 1), k,
                                                    replace=False))
    return ring


def _fn_inputs():
    rs = np.random.default_rng(0)
    n, R, C, A = FN_P.n_hcu, FN_P.rows, FN_P.cols, 5
    f32 = lambda *s: (rs.random(s) * 0.3 + 1e-3).astype(np.float32)
    inp = {f: f32(n, R, C) for f in ("zij", "eij", "pij", "wij")}
    inp["tij"] = rs.integers(0, NOW - 2, (n, R, C)).astype(np.int32)
    inp.update({f: f32(n, R) for f in ("zi", "ei", "pi")})
    inp["ti"] = rs.integers(0, NOW - 2, (n, R)).astype(np.int32)
    inp.update({f: f32(n, C) for f in ("zj", "ej", "pj")})
    inp["h"] = (rs.random((n, C)) * 2).astype(np.float32)
    # spike times from before every stamp to past `now` (never pushed,
    # but the window (t0, now] must exclude them)
    inp["ring"] = _ring(rs, n, C, -3, NOW + 2)
    rows = np.full((n, A), R, np.int32)
    for h in range(n):
        k = rs.integers(1, A + 1)
        rows[h, :k] = rs.integers(0, R, k)       # duplicates included
    inp["rows"] = rows
    inp["j"] = np.array([2, 5, 7], np.int32)
    inp["apply"] = np.array([True, False, True])
    # row blocks for merged_row_math: (H, A, C) slices of the planes
    inp["blk_t0"] = rs.integers(0, NOW, (n, A, C)).astype(np.int32)
    inp["blk_ti"] = rs.integers(0, NOW, (n, A)).astype(np.int32)
    inp["blk_counts"] = rs.integers(0, 3, (n, A)).astype(np.float32)
    inp["blk_zi"], inp["blk_pi"] = f32(n, A), f32(n, A)
    inp["push_j"] = np.array([2, 2, -1, 5, 2, 2, 2, 2, 2, 2, 2], np.int32)
    inp["seed"] = np.array(3, np.int32)
    return inp


_FN_BODY = """
from repro.core import hcu as H
from repro.core import merged as M
from repro.core.params import BCPNNParams
p = BCPNNParams(n_hcu=3, rows=12, cols=8, fanout=3, active_queue=6,
                max_delay=8, out_rate=0.6)
now = jnp.int32(IN["now"])
st = H.HCUState(*[jnp.asarray(IN[f]) for f in H.HCUState._fields])
ring = jnp.asarray(IN["ring"])
A = IN["rows"].shape[1]
blk = lambda f: jnp.asarray(IN[f][:, :A, :])
out = jax.vmap(lambda z, e, pp, t0, g, zi, ti, c, zj, pi, pj:
               M.merged_row_math(z, e, pp, t0, g, zi, ti, c, zj, pi, pj,
                                 now, p))(
    blk("zij"), blk("eij"), blk("pij"), jnp.asarray(IN["blk_t0"]), ring,
    jnp.asarray(IN["blk_zi"]), jnp.asarray(IN["blk_ti"]),
    jnp.asarray(IN["blk_counts"]), st.zj, jnp.asarray(IN["blk_pi"]), st.pj)
for k, v in zip(("z", "e", "p", "w"), out):
    OUT["row_math_" + k] = v
j = jnp.asarray(IN["j"])
app = jnp.asarray(IN["apply"])
col = lambda pl: jax.vmap(lambda x, jj: x[:, jj])(pl, j)
ring_j = jax.vmap(lambda g, jj: g[jj])(ring, j)
out = jax.vmap(lambda z, e, pp, t0, g, zi, ei, pi, ti, pjj, a:
               M.merged_col_math(z, e, pp, t0, g, zi, ei, pi, ti, pjj, a,
                                 now, p))(
    col(st.zij), col(st.eij), col(st.pij), col(st.tij), ring_j, st.zi,
    st.ei, st.pi, st.ti, jax.vmap(lambda v, jj: v[jj])(st.pj, j), app)
for k, v in zip(("z", "e", "p", "w"), out):
    OUT["col_math_" + k] = v
out = jax.vmap(lambda s, g, jj, a: M.column_flush_merged(s, g, jj, now, a, p)
               )(st, ring, j, app)
for f in out._fields:
    OUT["flush_col_" + f] = getattr(out, f)
rows = jnp.asarray(IN["rows"])
out, w, cnt, ru = jax.vmap(lambda s, g, r: M.row_updates_merged(s, g, r, now, p)
                           )(st, ring, rows)
for f in out._fields:
    OUT["rows_" + f] = getattr(out, f)
OUT["rows_w"], OUT["rows_counts"], OUT["rows_u"] = w, cnt, ru
keys = jax.vmap(lambda i: jax.random.fold_in(
    jax.random.PRNGKey(int(IN["seed"])), i))(jnp.arange(3))
out, g2, fired = jax.vmap(lambda s, g, r, k: M.hcu_tick_merged(s, g, r, now,
                                                               k, p)
                          )(st, ring, rows, keys)
for f in out._fields:
    OUT["tick_" + f] = getattr(out, f)
OUT["tick_ring"], OUT["tick_fired"] = g2, fired
out = jax.vmap(lambda s, g: M.flush_merged(s, g, now, p))(st, ring)
for f in out._fields:
    OUT["flushm_" + f] = getattr(out, f)
g = M.init_ring(p)
for t, jj in enumerate(IN["push_j"]):
    g = M.push_ring(g, jnp.int32(jj), jnp.int32(t + 1))
    OUT[f"push_{t}"] = g
"""


@pytest.fixture(scope="module")
def fn_ref():
    inp = _fn_inputs()
    inp["now"] = np.array(NOW, np.int32)
    return inp, run_jax(_FN_BODY, inp, timeout=300.0)


def _state(inp):
    return H.HCUState(*(torch.from_numpy(inp[f].copy())
                        for f in H.HCUState._fields))


def _check_state(got, ref, prefix):
    for f in got._fields:
        _close(getattr(got, f), ref[prefix + f], prefix + f, f)


def test_merged_row_math_matches_jax(fn_ref):
    inp, ref = fn_ref
    st = _state(inp)
    A = inp["rows"].shape[1]
    t = lambda k: torch.from_numpy(inp[k])
    out = M.merged_row_math(
        st.zij[:, :A], st.eij[:, :A], st.pij[:, :A], t("blk_t0"), t("ring"),
        t("blk_zi"), t("blk_ti"), t("blk_counts"), st.zj, t("blk_pi"), st.pj,
        NOW, FN_P)
    for k, v in zip(("z", "e", "p", "w"), out):
        assert torch.isfinite(v).all(), k
        _close(v, ref["row_math_" + k], "row_math_" + k, k + "ij")


def test_merged_col_math_matches_jax(fn_ref):
    inp, ref = fn_ref
    st = _state(inp)
    h = torch.arange(FN_P.n_hcu)
    j = torch.from_numpy(inp["j"]).long()
    col = lambda pl: pl[h, :, j]
    iv = (st.zi, st.ei, st.pi, st.ti)
    out = M.merged_col_math(col(st.zij), col(st.eij), col(st.pij),
                            col(st.tij), torch.from_numpy(inp["ring"])[h, j],
                            *iv, st.pj[h, j], torch.from_numpy(inp["apply"]),
                            torch.tensor(NOW, dtype=torch.int32), FN_P)
    for k, v in zip(("z", "e", "p", "w"), out):
        _close(v, ref["col_math_" + k], "col_math_" + k, k + "ij")


def test_column_flush_merged_matches_jax(fn_ref):
    inp, ref = fn_ref
    got = M.column_flush_merged(_state(inp), torch.from_numpy(inp["ring"]),
                                torch.from_numpy(inp["j"]), NOW,
                                torch.from_numpy(inp["apply"]), FN_P)
    _check_state(got, ref, "flush_col_")


def test_row_updates_merged_matches_jax(fn_ref):
    inp, ref = fn_ref
    st, w, counts, rows_u = M.row_updates_merged(
        _state(inp), torch.from_numpy(inp["ring"]),
        torch.from_numpy(inp["rows"]), torch.tensor(NOW, dtype=torch.int32),
        FN_P)
    _check_state(st, ref, "rows_")
    _close(counts, ref["rows_counts"], "counts")
    _close(rows_u, ref["rows_u"], "rows_u")
    _close(w, ref["rows_w"], "w_rows", "wij")


def test_hcu_tick_merged_matches_jax(fn_ref):
    inp, ref = fn_ref
    keys = rng.fold_in(rng.PRNGKey(int(inp["seed"])), torch.arange(3))
    st, ring, fired = M.hcu_tick_merged(
        _state(inp), torch.from_numpy(inp["ring"]),
        torch.from_numpy(inp["rows"]), torch.tensor(NOW, dtype=torch.int32),
        keys, FN_P)
    _close(fired, ref["tick_fired"], "fired")
    assert (fired >= 0).any(), "no HCU fired: the tail is not exercised"
    _close(ring, ref["tick_ring"], "ring")
    _check_state(st, ref, "tick_")


def test_flush_merged_matches_jax(fn_ref):
    inp, ref = fn_ref
    st = _state(inp)
    got = M.flush_merged(st, torch.from_numpy(inp["ring"]), NOW, FN_P)
    _check_state(got, ref, "flushm_")
    for f in st._fields:               # the input state is left as it was
        np.testing.assert_array_equal(getattr(st, f).numpy(), inp[f])


def test_push_ring_matches_jax(fn_ref):
    inp, ref = fn_ref
    g = M.init_ring(FN_P)
    for t, j in enumerate(inp["push_j"]):
        g = M.push_ring(g, torch.tensor(int(j), dtype=torch.int32),
                        torch.tensor(t + 1, dtype=torch.int32))
        _close(g, ref[f"push_{t}"], f"push {t}")


def test_ring_push_and_overflow():
    """tests/test_merged.py's ring case, batched over two HCUs: the ring
    keeps the last RING_DEPTH times in order; j = -1 pushes nothing."""
    p = tiny_scale(n_hcu=2, rows=32, cols=4)
    ring = M.init_ring(p, 2)
    for t in (3, 5, 9, 11, 15):
        ring = M.push_ring(ring, torch.tensor([2, -1]), torch.tensor(t))
    np.testing.assert_array_equal(ring[0, 2, -4:].numpy(), [5, 9, 11, 15])
    assert int(ring[0, 0, -1]) == M.RING_EMPTY
    assert (ring[1] == M.RING_EMPTY).all()


def test_flush_merged_idempotent():
    p = tiny_scale(n_hcu=1, rows=32, cols=8)
    st = L.batched_state(H.init_hcu_batch(p, 1, "cpu"), 1)
    ring = M.init_ring(p, 1)
    rows = torch.full((1, 4), p.rows, dtype=torch.int32)
    rows[0, 0] = 3
    st, *_ = M.row_updates_merged(st, ring, rows, 2, p)
    ring = M.push_ring(ring, torch.tensor([5]), torch.tensor(4))
    f1 = M.flush_merged(st, ring, 10, p)
    f2 = M.flush_merged(f1, ring, 10, p)
    for a, b in zip(f1, f2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_worst_case_budget_reduction():
    """EQ2 with merged columns: human scale loses the 10,000-cell term."""
    out = M.worst_case_cells_merged(human_scale())
    assert out["classic_cells"] == 36 * 100 + 10_000
    assert out["merged_cells"] == 3600
    assert 3.7 < out["reduction"] < 3.8


# ---------------------------------------------------------------------------
# the head fixtures
# ---------------------------------------------------------------------------

def replay_merged(name, device, tile=None, chunk=128):
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    lay = tile and L.BlockedLayout(MERGED_P.rows, MERGED_P.cols, *tile)
    sim = Simulator(MERGED_P, key=0, device=device, merged=True,
                    cap_fire=MERGED_P.n_hcu, layout=lay, chunk=chunk,
                    **MERGED_FIXTURES[name])
    fired = sim.run(d["ext"]).cpu()
    return d, fired, sim


def assert_merged_contract(d, fired, sim, name):
    assert_contract(fired, sim.state, d, name, sim.layout)
    np.testing.assert_array_equal(sim.state.jring.cpu().numpy(), d["jring"],
                                  err_msg=f"{name}: jring")


@pytest.mark.parametrize("tile", [None, (8, 4), (7, 5)],
                         ids=["flat", "8x4", "7x5"])
@pytest.mark.parametrize("name", list(MERGED_FIXTURES))
def test_merged_fixture_trajectory(name, tile):
    d, fired, sim = replay_merged(name, "cpu", tile)
    assert (fired >= 0).sum() > 0
    assert (d["jring"] != M.RING_EMPTY).any(), "the fixture fills no ring"
    want = "DenseBackend" if name == "merged_dense" else "WorklistBackend"
    assert type(sim.backend).__name__ == want
    assert sim.backend.mode == "merged"
    assert_merged_contract(d, fired, sim, f"{name} tile={tile}")


@pytest.mark.parametrize("name", list(MERGED_FIXTURES))
def test_merged_run_equals_tick_and_run_host(name):
    """The chunked driver (chunks of 7: a remainder), `tick` and
    `run_host` give the same trajectory bit for bit."""
    d, fired, sim = replay_merged(name, "cpu", chunk=7)
    kw = dict(merged=True, cap_fire=MERGED_P.n_hcu, device="cpu",
              **MERGED_FIXTURES[name])
    ticked = Simulator(MERGED_P, key=0, **kw)
    f_tick = torch.stack([ticked.tick(e) for e in torch.from_numpy(d["ext"])])
    host = Simulator(MERGED_P, key=0, **kw)
    ext = torch.from_numpy(d["ext"])
    f_host = host.run_host(lambda t: ext[t - 1], ext.shape[0])
    want = convert.state_to_numpy(sim.state)
    for other, f in ((ticked, f_tick), (host, f_host)):
        np.testing.assert_array_equal(f.numpy(), fired.numpy())
        got = convert.state_to_numpy(other.state)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_chunk_copy_back_pairs_the_rings():
    """The CUDA-graph chunk copies every leaf a tick replaces back into the
    held state (`network._pairs`); a merged tick replaces `jring`, so the
    pairs must hold it."""
    sim = Simulator(MERGED_P, key=0, device="cpu", merged=True, worklist=True)
    held = sim.state
    sim.tick(torch.full((4, 8), MERGED_P.rows, dtype=torch.int32))
    pairs = list(N._pairs(held, sim.state))
    assert any(a is held.jring and b is sim.state.jring for a, b in pairs)
    assert sim.state.jring.data_ptr() != held.jring.data_ptr()


def test_init_network_merged_rings():
    p = tiny_scale(3, 32, 16)
    st = N.init_network(p, rng.PRNGKey(0, "cpu"), merged=True)
    assert st.jring.shape == (3, 16, M.RING_DEPTH)
    assert st.jring.dtype == torch.int32
    assert (st.jring == M.RING_EMPTY).all()
    assert N.init_network(p, rng.PRNGKey(0, "cpu")).jring is None


def test_flushed_leaves_the_held_state():
    """`Simulator.flushed()` of a merged state applies the rings to a copy:
    the held state (its flat-layout view shares storage) is unchanged."""
    d = dict(np.load(FIXTURES / "head_merged_worklist.npz"))
    sim = Simulator(MERGED_P, key=0, device="cpu", merged=True,
                    cap_fire=MERGED_P.n_hcu, worklist=True)
    sim.run(d["ext"][:30])
    before = convert.state_to_numpy(sim.state)
    fl = sim.flushed()
    assert (fl.tij == 30).all() and (fl.ti == 30).all()
    after = convert.state_to_numpy(sim.state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


# ---------------------------------------------------------------------------
# merged against eager (tests/test_merged.py's regimes)
# ---------------------------------------------------------------------------

def _merged_vs_eager(p, key, exts, worklist):
    m = Simulator(p, key=key, device="cpu", merged=True, cap_fire=p.n_hcu,
                  worklist=worklist)
    e = Simulator(p, key=key, device="cpu", eager=True, cap_fire=p.n_hcu)
    n_flush = 0
    for ext in torch.from_numpy(exts):
        ring = m.state.jring
        fm, fe = m.tick(ext), e.tick(ext)
        np.testing.assert_array_equal(fm.numpy(), fe.numpy())
        h = torch.nonzero(fm >= 0)[:, 0]
        n_flush += int((ring[h, fm[h].long(), 0] != M.RING_EMPTY).sum())
    return m, e, n_flush


@pytest.mark.parametrize("worklist", [False, True], ids=["dense", "worklist"])
@pytest.mark.parametrize("seed,n_ticks,out_rate", [(0, 40, 0.3), (7, 20, 0.5)],
                         ids=["seed0", "seed7"])
def test_merged_matches_eager(seed, n_ticks, out_rate, worklist):
    p = BCPNNParams(n_hcu=4, rows=24, cols=16, fanout=4, active_queue=8,
                    max_delay=8, out_rate=out_rate)
    m, e, _ = _merged_vs_eager(p, 0, ext_tensor(p, n_ticks, lam=5.0,
                                                seed=seed), worklist)
    a, b = m.flushed(), e.flushed()
    assert (m.state.jring != M.RING_EMPTY).any(), "must exercise output spikes"
    for name in ["zij", "eij", "pij", "wij", "zi", "pi", "zj", "pj", "h"]:
        np.testing.assert_allclose(
            getattr(a, name).numpy(), getattr(b, name).numpy(), rtol=4e-4,
            atol=4e-4, err_msg=f"merged-mode trace {name} diverged")


@pytest.mark.parametrize("worklist", [False, True], ids=["dense", "worklist"])
def test_merged_exact_under_ring_overflow(worklist):
    """out_rate 1.0 puts more than RING_DEPTH fires on a column between
    row touches: the overflow flush keeps the mode exact."""
    p = BCPNNParams(n_hcu=2, rows=64, cols=8, fanout=2, active_queue=8,
                    max_delay=8, out_rate=1.0)
    m, e, n_flush = _merged_vs_eager(p, 3, ext_tensor(p, 50, lam=2.0, seed=11),
                                     worklist)
    assert n_flush > 0, "the overflow flush was not exercised"
    a, b = m.flushed(), e.flushed()
    for name in ("pij", "eij", "zij"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


# ---------------------------------------------------------------------------
# on a CUDA device
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, (7, 5)], ids=["flat", "7x5"])
@pytest.mark.parametrize("name", list(MERGED_FIXTURES))
def test_merged_fixture_through_graphs_on_cuda(name, tile):
    """The merged fixtures on the card through the CUDA-graph chunks (7:
    graphs of 7 and 4 ticks), under the contract, and bit for bit the
    per-tick driver's; no hand-written kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import bcpnn_update as BU
    for k in BU.launches:
        BU.launches[k] = 0
    d, fired, sim = replay_merged(name, "cuda", tile, chunk=7)
    assert list(sim.graphs.captured) == [7, 4]
    assert_merged_contract(d, fired, sim, f"{name} tile={tile} graphs")
    lay = tile and L.BlockedLayout(MERGED_P.rows, MERGED_P.cols, *tile)
    ticked = Simulator(MERGED_P, key=0, merged=True, cap_fire=MERGED_P.n_hcu,
                       layout=lay, **MERGED_FIXTURES[name])
    f_tick = torch.stack([ticked.tick(e) for e in
                          torch.from_numpy(d["ext"]).cuda()]).cpu()
    assert torch.equal(f_tick, fired)
    got, want = (convert.state_to_numpy(s.state, lay) for s in (sim, ticked))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not any(BU.launches.values()), BU.launches
