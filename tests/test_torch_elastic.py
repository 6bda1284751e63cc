"""Elastic re-placement and the degraded-mode sharded runtime of the port
(`repro_torch.runtime.remesh`, `remesh_network`, `ElasticRunner`), on
ranks of a gloo group on the CPU: the counterparts of
tests/test_elastic.py.

One spawn of 4 ranks serves the module (`ranks`,
`launch.ranks.spawn_ranks`). Held there:

* remesh round trips: the global state placed on 4 ranks, gathered,
  placed on 2, gathered again: every leaf bit for bit;
* mesh-size invariance: under `lossless_route_config` the sharded
  trajectory on 2 and 4 ranks is bitwise the 1-rank one, dense and
  worklist, with drops_route 0, and the split exchange (``overlap``) is
  bitwise the sequential one at every count; a checkpoint of the 4-rank
  state at tick 10, restored onto 2 ranks, finishes on the 1-rank
  trajectory;
* `ElasticRunner`: an injected loss of 2 of 4 ranks (restore, remesh onto
  the survivors, replay), a crash replayed from an older checkpoint, and
  a graceful shrink-then-regrow each reproduce the uninterrupted local
  run (`Simulator.run` at cap_fire H) bitwise, fired history and every
  plane; the lost ranks raise `DeviceLoss`.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import restore_network, save
from repro_torch.core import Simulator
from repro_torch.core import distributed as DD
from repro_torch.core import network as N
from repro_torch.core import rng
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.launch import mesh as M
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.runtime import (DeviceLoss, ElasticRunner, InjectedFailure,
                                 remesh, remesh_network)
from repro_torch.runtime.resilience import _ckpt_tree, _shape_template

P8 = tiny_scale(n_hcu=8, rows=64, cols=16)
WORLD = 4
T, CH = 24, 4


def _frames(seed, T):
    g = np.random.default_rng(seed)
    out = np.full((T, P8.n_hcu, 8), P8.rows, np.int32)
    for t in range(T):
        for h in range(P8.n_hcu):
            n = min(8, g.poisson(3))
            out[t, h, :n] = g.integers(0, P8.rows, n)
    return out


def _net():
    key = rng.PRNGKey(0, "cpu")
    return N.init_network(P8, key), N.make_connectivity(P8, rng.fold_in(key, 1))


def _np(state):
    return convert.state_to_numpy(state)


def _run(mesh, ext, wl, overlap=True, state=None):
    """The lossless sharded run of ``ext`` on ``mesh`` from ``state`` (the
    initial network by default); returns (fired, gathered state)."""
    st, conn = _net()
    s, c = DD.shard_network(mesh, st if state is None else state, conn)
    rc = DD.lossless_route_config(P8, P8.n_hcu // mesh.size)
    h = P8.n_hcu // mesh.size
    fn = DD.make_dist_run(mesh, P8, rc, worklist=wl, overlap=overlap)
    s, f = fn(s, c, torch.from_numpy(ext[:, mesh.rank * h:
                                         (mesh.rank + 1) * h]))
    return DD.gather_fired(mesh, f), DD.gather_network(mesh, s)


def _ranks_main(rank, world, ckpt):
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    torch.exp(torch.zeros(4))      # warm the first exp on a small tensor
    out = {}
    m4 = M.make_bcpnn_mesh(device="cpu")
    m2 = M.make_bcpnn_mesh(2, device="cpu")
    m1 = M.make_bcpnn_mesh(1, device="cpu")
    specs = DD._shard_specs()[0]

    # remesh round trip: 4 ranks, gathered, 2 ranks, gathered
    host = N.tree_map(lambda a: a.clone(), _net()[0])
    s4 = remesh(host, m4, specs)
    out["slice4"] = s4.hcus.zij.shape[0]
    g4 = DD.gather_network(m4, s4)
    if m2 is not None:
        s2, c2 = remesh_network(g4, _net()[1], m2)
        out["slice2"] = (s2.hcus.zij.shape[0], c2.dest_hcu.shape[0])
        out["remesh"] = (_np(host), _np(g4), _np(DD.gather_network(m2, s2)))

    # the same trajectory on 1, 2 and 4 ranks, split or sequential exchange
    ext = _frames(7, 20)
    for wl in (False, True):
        b = "worklist" if wl else "dense"
        for n, m in ((4, m4), (2, m2), (1, m1)):
            if m is None:
                continue
            for overlap in (True, False):
                f, s = _run(m, ext, wl, overlap)
                out[f"inv/{b}/{n}/{overlap}"] = (f.numpy(), _np(s))

    # checkpoint on 4 ranks at tick 10, restore onto 2, finish
    f_a, s_a = _run(m4, ext[:10], True)
    if rank == 0:
        save(ckpt, 10, _ckpt_tree(s_a))
    torch.distributed.barrier()
    if m2 is not None:
        restored = restore_network(ckpt, 10, _shape_template(_net()[0]))
        f_b, s_b = _run(m2, ext[10:], True, state=restored)
        out["xmesh"] = (torch.cat([f_a, f_b]).numpy(), _np(s_b))

    # ElasticRunner: device loss, crash, rescale
    ext = _frames(11, T)
    ref = Simulator(P8, key=0, cap_fire=P8.n_hcu, device="cpu")
    out["ref"] = (ref.run(ext).numpy(), _np(ref.state))
    # (the loss last: the lost ranks leave the group's later groups)
    for case, kw in (
            ("crash", dict(fail_injector=lambda c, f={3: True}: f.pop(c, 0),
                           save_every=2)),
            ("rescale", dict(rescale=lambda c: {1: 2, 3: 4}.get(c))),
            ("loss", dict(fail_injector=lambda c, f={3: 2}: f.pop(c, 0)))):
        sim = Simulator(P8, key=0, device="cpu")
        runner = ElasticRunner(sim, f"{ckpt}/{case}", chunk_ticks=CH, **kw)
        try:
            fired, health = runner.run(ext)
        except DeviceLoss:
            out[case] = "lost"
            continue
        out[case] = dict(fired=fired, health=health, state=_np(sim.state),
                         restarts=runner.restarts,
                         recoveries=runner.recoveries,
                         devices=list(runner.devices))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("elastic_ckpt"))
    return spawn_ranks(_ranks_main, WORLD, args=(ckpt,), timeout_s=240)


def _equal(a, b, what):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def test_elastic_device_count():
    assert M.elastic_device_count(16, 4) == 4
    assert M.elastic_device_count(16, 3) == 2   # rodent16 losing 1 of 4
    assert M.elastic_device_count(16, 1) == 1
    assert M.elastic_device_count(12, 5) == 4
    assert M.elastic_device_count(7, 3) == 1
    assert M.elastic_device_count(8, 100) == 8


def test_device_loss_is_injected_failure():
    e = DeviceLoss(2)
    assert isinstance(e, InjectedFailure)
    assert e.n_lost == 2


def test_remesh_round_trip_is_bitwise(ranks):
    host, g4, g2 = ranks[0]["remesh"]
    assert ranks[0]["slice4"] == 2 * P8.rows
    assert ranks[1]["slice2"] == (4 * P8.rows, 4)
    _equal(g4, host, "4 ranks")
    _equal(g2, host, "4 -> 2 ranks")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", ["dense", "worklist"])
def test_mesh_size_invariance(ranks, backend, n):
    f1, s1 = ranks[0][f"inv/{backend}/1/True"]
    fn, sn = ranks[0][f"inv/{backend}/{n}/True"]
    assert (f1 >= 0).sum() > 0
    np.testing.assert_array_equal(fn, f1)
    _equal(sn, s1, f"{backend} 1 vs {n} ranks")
    assert int(sn["drops_route"]) == 0


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("backend", ["dense", "worklist"])
def test_overlap_is_bitwise_sequential(ranks, backend, n):
    fo, so = ranks[0][f"inv/{backend}/{n}/True"]
    fs, ss = ranks[0][f"inv/{backend}/{n}/False"]
    np.testing.assert_array_equal(fs, fo)
    _equal(ss, so, f"{backend} on {n} ranks")


def test_restore_across_mesh_sizes(ranks):
    f, s = ranks[0]["xmesh"]
    f1, s1 = ranks[0]["inv/worklist/1/True"]
    np.testing.assert_array_equal(f, f1)
    for k in s1:
        if k.startswith("hcus_"):
            np.testing.assert_array_equal(s[k], s1[k], err_msg=k)


def _same_as_ref(ranks, got, what):
    f_ref, s_ref = ranks[0]["ref"]
    assert (f_ref >= 0).sum() > 0
    np.testing.assert_array_equal(got["fired"], f_ref, err_msg=what)
    for k in s_ref:
        if k.startswith("hcus_"):
            np.testing.assert_array_equal(got["state"][k], s_ref[k],
                                          err_msg=f"{what}: {k}")


def test_elastic_runner_device_loss(ranks):
    """Chunk 3 loses 2 of 4 ranks (a self-clearing injector: the replay of
    chunk 3 must not lose more): the survivors restore, remesh onto 2
    ranks and replay."""
    assert ranks[2]["loss"] == ranks[3]["loss"] == "lost"
    for r in (0, 1):
        got = ranks[r]["loss"]
        _same_as_ref(ranks, got, f"rank {r}")
        assert got["restarts"] == 1 and len(got["recoveries"]) == 1
        rec = got["recoveries"][0]
        assert rec["kind"] == "device-loss" and rec["devices"] == 2
        assert rec["restored_tick"] == 3 * CH and rec["recovery_s"] >= 0.0
        assert got["devices"] == [0, 1]
        health = got["health"]
        assert health["restarts"] == 1
        assert set(health["classes"]) == {"in", "fire", "route"}
        assert health["drops"]["route"] == 0
        assert health["status"] in ("ok", "deadline-missed")


def test_elastic_runner_crash_replays_older_checkpoint(ranks):
    for r in range(WORLD):
        got = ranks[r]["crash"]
        _same_as_ref(ranks, got, f"rank {r}")
        assert got["restarts"] == 1
        rec = got["recoveries"][0]
        assert rec["kind"] == "crash" and rec["devices"] == WORLD
        assert rec["restored_tick"] == 2 * CH   # save_every=2: after chunk 1


def test_elastic_runner_rescale(ranks):
    """Shrink to 2 ranks at chunk 1, regrow to 4 at chunk 3: pure data
    movement, no restore."""
    for r in range(WORLD):
        got = ranks[r]["rescale"]
        _same_as_ref(ranks, got, f"rank {r}")
        assert got["restarts"] == 0 and got["recoveries"] == []


@pytest.mark.parametrize("kw,match", [
    (dict(merged=True), "merged mode"),
    (dict(worklist=True, layout="blocked"), "blocked plane layouts")],
    ids=["merged", "blocked"])
def test_elastic_runner_refuses_what_it_cannot_shard(tmp_path, kw, match):
    sim = Simulator(P8, key=0, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=match):
        ElasticRunner(sim, str(tmp_path))
