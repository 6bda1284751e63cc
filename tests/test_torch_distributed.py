"""The port's sharded runtime (`repro_torch.core.distributed`,
`Simulator.run_sharded`, `launch.mesh`) on the CPU: ranks of a gloo group.

One spawn of 4 ranks serves the whole module (`ranks`, a module-scoped
fixture, `launch.ranks.spawn_ranks`: a file store in a fresh temporary
directory, so concurrent workers never share a rendezvous); the tests
then read its results. Held there:

* `head_sharded_dense.npz` and `head_sharded_worklist.npz` (8 HCUs over 4
  ranks, `default_route_config(p, 2)`; the worklist one in the four
  fused / fused_cols combinations) under the parity contract of
  tests/test_torch_engine.py, and again through `Simulator.run_sharded`
  in two calls;
* a 1-rank group bitwise `network_tick` with ``cap_fire = rc.cap_fire``,
  dense and worklist (the counterpart of tests/test_distributed.py's
  `test_sharded_tick_equals_network_tick_both_backends`);
* under a deliberately binding exchange (cap_route 1), on 4 and 2 ranks:
  `make_dist_tick` x T bitwise `make_dist_run`, ``overlap=False`` bitwise
  ``overlap=True``, and the trajectory and every device's drop counters
  against the JAX package's sharded run (a child with 4 forced host
  devices, tests/torch_jax_ref.py). The JAX package reads a sharded
  counter back as its device 0's; `distributed.drop_counters` gives rank
  0's, on every rank.

The ranks also build the LM meshes (`make_host_mesh`, and
`make_production_mesh`'s refusal on 4 ranks).

In the pytest process: `pack_spikes` / `unpack_spikes` and the route
configurations against the JAX package's (one child) over a grid of
h_local, n_dev and parameters, the spike word's round trip, and
`run_sharded`'s refusals (merged mode, blocked layouts).
"""
import numpy as np
import pytest
import torch

from test_torch_engine import DEFAULT_TOL, FIXTURES, FLOAT_TOL, INT_LEAVES
from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.core import Simulator
from repro_torch.core import distributed as DD
from repro_torch.core import network as N
from repro_torch.core import rng
from repro_torch.core.params import BCPNNParams, human_scale
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.launch import mesh as M
from repro_torch.launch.ranks import spawn_ranks

P8 = tiny_scale(n_hcu=8, rows=64, cols=16)
WORLD = 4
# fixture case -> (fixture, backend flags)
SHARDED_CASES = {
    "dense": ("sharded_dense", dict(worklist=False)),
    **{f"worklist-fused={f},fused_cols={fc}":
       ("sharded_worklist", dict(worklist=True, fused=f, fused_cols=fc))
       for f in (True, False) for fc in (True, False)},
}
BIND_RC = DD.RouteConfig(cap_fire=2, cap_route=1)
BIND_TICKS = 24


@pytest.fixture(autouse=True)
def _flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def assert_contract(fired, got, ref, name):
    """tests/test_torch_engine.py's parity contract on a gathered state
    (``got``: `convert.state_to_numpy` arrays)."""
    np.testing.assert_array_equal(fired, ref["fired"],
                                  err_msg=f"{name}: fired history")
    for k in INT_LEAVES:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name}: {k}")
    for k in ref:
        if k.startswith("hcus_") and k not in INT_LEAVES:
            np.testing.assert_allclose(got[k], ref[k],
                                       **FLOAT_TOL.get(k, DEFAULT_TOL),
                                       err_msg=f"{name}: {k}")


def _bind_ext():
    """Every slot of every HCU driven, every tick (as
    tests/test_route_config.py drives its binding exchange)."""
    g = np.random.default_rng(5)
    return g.integers(0, P8.rows, (BIND_TICKS, P8.n_hcu, 8)).astype(np.int32)


def _one_rank_ext(p, T=15):
    g = np.random.default_rng(3)
    e = np.full((T, p.n_hcu, 8), p.rows, np.int32)
    for t in range(T):
        for h in range(p.n_hcu):
            n = min(8, g.poisson(3))
            e[t, h, :n] = g.integers(0, p.rows, n)
    return e


def _fixture_net(d):
    state = N.init_network(P8, rng.PRNGKey(0, "cpu"))
    return state, convert.conn_from_numpy(d, "cpu")


def _local(mesh, ext):
    h = P8.n_hcu // mesh.size
    return torch.from_numpy(ext[:, mesh.rank * h:(mesh.rank + 1) * h])


def _gathered(mesh, s, f):
    """(fired, state as numpy) of the whole network, and every rank's own
    (drops_in, drops_fire, drops_route)."""
    own = torch.stack([s.drops_in, s.drops_fire, s.drops_route])
    parts = [torch.empty_like(own) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, own, group=mesh.group)
    return dict(fired=DD.gather_fired(mesh, f).numpy(),
                state=convert.state_to_numpy(DD.gather_network(mesh, s)),
                per_rank=torch.stack(parts).numpy(),
                read_back=DD.drop_counters(mesh, s))


def _ranks_main(rank, world):
    """Every sharded case of this module on one rank; returns rank 0's
    results (the others return what only they hold)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    torch.exp(torch.zeros(4))      # warm the first exp on a small tensor
    out = {}
    mesh = M.make_bcpnn_mesh(device="cpu")

    # the head fixtures, through the drivers and through run_sharded
    for case, (name, kw) in SHARDED_CASES.items():
        d = dict(np.load(FIXTURES / f"head_{name}.npz"))
        s, c = DD.shard_network(mesh, *_fixture_net(d))
        fn = DD.make_dist_run(mesh, P8, DD.default_route_config(P8, 2), **kw)
        s, f = fn(s, c, _local(mesh, d["ext"]), chunk=7)
        out[f"fixture/{case}"] = _gathered(mesh, s, f)
    d = dict(np.load(FIXTURES / "head_sharded_worklist.npz"))
    sim = Simulator(P8, key=0, device="cpu", worklist=True, chunk=5)
    rc = DD.default_route_config(P8, 2)
    f1 = sim.run_sharded(d["ext"][:13], rc=rc)
    shard_rows = sim.state.hcus.zij.shape[0]
    f2 = sim.run_sharded(d["ext"][13:], rc=rc)
    drops = sim.drops()
    sim._unshard()
    out["run_sharded"] = dict(fired=torch.cat([f1, f2]).numpy(),
                              state=convert.state_to_numpy(sim.state),
                              shard_rows=shard_rows, drops=drops)

    # a binding exchange on 4 and 2 ranks: drivers, overlap, drops
    ext = _bind_ext()
    for ndev in (4, 2):
        m = mesh if ndev == world else M.make_bcpnn_mesh(ndev, device="cpu")
        if m is None:
            continue
        state, conn = N.init_network(P8, rng.PRNGKey(0, "cpu")), \
            N.make_connectivity(P8, rng.fold_in(rng.PRNGKey(0, "cpu"), 1))
        e = _local(m, ext)
        for wl in (False, True):
            runs = {}
            for how in ("run", "tick", "sequential"):
                s, c = DD.shard_network(m, state, conn)
                if how == "tick":
                    tick = DD.make_dist_tick(m, P8, BIND_RC, worklist=wl)
                    fs = []
                    for k in range(BIND_TICKS):
                        s, ft = tick(s, c, e[k])
                        fs.append(ft)
                    f = torch.stack(fs)
                else:
                    fn = DD.make_dist_run(m, P8, BIND_RC, worklist=wl,
                                          overlap=how == "run")
                    s, f = fn(s, c, e)
                runs[how] = _gathered(m, s, f)
            out[f"bind/{ndev}/{'worklist' if wl else 'dense'}"] = runs

    # a 1-rank group against the local tick, both backends
    p4 = tiny_scale(n_hcu=4, rows=64, cols=16)
    m1 = M.make_bcpnn_mesh(1, device="cpu")
    if m1 is not None:
        rc = DD.default_route_config(p4, p4.n_hcu)
        key = rng.PRNGKey(0, "cpu")
        conn = N.make_connectivity(p4, rng.fold_in(key, 1))
        for wl in (False, True):
            tick = DD.make_dist_tick(m1, p4, rc, worklist=wl)
            s_d, c_d = DD.shard_network(m1, N.init_network(p4, key), conn)
            s_s = N.init_network(p4, key)
            fd, fs = [], []
            for e in torch.from_numpy(_one_rank_ext(p4)):
                s_d, f = tick(s_d, c_d, e)
                fd.append(f)
                s_s, f = N.network_tick(s_s, conn, e, p4,
                                        cap_fire=rc.cap_fire, worklist=wl)
                fs.append(f)
            out[f"one_rank/{'worklist' if wl else 'dense'}"] = dict(
                dist=(torch.stack(fd).numpy(), convert.state_to_numpy(s_d)),
                local=(torch.stack(fs).numpy(), convert.state_to_numpy(s_s)))

    # the LM meshes (the LM sharding itself: tests/test_torch_lm_sharded.py)
    lm = {}
    for tag, shape in (("host", None), ("square", (2, 2))):
        m = M.make_host_mesh(shape, device="cpu")
        lm[tag] = (tuple(m.shape), tuple(m.mesh_dim_names), m.device_type)
    for tag, kw in (("production", {}), ("multi_pod", dict(multi_pod=True))):
        try:
            M.make_production_mesh(device="cpu", **kw)
            lm[tag] = None
        except ValueError as e:
            lm[tag] = str(e)
    out["lm_meshes"] = lm
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_ranks_main, WORLD, timeout_s=240)


JAX_BIND = """
from repro.core import init_network, make_connectivity
from repro.core import distributed as DD
from repro.core.params import test_scale
p = test_scale(n_hcu=8, rows=64, cols=16)
key = jax.random.PRNGKey(0)
conn = make_connectivity(p, jax.random.fold_in(key, 1))
rc = DD.RouteConfig(cap_fire=2, cap_route=1)
for ndev in (4, 2):
    mesh = jax.make_mesh((ndev,), ("hcu",), devices=jax.devices()[:ndev])
    for wl in (False, True):
        s, c = DD.shard_network(mesh, init_network(p, key), conn)
        s, f = DD.make_dist_run(mesh, p, rc, worklist=wl)(
            s, c, jnp.asarray(IN["ext"]))
        tag = f"{ndev}_{int(wl)}_"
        OUT[tag + "fired"] = np.asarray(f)
        for name in s.hcus._fields:
            OUT[tag + "hcus_" + name] = np.asarray(getattr(s.hcus, name))
        for name in ("delay_rows", "delay_count", "t", "drops_in",
                     "drops_fire", "drops_route"):
            x = getattr(s, name)
            OUT[tag + name] = np.asarray(x)
            if x.ndim == 0:
                OUT[tag + name + "_devices"] = np.array(
                    [int(np.asarray(sh.data)) for sh in
                     sorted(x.addressable_shards, key=lambda h: h.device.id)])
"""


@pytest.fixture(scope="module")
def jax_bind():
    return run_jax(JAX_BIND, {"ext": _bind_ext()}, timeout=240, n_devices=4)


# -- the head fixtures -------------------------------------------------------

@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_fixture_on_four_ranks(ranks, case):
    name, _ = SHARDED_CASES[case]
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    got = ranks[0][f"fixture/{case}"]
    assert (got["fired"] >= 0).sum() > 0
    assert_contract(got["fired"], got["state"], d, f"{case} on 4 ranks")
    # rank-local counters; the fixture holds what JAX reads back (device 0's)
    assert got["read_back"] == {"in": int(d["drops_in"]),
                                "fire": int(d["drops_fire"]), "route": 0}


def test_run_sharded_matches_fixture(ranks):
    d = dict(np.load(FIXTURES / "head_sharded_worklist.npz"))
    got = ranks[0]["run_sharded"]
    # the rank kept only its two HCUs
    assert got["shard_rows"] == 2 * P8.rows
    assert_contract(got["fired"], got["state"], d, "run_sharded")
    assert got["drops"] == {"in": 0, "fire": 0, "route": 0}


# -- a binding exchange: drivers, overlap, drop counters ---------------------

BIND_IDS = [f"{n}ranks-{b}" for n in (4, 2) for b in ("dense", "worklist")]


def _bind(ranks, case):
    n, b = case.split("ranks-")
    return ranks[0][f"bind/{n}/{b}"], int(n), b == "worklist"


def _same(a, b, what):
    np.testing.assert_array_equal(a["fired"], b["fired"], err_msg=what)
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(a["per_rank"], b["per_rank"], err_msg=what)


@pytest.mark.parametrize("case", BIND_IDS)
def test_dist_tick_equals_dist_run(ranks, case):
    runs, _, _ = _bind(ranks, case)
    _same(runs["tick"], runs["run"], f"{case}: tick x T vs run")


@pytest.mark.parametrize("case", BIND_IDS)
def test_overlap_equals_sequential_exchange(ranks, case):
    runs, _, _ = _bind(ranks, case)
    assert runs["run"]["per_rank"][:, 2].sum() > 0, "cap_route never bound"
    _same(runs["sequential"], runs["run"], f"{case}: overlap off vs on")


@pytest.mark.parametrize("case", BIND_IDS)
def test_binding_exchange_matches_jax(ranks, jax_bind, case):
    """The live JAX sharded run under cap_route 1: the trajectory under
    the contract, every device's own drop counters exactly, and the JAX
    read-back (device 0's) equal to rank 0's."""
    runs, n, wl = _bind(ranks, case)
    got = runs["run"]
    tag = f"{n}_{int(wl)}_"
    ref = {k[len(tag):]: v for k, v in jax_bind.items() if k.startswith(tag)}
    assert_contract(got["fired"], got["state"], ref, case)
    for i, name in enumerate(("drops_in", "drops_fire", "drops_route")):
        np.testing.assert_array_equal(got["per_rank"][:, i],
                                      ref[name + "_devices"], err_msg=name)
        assert got["read_back"][name[len("drops_"):]] == int(ref[name])


# -- a 1-rank group is the local tick ----------------------------------------

@pytest.mark.parametrize("backend", ["dense", "worklist"])
def test_one_rank_equals_network_tick(ranks, backend):
    got = ranks[0][f"one_rank/{backend}"]
    (fd, sd), (fs, ss) = got["dist"], got["local"]
    assert (fs >= 0).sum() > 0
    np.testing.assert_array_equal(fd, fs)
    for k in ss:
        np.testing.assert_array_equal(sd[k], ss[k], err_msg=k)


# -- pure functions against the JAX package ----------------------------------

GRID = [("test8", P8, (1, 2, 8)), ("human", human_scale(256), (1, 64, 256)),
        ("default", BCPNNParams(), (1, 4, 16)),
        ("rodent", BCPNNParams(n_hcu=32, rows=1200, cols=70, fanout=100,
                               out_rate=0.3), (1, 8, 32))]
N_DEV = (None, 1, 2, 4, 16, 64)
N_WORDS = 512


def _spikes(p, h_local, seed):
    g = np.random.default_rng(seed)
    return dict(loc=g.integers(0, h_local, N_WORDS).astype(np.int32),
                row=g.integers(0, p.rows + 1, N_WORDS).astype(np.int32),
                dly=g.integers(1, p.max_delay, N_WORDS).astype(np.int32),
                valid=g.random(N_WORDS) < 0.7)


@pytest.fixture(scope="module")
def jax_pure():
    inputs, cases = {}, []
    for gi, (name, p, hs) in enumerate(GRID):
        for h in hs:
            for k, v in _spikes(p, h, gi * 1000 + h).items():
                inputs[f"{name}_{h}_{k}"] = v
            cases.append((name, h))
    params = {name: dict(rows=p.rows, max_delay=p.max_delay, fanout=p.fanout,
                         out_rate=p.out_rate, n_hcu=p.n_hcu, cols=p.cols)
              for name, p, _ in GRID}
    body = f"""
from repro.core.params import BCPNNParams
from repro.core import distributed as DD
PARAMS = {params!r}
for name, h in {cases!r}:
    p = BCPNNParams(**PARAMS[name])
    t = f"{{name}}_{{h}}_"
    w = DD.pack_spikes(jnp.asarray(IN[t + "loc"]), jnp.asarray(IN[t + "row"]),
                       jnp.asarray(IN[t + "dly"]), jnp.asarray(IN[t + "valid"]),
                       p, h)
    OUT[t + "words"] = np.asarray(w)
    for k, v in zip(("loc", "row", "dly", "valid"),
                    DD.unpack_spikes(w, p, h)):
        OUT[t + "un_" + k] = np.asarray(v)
    OUT[t + "lossless"] = np.asarray(DD.lossless_route_config(p, h)[:2])
    for nd in {N_DEV!r}:
        OUT[t + f"default_{{nd}}"] = np.asarray(
            DD.default_route_config(p, h, nd)[:2])
"""
    return run_jax(body, inputs)


@pytest.mark.parametrize("name", [g[0] for g in GRID])
def test_pack_and_unpack_match_jax(jax_pure, name):
    p, hs = next((p, hs) for n, p, hs in GRID if n == name)
    for h in hs:
        s = {k: torch.from_numpy(v) for k, v in
             _spikes(p, h, [g[0] for g in GRID].index(name) * 1000 + h)
             .items()}
        t = f"{name}_{h}_"
        w = DD.pack_spikes(s["loc"], s["row"], s["dly"], s["valid"], p, h)
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy(), jax_pure[t + "words"])
        for k, v in zip(("loc", "row", "dly", "valid"),
                        DD.unpack_spikes(w, p, h)):
            np.testing.assert_array_equal(v.numpy(), jax_pure[t + "un_" + k])
        # the round trip: every field of a valid word comes back
        v = s["valid"]
        back = DD.unpack_spikes(w, p, h)
        for k, b in zip(("loc", "row", "dly"), back[:3]):
            np.testing.assert_array_equal(b[v].numpy(), s[k][v].numpy())
        np.testing.assert_array_equal(back[3].numpy(), v.numpy())


@pytest.mark.parametrize("name", [g[0] for g in GRID])
def test_route_configs_match_jax(jax_pure, name):
    p, hs = next((p, hs) for n, p, hs in GRID if n == name)
    for h in hs:
        t = f"{name}_{h}_"
        assert tuple(DD.lossless_route_config(p, h)[:2]) == \
            tuple(jax_pure[t + "lossless"])
        for nd in N_DEV:
            rc = DD.default_route_config(p, h, nd)
            assert tuple(rc[:2]) == tuple(jax_pure[t + f"default_{nd}"]), nd
            assert rc.pack


def test_spike_word_overflow_raises():
    p = BCPNNParams(n_hcu=1 << 20, rows=(1 << 20) - 1, max_delay=16)
    with pytest.raises(ValueError, match="spike word overflow"):
        DD.pack_spikes(torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.bool), p, 1 << 12)


@pytest.mark.parametrize("kw,match", [
    (dict(merged=True), "merged mode"),
    (dict(worklist=True, layout="blocked"), "blocked plane layouts")],
    ids=["merged", "blocked"])
def test_run_sharded_refuses_what_it_cannot_shard(kw, match):
    sim = Simulator(P8, key=0, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=match):
        sim.run_sharded(np.full((1, 8, 8), P8.rows, np.int32))


def test_lm_meshes_wait_for_item_8(ranks):
    """The LM meshes on the 4 ranks: `make_host_mesh`'s default shape
    (world, 1) and a (2, 2), with the JAX package's axis names; the
    production meshes need more ranks than the group has and say how
    many."""
    lm = ranks[0]["lm_meshes"]
    assert lm["host"] == ((WORLD, 1), ("data", "model"), "cpu")
    assert lm["square"] == ((2, 2), ("data", "model"), "cpu")
    assert lm["production"] == ("a (16, 16) mesh needs 256 ranks, the "
                                "process group has 4")
    assert lm["multi_pod"] == ("a (2, 16, 16) mesh needs 512 ranks, the "
                               "process group has 4")


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cuda_fixture_ranks(rank, world):
    """The head fixtures' cases on gloo ranks sharing cuda:0."""
    torch.cuda.set_device(0)
    mesh = M.make_bcpnn_mesh(device=torch.device("cuda", 0))
    out = {}
    for case, (name, kw) in SHARDED_CASES.items():
        d = dict(np.load(FIXTURES / f"head_{name}.npz"))
        state = N.init_network(P8, rng.PRNGKey(0, mesh.device))
        s, c = DD.shard_network(mesh, state,
                                convert.conn_from_numpy(d, mesh.device))
        fn = DD.make_dist_run(mesh, P8, DD.default_route_config(P8, 2), **kw)
        s, f = fn(s, c, _local(mesh, d["ext"]))
        out[case] = (DD.gather_fired(mesh, f).cpu().numpy(),
                     convert.state_to_numpy(DD.gather_network(mesh, s)))
    return out


def _nccl_rank(rank, world):
    """run_sharded on one NCCL rank through CUDA-graph chunks of 7 against
    the local run at the lossless exchange's fired batch."""
    ext = _one_rank_ext(P8, T=19)
    sim = Simulator(P8, key=0, worklist=True, chunk=7)
    fired = sim.run_sharded(ext, rc=DD.lossless_route_config(P8, P8.n_hcu))
    ref = Simulator(P8, key=0, worklist=True, cap_fire=P8.n_hcu)
    want = ref.run(ext)
    same = torch.equal(fired, want) and all(
        torch.equal(getattr(sim.state.hcus, f), getattr(ref.state.hcus, f))
        for f in ref.state.hcus._fields)
    return dict(same=same, captured=sorted(sim.graphs.captured),
                spikes=int((want >= 0).sum()))


@pytest.fixture(scope="module")
def cuda_ranks():
    _cuda()
    return spawn_ranks(_cuda_fixture_ranks, WORLD, timeout_s=240)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_fixture_on_cuda(cuda_ranks, case):
    name, _ = SHARDED_CASES[case]
    d = dict(np.load(FIXTURES / f"head_{name}.npz"))
    fired, got = cuda_ranks[0][case]
    assert_contract(fired, got, d, f"{case} on 4 ranks on the card")


@pytest.mark.cuda
def test_one_nccl_rank_through_graphs_equals_local_run_on_cuda():
    _cuda()
    got = spawn_ranks(_nccl_rank, 1, backend="nccl", timeout_s=240)[0]
    assert got["spikes"] > 0
    assert got["same"]
    assert got["captured"] == [5, 7]


def _nccl_memory_rank(rank, world):
    """The device memory allocated before a Simulator, after its
    run_sharded through CUDA-graph chunks and ``del``, and after the
    process group is gone."""
    import gc
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sim = Simulator(P8, key=0, worklist=True, chunk=7)
    held = torch.cuda.memory_allocated()
    sim.run_sharded(_one_rank_ext(P8, T=19),
                    rc=DD.lossless_route_config(P8, P8.n_hcu))
    del sim
    gc.collect()
    torch.cuda.synchronize()
    return dict(before=before, held=held,
                after=torch.cuda.memory_allocated())


@pytest.mark.cuda
def test_run_sharded_frees_its_memory_on_cuda():
    """A 1-rank NCCL run_sharded leaves nothing allocated once its
    Simulator is gone: its state, connectivity, graphs and driver."""
    _cuda()
    got = spawn_ranks(_nccl_memory_rank, 1, backend="nccl", timeout_s=240)[0]
    assert got["held"] > got["before"]
    assert got["after"] == got["before"], got


def _touch_rank(rank, world, t):
    """Read a tensor the parent shared through CUDA IPC."""
    return float(t.sum())


@pytest.mark.cuda
def test_cuda_tensors_sent_to_ranks_are_freed():
    """A CUDA tensor the parent passes to spawned ranks (CUDA IPC) is
    freed in the parent once the ranks have exited and it is dropped."""
    _cuda()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = torch.ones(1 << 22, device="cuda")
    got = spawn_ranks(_touch_rank, 2, backend="gloo", args=(t,),
                      timeout_s=120)
    assert got == {0: float(1 << 22), 1: float(1 << 22)}
    del t
    torch.cuda.ipc_collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
