"""The plain reference against the port's plain path, tick by tick, at a
tiny size on the CPU: connectivity, fire draws, the sampled HCUs' state and
queues and every HCU's queue counts and drops equal bit for bit, and every
spike the port fires is the reference's own choice (gap 0)."""
import dataclasses

import pytest
import torch

from h100_bench import generator
from h100_bench.reference import judge
from h100_bench.reference import network as RN
from h100_bench.reference import threefry as TF

SEED = 3_000_000_123


@pytest.fixture(scope="module")
def port_run():
    torch.exp(torch.ones(4))          # the first exp of a process on a small tensor
    from repro_torch.core import Simulator
    from repro_torch.core.params import BCPNNParams
    p = BCPNNParams(n_hcu=12, rows=64, cols=16, fanout=8, active_queue=8,
                    max_delay=8, out_rate=0.3)
    key = TF.key_from_seed(SEED)
    sim = Simulator(p, key=key, device="cpu", worklist=True)
    mix = {"lam": 4.0, "width": 8}
    ext = generator.DriveStream(mix, p.n_hcu, p.rows, SEED, "cpu").next(60)
    fired = []
    for k in range(0, 60, 20):           # three chunks, the state carried
        fired.append(sim.run(ext[k:k + 20], chunk=7))
    return p, key, sim, ext, torch.cat(fired).long()


def test_connectivity_and_fire_draws(port_run):
    p, key, sim, _, fired = port_run
    rp = RN.Params.from_dict(dataclasses.asdict(p))
    conn = RN.connectivity(rp, key, block=99)        # odd blocks on purpose
    for a, b in zip(conn, sim.conn):
        assert torch.equal(a, b)
    draws = RN.fire_draws(rp, RN.base_key(key), 1, fired.shape[0], block=7)
    assert torch.equal(draws, fired >= 0)


@pytest.mark.parametrize("sample", [list(range(12)), [1, 5, 7]])
def test_replay_equals_the_port(port_run, sample):
    p, key, sim, ext, fired = port_run
    rp = RN.Params.from_dict(dataclasses.asdict(p))
    conn = RN.connectivity(rp, key)
    cap = rp.fire_cap(None)
    batch = RN.fired_batch(fired, cap)
    s = torch.tensor(sample)
    net = RN.RefNet(rp, s, key, conn)
    readings, _ = judge.replay(net, fired, batch, lambda k: ext[k, s], 0)
    assert readings == {"wta_gap": 0.0, "fire_mismatch": 0, "overflow": 0}
    hc = sim.hcus()
    prog = {f: getattr(hc, f)[s].reshape(-1, p.cols) for f in
            ("zij", "eij", "pij", "wij", "tij")}
    prog.update({f: getattr(hc, f)[s].reshape(-1) for f in
                 ("zi", "ei", "pi", "ti")})
    prog.update({f: getattr(hc, f)[s] for f in ("zj", "ej", "pj", "h")})
    prog["delay_rows"] = sim.state.delay_rows[s]
    prog["delay_count"] = sim.state.delay_count[s]
    assert judge.compare(prog, net.snapshot()) == (0.0, 0)
    counts, d_in, d_fire = RN.queue_counts(rp, conn, fired, 0, cap)
    assert torch.equal(counts.int(), sim.state.delay_count)
    assert (d_in, d_fire) == (int(sim.state.drops_in),
                              int(sim.state.drops_fire))
    assert d_in > 0 and d_fire > 0       # both drop paths were exercised


def test_threefry_blocks_equal_one_draw():
    key = TF.key_from_seed(2**40 + 5)
    for n in (7, 8, 1001):
        whole = TF.bits_block(key, n, 0, n)
        parts = torch.cat([TF.bits_block(key, n, lo, min(n, lo + 3))
                           for lo in range(0, n, 3)])
        assert torch.equal(whole, parts)
        assert torch.equal(whole, TF._hash_small(key, n))


def test_compact_keeps_order_and_counts_past_capacity():
    mask = torch.tensor([0, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    assert RN.compact(mask, 3, 99).tolist() == [1, 2, 4]
    assert RN.compact(mask, 6, 99).tolist() == [1, 2, 4, 5, 99, 99]


def test_overflow_is_counted(port_run):
    p, key, sim, ext, fired = port_run
    rp = RN.Params.from_dict(dataclasses.asdict(p))
    conn = RN.connectivity(rp, key)
    batch = RN.fired_batch(fired, rp.fire_cap(None))
    s = torch.arange(12)
    net = RN.RefNet(rp, s, key, conn)
    net.Kc, net.Mc = 1, 2                # far below what the ticks need
    readings, _ = judge.replay(net, fired, batch, lambda k: ext[k, s], 0)
    assert readings["overflow"] > 0


def program_state(sim, s, C):
    hc = sim.hcus()
    out = {f: getattr(hc, f)[s].reshape(-1, C) for f in
           ("zij", "eij", "pij", "wij", "tij")}
    out.update({f: getattr(hc, f)[s].reshape(-1) for f in ("zi", "ei", "pi", "ti")})
    out.update({f: getattr(hc, f)[s] for f in ("zj", "ej", "pj", "h")})
    out["delay_rows"] = sim.state.delay_rows[s]
    out["delay_count"] = sim.state.delay_count[s]
    return out


def test_tick_by_tick():
    from repro_torch.core import Simulator
    from repro_torch.core.params import BCPNNParams
    p = BCPNNParams(n_hcu=10, rows=48, cols=12, fanout=6, active_queue=6,
                    max_delay=6, out_rate=0.4)
    key = TF.key_from_seed(77)
    sim = Simulator(p, key=key, device="cpu", worklist=True)
    rp = RN.Params.from_dict(dataclasses.asdict(p))
    conn = RN.connectivity(rp, key)
    cap = rp.fire_cap(None)
    s = torch.tensor([0, 3, 4, 9])
    net = RN.RefNet(rp, s, key, conn)
    ext = generator.DriveStream({"lam": 4.0, "width": 8}, p.n_hcu, p.rows, 5,
                                "cpu").next(25)
    for k in range(25):
        fired = sim.tick(ext[k]).long()[None]
        readings, _ = judge.replay(net, fired, RN.fired_batch(fired, cap),
                                   lambda i: ext[k, s], k)
        assert readings == {"wta_gap": 0.0, "fire_mismatch": 0, "overflow": 0}
        assert judge.compare(program_state(sim, s, p.cols),
                             net.snapshot()) == (0.0, 0), k
