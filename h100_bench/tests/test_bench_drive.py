"""The drive law: the same seed draws the same chunks, and at lambda 4 an
HCU receives about 14 rows a tick (10 of its inputs' spikes, min(Poisson
4, 8) of the drive)."""
import json

import torch

from h100_bench import generator
from h100_bench.drivers import sim as D
from h100_bench.reference import network as RN
from h100_bench.reference import threefry as TF
from h100_bench.tests.conftest import BENCH

MIX = json.loads((BENCH / "traffic" / "drive4.json").read_text())


def test_drive_repeats_per_seed():
    a = generator.DriveStream(MIX, 50, 1200, 2**31 + 7, "cpu")
    b = generator.DriveStream(MIX, 50, 1200, 2**31 + 7, "cpu")
    c = generator.DriveStream(MIX, 50, 1200, 2**31 + 8, "cpu")
    for _ in range(2):
        x, y, z = a.next(16), b.next(16), c.next(16)
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert x.dtype == torch.int32 and x.shape == (16, 50, MIX["width"])


def test_drive_law():
    s = generator.DriveStream(MIX, 1000, 1200, 5, "cpu")
    x = s.next(64)
    live = x < 1200
    assert bool((live[..., :-1] | ~live[..., 1:]).all())   # live slots first
    per = live.sum(-1).double()
    assert abs(per.mean().item() - 3.97) < 0.05
    assert int(per.max()) <= MIX["width"]


def test_about_14_rows_an_hcu_a_tick():
    p = RN.Params(n_hcu=200, rows=10_000, cols=20, fanout=100)
    key = TF.key_from_seed(11)
    conn = RN.connectivity(p, key)
    T = 40
    g = torch.Generator().manual_seed(3)
    fired = torch.where(torch.rand((T, p.n_hcu), generator=g) < p.out_rate,
                        torch.randint(0, p.cols, (T, p.n_hcu), generator=g), -1)
    ext = generator.DriveStream(MIX, p.n_hcu, p.rows, 4, "cpu").next(T)
    nv = D.delivered_rows(p, conn, fired, ext[20:], 21, T)
    rows = sum(nv) / len(nv) / p.n_hcu
    assert 13.0 < rows < 15.0, rows
