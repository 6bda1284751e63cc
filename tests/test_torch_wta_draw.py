"""The tick's soft winner-take-all (`hcu.wta_draw`): per-HCU keys, fire
draw, Gumbel noise, drive, support and argmax.

* On the CPU: a word-level mirror of the kernel's derivation (numpy
  uint32 Threefry: the two fold-ins, the split as two blocks, the fire
  word, the noise words paired c with c + ceil(C/2) and an odd C's last
  count with 0) against `rng.fold_in` / `split` / `random_bits` /
  `uniform`, bit for bit, over C in {7, 16, 70, 100}, several gid_base and
  t near 2^31; the plain op (`hcu.wta_draw_plain`, through the one entry
  `hcu.wta_draw`) against the tick's former path (`rng.fold_in` twice in
  the engine, then `split`, `uniform`, `categorical`), bit for bit, with
  the keys as a `TickKeys`, as per-HCU keys and with a given drive; the
  drive in `torch.sum`'s order on the CPU, and the slot order the kernel
  keeps (`hcu.slot_order_drive`) unchanged by skipping zero-count slots.
* On a CUDA device (skipped without one): the kernel
  (`kernels.wta_draw`) against the plain op on the card (its drive in
  slot order there), bit for bit for
  h' and fired, in all three key and drive modes, at odd and even C up
  to the rodent and human widths and a temperature that is no power of
  two; then a CUDA-graph replay of whole ticks against the per-tick
  driver and against the plain op in its place, the launch counter
  counting each captured tick once and the device trace showing the
  kernel once a replayed tick.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Simulator
from repro_torch.core import hcu as H
from repro_torch.core import rng
from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import bias
from repro_torch.kernels import wta_draw as WD

M32 = np.uint64(0xFFFFFFFF)
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = np.float32(np.finfo(np.float32).tiny)
COLS = [7, 16, 70, 100]
GIDS = [0, 256, 2**31 - 3, 5 * 2**32 + 11]
TIMES = [1, 2**31 - 2, 2**31 - 1]


# --------------------------------------------------------------------------
# a word-level mirror of csrc/wta_draw.cu's derivation
# --------------------------------------------------------------------------

def _tf(k1, k2, x1, x2):
    """Threefry-2x32 on uint64 arrays of uint32 words, as the kernel
    writes it (x1, x2 in, out)."""
    k1, k2, x1, x2 = (np.asarray(v, np.uint64) & M32 for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    x1, x2 = (x1 + k1) & M32, (x2 + k2) & M32
    for i in range(5):
        for r in ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = (((x2 << np.uint64(r)) | (x2 >> np.uint64(32 - r))) & M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & M32
    return x1, x2


def _unit(words):
    """jax.random.uniform's float32 in [0, 1) from 32-bit words."""
    bits = ((words >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


def _mirror(base_key, t, gid_base, n, C):
    """Per HCU: its key (n, 2), fire key (n, 2), noise key (n, 2), fire
    word (n,) and noise words (n, C), derived as the kernel derives them."""
    h = np.arange(n, dtype=np.uint64)
    b = np.asarray(base_key, np.int64).astype(np.uint64) & M32
    a1, a2 = _tf(b[0], b[1], 0, np.uint64(t & 0xFFFFFFFF))
    k1, k2 = _tf(a1, a2, np.zeros(n, np.uint64),
                 (np.uint64(gid_base & 0xFFFFFFFF) + h) & M32)
    f1, n1 = _tf(k1, k2, 0, 2)
    f2, n2 = _tf(k1, k2, 1, 3)
    fire_word, _ = _tf(f1, f2, 0, 0)
    half = (C + 1) // 2
    i = np.arange(half, dtype=np.uint64)
    x2 = np.where(i + np.uint64(half) < C, i + np.uint64(half), 0)
    y1, y2 = _tf(n1[:, None], n2[:, None], i[None, :], x2[None, :])
    noise = np.concatenate([y1, y2], axis=1)[:, :C]
    return (np.stack([k1, k2], -1), np.stack([f1, f2], -1),
            np.stack([n1, n2], -1), fire_word, noise)


def _base_key(seed):
    return rng.fold_in(rng.PRNGKey(seed), 0x5EED)


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("gid_base", GIDS)
@pytest.mark.parametrize("C", COLS)
def test_kernel_derivation_matches_rng(C, gid_base, t):
    """Keys, fire word and noise words of the kernel's derivation equal
    `rng`'s, bit for bit; so do the fire draw and the noise's uniforms."""
    n = 6
    base = _base_key(C + t % 97)
    keys = H.TickKeys(base, torch.tensor(t, dtype=torch.int32), gid_base)
    want_keys = rng.fold_in(rng.fold_in(base, keys.t),
                            gid_base + torch.arange(n))
    key_h, fire_key, noise_key, fire_word, noise = _mirror(
        base.numpy(), t, gid_base, n, C)
    np.testing.assert_array_equal(keys.per_hcu(n).numpy(), want_keys.numpy())
    np.testing.assert_array_equal(key_h, want_keys.numpy())
    k = rng.split(want_keys)
    np.testing.assert_array_equal(fire_key, k[:, 0].numpy())
    np.testing.assert_array_equal(noise_key, k[:, 1].numpy())
    np.testing.assert_array_equal(fire_word, rng.random_bits(k[:, 0]).numpy())
    np.testing.assert_array_equal(noise,
                                  rng.random_bits(k[:, 1], (C,)).numpy())
    thresh = 0.3
    np.testing.assert_array_equal(
        _unit(fire_word) < np.float32(thresh),
        (rng.uniform(k[:, 0]) < thresh).numpy())
    u = np.maximum(_unit(noise) * np.float32(1.0) + TINY, TINY)
    want_u = rng.uniform(k[:, 1], (C,), minval=float(TINY))
    np.testing.assert_array_equal(u.view(np.uint32),
                                  want_u.numpy().view(np.uint32))


def _params(C, wta_temp=1.0, out_rate=0.4):
    return BCPNNParams(n_hcu=8, rows=64, cols=C, fanout=8, active_queue=8,
                       max_delay=8, wta_temp=wta_temp, out_rate=out_rate)


def _operands(n, A, C, seed, device="cpu"):
    """h, pj, w_rows and counts as a tick gives them: counts 0 on about
    two slots of three (padding and merged duplicates), 1-3 elsewhere."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, C, generator=g) * 0.5
    pj = torch.rand(n, C, generator=g) * 0.05 + 1e-3
    w = torch.randn(n, A, C, generator=g)
    counts = torch.randint(1, 4, (n, A), generator=g).float()
    counts = torch.where(torch.rand(n, A, generator=g) < 0.65, 0.0, counts)
    return tuple(x.to(device) for x in (h, pj, w, counts))


def _former_path(h_vec, pj, drive, base_key, t, gid_base, p):
    """The tick's draw as the engine and `hcu.wta` computed it before the
    WTA derived its own keys."""
    n = h_vec.shape[0]
    k_t = rng.fold_in(base_key, t)
    keys = rng.fold_in(k_t, gid_base + torch.arange(n, device=h_vec.device))
    decay_m = torch.exp(torch.tensor(-p.dt_ms / p.tau_m, dtype=torch.float32))
    h = h_vec * decay_m + drive
    s = h + bias(pj, p.eps)
    k = rng.split(keys)
    fire = rng.uniform(k[..., 0, :]) < p.out_rate * p.dt_ms
    winner = rng.categorical(k[..., 1, :], s / p.wta_temp)
    return h, torch.where(fire, winner, -1).to(torch.int32), keys


def _torch_sum_drive(counts, w):
    return torch.sum(counts[..., None] * w, dim=-2)


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("gid_base", GIDS[:3])
@pytest.mark.parametrize("C", COLS)
def test_plain_op_matches_the_former_path(C, gid_base, t):
    """`hcu.wta_draw` on the CPU (the plain op) gives the former path's
    h' and fired bit for bit, whether it gets the tick's `TickKeys`, the
    per-HCU keys, or the drive itself."""
    n, A = 24, 13
    p = _params(C)
    h, pj, w, counts = _operands(n, A, C, C * 7 + t % 5)
    base = _base_key(gid_base % 1000)
    tt = torch.tensor(t, dtype=torch.int32)
    drive = _torch_sum_drive(counts, w)
    want_h, want_f, keys = _former_path(h, pj, drive, base, tt, gid_base, p)
    assert (want_f >= 0).any() and (want_f < 0).any()
    for got in (H.wta_draw(h, pj, w, counts, H.TickKeys(base, tt, gid_base), p),
                H.wta_draw(h, pj, w, counts, keys, p),
                H.wta(h, pj, drive, H.TickKeys(base, tt, gid_base), p)):
        assert torch.equal(got[0], want_h)
        assert torch.equal(got[1], want_f)


def test_drive_orders():
    """On the CPU the plain drive is `torch.sum`'s (the order the
    benchmark's reference holds the port to); the slot order the kernel
    keeps adds the slots one by one from slot 0, and leaving out the
    zero-count slots, as the kernel does, changes no bit of it."""
    n, A, C = 40, 44, 70
    p = _params(C)
    h, pj, w, counts = _operands(n, A, C, 3)
    keys = _base_key(1)[None].expand(n, 2).contiguous()
    got_h, _ = H.wta_draw(h, pj, w, counts, keys, p)
    decay_m = torch.exp(torch.tensor(-p.dt_ms / p.tau_m, dtype=torch.float32))
    assert torch.equal(got_h, h * decay_m + _torch_sum_drive(counts, w))
    slot = H.slot_order_drive(counts, w)
    want = torch.zeros(n, C)
    for a in range(A):
        want = want + counts[:, a, None] * w[:, a]
    assert torch.equal(slot, want)
    for i in range(n):
        live = counts[i] != 0
        skipped = H.slot_order_drive(counts[i:i + 1, live], w[i:i + 1, live])
        assert torch.equal(skipped[0], slot[i])


def test_argmax_takes_the_first_of_equal_scores():
    """An HCU whose columns tie on the whole score (a drive of -inf on
    every column) fires its first column, as `torch.argmax` picks."""
    n, A, C = 4, 2, 16
    p = _params(C, out_rate=1.0)
    h, pj, w, counts = _operands(n, A, C, 5)
    w = torch.full_like(w, float("-inf"))
    counts = torch.ones_like(counts)
    _, fired = H.wta_draw(h, pj, w, counts, _base_key(2)[None].expand(n, 2), p)
    assert fired.tolist() == [0] * n


def test_kernel_wrapper_takes_cuda_tensors_only():
    h, pj, w, counts = _operands(2, 3, 7, 0)
    keys = H.TickKeys(_base_key(0), torch.tensor([5], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        WD.wta_draw_kernel(h, pj, w, counts, keys, decay=0.9, eps=1e-4,
                           inv_temp=1.0, thresh=0.1)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# (n, A, C, wta_temp): the test sizes, odd C, the rodent (A = 36 + 8) and
# human widths, a temperature that is no power of two
CARD_CASES = [(24, 13, 7, 1.0), (64, 16, 16, 0.3), (300, 44, 70, 1.0),
              (256, 44, 100, 0.25), (33, 70, 100, 0.3), (5, 1, 255, 0.7)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tick_keys", "per_hcu_keys", "drive"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_on_the_card(case, mode):
    """Twice, bit for bit the plain op on the card (h' and fired); one
    launch a call; the caller's tensors untouched."""
    _cuda()
    n, A, C, temp = case
    p = _params(C, wta_temp=temp)
    dev = torch.device("cuda")
    h, pj, w, counts = _operands(n, A, C, n + C, dev)
    base = _base_key(n).to(dev)
    keys = H.TickKeys(base, torch.tensor(2**31 - 1, dtype=torch.int32,
                                         device=dev), 2**31 - 5)
    if mode == "per_hcu_keys":
        keys = keys.per_hcu(n)
    if mode == "drive":
        w, counts = H.slot_order_drive(counts, w)[:, None, :], None
    want = H.wta_draw_plain(h, pj, w, counts, keys, p)
    assert (want[1] >= 0).any()
    before = [x.clone() for x in (h, pj, w)]
    for run in range(2):
        launches = WD.launches["wta_draw"]
        got = H.wta_draw(h, pj, w, counts, keys, p)
        torch.cuda.synchronize()
        assert WD.launches["wta_draw"] == launches + 1
        assert torch.equal(got[0], want[0]), f"run {run}: h' differs"
        assert torch.equal(got[1], want[1]), f"run {run}: fired differs"
    for x, y in zip(before, (h, pj, w)):
        assert torch.equal(x, y), "the kernel wrote an input"


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_rodent_tick():
    """32,000 HCUs of 44 slots by 70 minicolumns, ~14 live slots an HCU."""
    _cuda()
    n, A, C = 32_000, 44, 70
    p = _params(C, out_rate=0.1)
    dev = torch.device("cuda")
    h, pj, w, counts = _operands(n, A, C, 11, dev)
    keys = H.TickKeys(_base_key(7).to(dev),
                      torch.tensor(12_345, dtype=torch.int32, device=dev))
    want = H.wta_draw_plain(h, pj, w, counts, keys, p)
    got = H.wta_draw(h, pj, w, counts, keys, p)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert 2_500 < int((got[1] >= 0).sum()) < 3_900


P8 = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=100, active_queue=16,
                 out_rate=0.3, wta_temp=0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(worklist=True), dict(worklist=False),
                                dict(eager=True), dict(merged=True)],
                         ids=["worklist", "dense", "eager", "merged"])
def test_graph_replay_against_per_tick_and_plain(monkeypatch, kw):
    """12 ticks in chunks of 5 (graphs of 5 and 2 ticks) equal 12 calls of
    `Simulator.tick` and a graph run with the plain op in the kernel's
    place, fired history and support bit for bit; the capture counts one
    launch a captured tick (and one for the scratch tick before a
    backend's first capture), a replay none, and the replays' device
    trace shows the kernel once a replayed tick."""
    _cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import network as N
    g = torch.Generator().manual_seed(0)
    ext = torch.randint(0, P8.rows + 1, (24, P8.n_hcu, 8), generator=g,
                        dtype=torch.int32).cuda()
    graphed = Simulator(P8, key=3, chunk=5, **kw)
    ticked = Simulator(P8, key=3, **kw)
    before, scratch = WD.launches["wta_draw"], len(N.scratch_ticked)
    fired = graphed.run(ext[:12])
    counted = WD.launches["wta_draw"] - before
    assert counted == 7 + len(N.scratch_ticked) - scratch
    want = torch.stack([ticked.tick(e) for e in ext[:12]])
    assert torch.equal(fired, want)
    before = WD.launches["wta_draw"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fired = torch.cat([fired, graphed.run(ext[12:])])
        torch.cuda.synchronize()
    assert WD.launches["wta_draw"] == before
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("wta_draw_kernel" in nm for nm in names) == 12
    want = torch.cat([want, torch.stack([ticked.tick(e) for e in ext[12:]])])
    assert torch.equal(fired, want)
    assert torch.equal(graphed.hcus().h, ticked.hcus().h)
    monkeypatch.setattr(H, "wta_draw", H.wta_draw_plain)
    plain = Simulator(P8, key=3, chunk=5, **kw)
    before = WD.launches["wta_draw"]
    assert torch.equal(plain.run(ext), fired)
    assert WD.launches["wta_draw"] == before
    assert torch.equal(plain.hcus().h, graphed.hcus().h)
    assert (fired >= 0).sum() > 20
