"""The delay-queue enqueue of the tick's fan-out (`network.enqueue_spikes`).

* On the CPU, the plain version against a sequential oracle: messages
  inserted one by one in position order, a message into a full bucket
  counted as a drop; the queues, the counts and the drop counter exactly,
  on a padded batch with sparse valid slots (the rodent tick's), skew past
  the bucket size (the recall tick's), one key of thousands of messages,
  counts already near the bucket size, all padding and an empty batch.
* On a CUDA device (skipped without one): the kernel
  (`kernels.spike_enqueue`) against the plain version and the oracle, bit
  for bit, on the same cases and the rodent tick's shape (11,201 fired
  slots of 100 messages, about 3,200 of them valid, into 32,000 HCUs),
  twice, leaving its inputs as they were; a CUDA-graph replay of the tick
  against the per-tick driver, with the kernel's launch counter counting
  each captured tick once and a replay none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Simulator
from repro_torch.core import network as N
from repro_torch.core.params import BCPNNParams
from repro_torch.kernels import spike_enqueue as SE

D, A = 16, 36


def _messages(rng, n, slots, fanout, live, delay_p1):
    """``slots`` fired slots of ``fanout`` messages each, the first
    ``live`` of them valid (the fired batch's padding last, as
    `select_fired` packs it); a message's delay is 1 with probability
    ``delay_p1``, else uniform in [2, D)."""
    m = slots * fanout
    dest_h = rng.integers(0, n, m)
    dest_row = rng.integers(0, 1200, m)
    delay = np.where(rng.random(m) < delay_p1, 1, rng.integers(2, D, m))
    valid = np.repeat(np.arange(slots) < live, fanout)
    return dest_h, dest_row, delay, valid


def _case(name, seed=0):
    """(n, t, delay_rows, delay_count, drops_in, dest_h, dest_row, delay,
    valid) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n, t = 64, int(rng.integers(0, 1000))
    count = rng.integers(0, A // 2, (n, D))
    if name == "rodent_like":        # 35% of the HCUs' slots, 29% fired
        msgs = _messages(rng, n, int(0.35 * n) + 1, 20, 7, 0.3)
    elif name == "recall_like":      # every HCU fires, most at delay 1
        n = 16
        count = rng.integers(0, A // 2, (n, D))
        msgs = _messages(rng, n, n, 100, n, 0.865)
    elif name == "one_hot_key":      # thousands into one bucket of one HCU
        dh, dr, dl, ok = _messages(rng, n, 30, 100, 30, 0.0)
        hot = rng.random(dh.shape[0]) < 0.9
        msgs = (np.where(hot, 3, dh), dr, np.where(hot, 5, dl), ok)
    elif name == "near_full":
        count = rng.integers(A - 3, A + 1, (n, D))
        msgs = _messages(rng, n, 23, 20, 12, 0.3)
    elif name == "all_padding":
        msgs = _messages(rng, n, 23, 20, 0, 0.3)
    elif name == "empty":
        msgs = _messages(rng, n, 0, 20, 0, 0.3)
    elif name == "rodent_shape":     # the rodent tick: 32,000 HCUs
        n = 32_000
        count = rng.integers(0, 8, (n, D))
        msgs = _messages(rng, n, int(0.35 * n) + 1, 100, 3_200, 0.3)
    else:
        raise KeyError(name)
    rows = rng.integers(0, 1200, (n, D, A))
    rows = np.where(np.arange(A) < count[..., None], rows, 1200)
    return (n, t, rows, count, int(rng.integers(0, 100))) + msgs


CPU_CASES = ["rodent_like", "recall_like", "one_hot_key", "near_full",
             "all_padding", "empty"]


def _oracle(case):
    """The queues after inserting the messages one by one."""
    n, t, rows, count, drops, dest_h, dest_row, delay, valid = case
    rows, count = rows.copy(), count.copy()
    for h, r, d, ok in zip(dest_h.tolist(), dest_row.tolist(),
                           delay.tolist(), valid.tolist()):
        if not ok:
            continue
        b = (t + d) % D
        if count[h, b] < A:
            rows[h, b, count[h, b]] = r
            count[h, b] += 1
        else:
            drops += 1
    return rows, count, drops


def _state(case, device):
    n, t, rows, count, drops = case[:5]
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=device)
    return N.NetworkState(hcus=None, delay_rows=i32(rows),
                          delay_count=i32(count), t=i32(t), drops_in=i32(drops),
                          drops_fire=i32(0), base_key=None)


def _enqueue(fn, case, device):
    n = case[0]
    dest_h, dest_row, delay, valid = (
        torch.as_tensor(a, dtype=torch.bool if a.dtype == bool
                        else torch.int32, device=device) for a in case[5:])
    p = BCPNNParams(n_hcu=n, rows=1200, cols=70, active_queue=A, max_delay=D)
    st = fn(_state(case, device), dest_h, dest_row, delay, valid, p, n)
    return (st.delay_rows.cpu().numpy(), st.delay_count.cpu().numpy(),
            int(st.drops_in))


def _assert_queues(got, want, what):
    rows, count, drops = want
    np.testing.assert_array_equal(got[0], rows, err_msg=f"{what}: rows")
    np.testing.assert_array_equal(got[1], count, err_msg=f"{what}: counts")
    assert got[2] == drops, f"{what}: drops {got[2]} != {drops}"


@pytest.mark.parametrize("name", CPU_CASES)
def test_plain_enqueue_matches_the_sequential_oracle(name):
    case = _case(name)
    want = _oracle(case)
    _assert_queues(_enqueue(N.enqueue_spikes, case, "cpu"), want, name)
    if name == "one_hot_key":       # the case reaches past a bucket
        assert want[2] > 2_000


def test_kernel_wrapper_takes_cuda_tensors_only():
    st = _state(_case("empty"), "cpu")
    m = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SE.enqueue_spikes_kernel(st.delay_rows, st.delay_count, st.drops_in,
                                 st.t, m, m, m, m.bool())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CPU_CASES + ["rodent_shape"])
def test_kernel_matches_plain_and_oracle(name):
    """Twice, bit for bit the oracle and the plain version on the card;
    one launch a call; the caller's tensors untouched."""
    _cuda()
    case = _case(name, seed=1)
    want = _oracle(case)
    dev = torch.device("cuda")
    _assert_queues(_enqueue(N.enqueue_spikes_plain, case, dev), want,
                   f"{name}, plain")
    st = _state(case, dev)
    before = [x.clone() for x in (st.delay_rows, st.delay_count, st.drops_in)]
    msgs = [torch.as_tensor(a, device=dev, dtype=torch.bool if a.dtype == bool
                            else torch.int32) for a in case[5:]]
    for run in range(2):
        launches = SE.launches["spike_enqueue"]
        out = SE.enqueue_spikes_kernel(st.delay_rows, st.delay_count,
                                       st.drops_in, st.t, *msgs)
        torch.cuda.synchronize()
        assert SE.launches["spike_enqueue"] == launches + 1
        _assert_queues(tuple(x.cpu().numpy() for x in out[:2])
                       + (int(out[2]),), want, f"{name}, kernel run {run}")
    for x, y in zip(before, (st.delay_rows, st.delay_count, st.drops_in)):
        assert torch.equal(x, y), f"{name}: the kernel wrote an input"


# every HCU fires every tick, 86% of the messages at delay 1: about 40 a
# key a tick, so buckets of 16 overflow and large keys take the block path
P8 = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=100, active_queue=16,
                 out_rate=1.0, mean_delay=1.5)


@pytest.mark.cuda
def test_graph_replay_counts_the_enqueue_per_captured_tick():
    """12 ticks in chunks of 5 (graphs of 5 and 2 ticks) equal 12 calls of
    `Simulator.tick`; the capture counts one enqueue a captured
    tick (and one for the scratch tick before a backend's first capture),
    a replay none, and the replays' device trace shows the enqueue's place
    kernel once a replayed tick."""
    _cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(0)
    ext = torch.randint(0, P8.rows + 1, (24, P8.n_hcu, 8), generator=g,
                        dtype=torch.int32).cuda()
    graphed = Simulator(P8, key=0, chunk=5)
    ticked = Simulator(P8, key=0)
    before, scratch = SE.launches["spike_enqueue"], len(N.scratch_ticked)
    fired = graphed.run(ext[:12])
    counted = SE.launches["spike_enqueue"] - before
    assert counted == 7 + len(N.scratch_ticked) - scratch
    want = torch.stack([ticked.tick(e) for e in ext[:12]])
    assert torch.equal(fired, want)
    before = SE.launches["spike_enqueue"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fired = graphed.run(ext[12:])
        torch.cuda.synchronize()
    assert SE.launches["spike_enqueue"] == before
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("enqueue_place_kernel" in nm for nm in names) == 12
    want = torch.stack([ticked.tick(e) for e in ext[12:]])
    assert torch.equal(fired, want)
    for f in ("delay_rows", "delay_count", "drops_in", "t"):
        assert torch.equal(getattr(graphed.state, f),
                           getattr(ticked.state, f)), f
    assert int(graphed.state.drops_in) > 0
