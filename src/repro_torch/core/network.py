"""Multi-HCU BCPNN network: state, spike queues, routing and the run
drivers (the port of `repro.core.network` for one device).

  * delay queue  — (H, max_delay, A) ring of buckets indexed by arrival
                   tick; a spike with delay d lands in bucket (t+d) % D.
                   Bucket capacity A is the paper's active-queue size;
                   overflows are counted as drops (paper Fig 7).
  * fanout       — static connectivity (dest_hcu, dest_row, delay) per MCU.
  * column batching — only HCUs that fired pay for a column update; fired
                   HCUs are compacted into a fixed-capacity batch.

Every scatter that the JAX package writes with ``mode="drop"`` goes to a
copy with one spare slot past the end, which takes the out-of-range writes
and is cut off: CUDA indexing would fault on them instead. Nothing here
reads a device value back to the host, so a tick never synchronises.

Drivers, as in the JAX package:

  * `network_tick` — one tick (the host-loop building block);
  * `run`          — the per-tick host loop, one read of the time a tick;
  * `network_run`  — the production path over pre-staged input (T, H,
                     A_ext), in chunks of ``chunk`` ticks (default 128).
                     On CUDA each chunk is one replay of a CUDA graph that
                     holds ``chunk`` calls of `engine.tick` (`ChunkGraphs`),
                     the counterpart of the JAX package's `lax.scan` chunk;
                     on the CPU the same ticks run one by one.

Session lanes (the recall server's, `repro_torch.launch.serve_bcpnn`):
`stack_sessions` gives every leaf a leading (S,) lane dim,
`write_sessions` copies a template into chosen lanes in place and
`take_session` views one lane as a single-session state, which the drivers
run as they run any state.

Chunking contract (the JAX package's): ext[k] is consumed by tick t0+k+1,
t0 being state.t at entry; the fired history is (T, H) int32; T need not
divide by ``chunk`` — full chunks share one graph and the remainder takes
a second, so there are at most two captures per (shape, backend). Every
driver gives the same trajectory bit for bit, whatever ``chunk`` is.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import merged as M
from repro_torch.core import rng
from repro_torch.core.params import BCPNNParams


class Connectivity(NamedTuple):
    dest_hcu: torch.Tensor   # (H, C, F) int32
    dest_row: torch.Tensor   # (H, C, F) int32
    delay: torch.Tensor      # (H, C, F) int32, in [1, max_delay-1]


class NetworkState(NamedTuple):
    hcus: H.HCUState         # ij planes in the stored layout (flat unless
                             # a blocked one is chosen, repro_torch.core.layout)
    delay_rows: torch.Tensor  # (H, D, A) int32; empty slots == R
    delay_count: torch.Tensor  # (H, D) int32
    t: torch.Tensor          # () int32 current time (ms)
    drops_in: torch.Tensor   # () int32 — delay-queue overflow drops
    drops_fire: torch.Tensor  # () int32 — fired-batch overflow drops
    base_key: torch.Tensor   # (2,) threefry key (repro_torch.core.rng)
    jring: torch.Tensor | None = None   # (H, C, M) merged-mode spike rings
    # () int32 — inter-device route-capacity drops; always 0 on one device.
    # LAST field, as in the JAX package.
    drops_route: torch.Tensor | None = None


def drop_counters(state: NetworkState) -> dict:
    """Cumulative spike-drop counters as a plain dict ({'in': delay-queue,
    'fire': fired-batch, 'route': inter-device fabric overflows})."""
    route = state.drops_route
    return {"in": int(state.drops_in), "fire": int(state.drops_fire),
            "route": 0 if route is None else int(route)}


def make_connectivity(p: BCPNNParams, key, n_hcu: int | None = None) -> Connectivity:
    """Random static fanout: each MCU projects to `fanout` (HCU, row) targets
    with biological delays of mean ~`mean_delay` ms (truncated geometric).
    The same draws as the JAX package's `make_connectivity`."""
    n = n_hcu or p.n_hcu
    k = rng.split(key, 3)
    shape = (n, p.cols, p.fanout)
    dest_hcu = rng.randint(k[0], shape, 0, n)
    dest_row = rng.randint(k[1], shape, 0, p.rows)
    lam = 1.0 / max(p.mean_delay - 1.0, 1e-3)
    geo = torch.floor(torch.log1p(-rng.uniform(k[2], shape)) / -lam).to(torch.int32)
    delay = torch.clamp(1 + geo, 1, p.max_delay - 1).to(torch.int32)
    return Connectivity(dest_hcu, dest_row, delay)


def hcu_view(state: NetworkState, layout=None) -> H.HCUState:
    """The per-HCU batched (H, R, C) view of the network's HCU state in
    flat order: a view of the stored planes under the flat layout; under a
    blocked ``layout`` the planes are unpacked first (a copy)."""
    return L.batched_state(L.load_hcus(state.hcus, layout),
                           state.delay_rows.shape[0])


def init_network(p: BCPNNParams, key, n_hcu: int | None = None,
                 merged: bool = False, layout=None) -> NetworkState:
    """The initial network state, its ij planes stored in ``layout`` (None:
    flat; else a resolved `layout.BlockedLayout`); ``merged`` adds the
    empty (H, C, RING_DEPTH) int32 spike rings of merged mode."""
    n = n_hcu or p.n_hcu
    dev = key.device
    D, A = p.max_delay, p.active_queue
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return NetworkState(
        jring=M.init_ring(p, n, dev) if merged else None,
        hcus=L.store_hcus(H.init_hcu_batch(p, n, dev), layout),
        delay_rows=torch.full((n, D, A), p.rows, dtype=torch.int32, device=dev),
        delay_count=torch.zeros((n, D), dtype=torch.int32, device=dev),
        t=i32(0), drops_in=i32(0), drops_fire=i32(0), drops_route=i32(0),
        base_key=rng.fold_in(key, 0x5EED),
    )


def _put_drop(flat, idx, val):
    """`flat.at[idx].set(val, mode="drop")` on a 1-D tensor: writes whose
    index is out of range land on a spare slot and are discarded. Returns a
    new tensor."""
    n = flat.shape[0]
    buf = torch.cat([flat, flat.new_zeros(1)])
    buf[torch.where((idx >= 0) & (idx < n), idx, n).long()] = val
    return buf[:n]


def _rank_within_key(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its key group (stable: by position):
    rank[i] == #{j < i : keys[j] == keys[i]}."""
    M = keys.shape[0]
    sorted_keys, order = torch.sort(keys, stable=True)
    idx = torch.arange(M, device=keys.device)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                          sorted_keys[1:] != sorted_keys[:-1]])
    first_pos = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - first_pos
    return rank.to(keys.dtype)


def consume_bucket(state: NetworkState, t, p: BCPNNParams):
    """Read this tick's delay bucket (H, A) and clear it in the returned
    state. ``t`` is the int32 time tensor; no host read."""
    b = (t % p.max_delay).reshape(1).long()
    bucket = torch.index_select(state.delay_rows, 1, b)[:, 0, :]
    state = state._replace(
        delay_rows=state.delay_rows.index_fill(1, b, p.rows),
        delay_count=state.delay_count.index_fill(1, b, 0))
    return state, bucket


def enqueue_spikes(state: NetworkState, dest_h, dest_row, delay, valid,
                   p: BCPNNParams, n_hcu: int):
    """Insert a flat batch of spike messages into the delay queues.

    Fixed-capacity slot allocation: messages are ranked within their
    (dest_hcu, bucket) group; slot = current_count + rank; messages whose
    slot exceeds the bucket capacity A are dropped and counted (Fig 7).
    """
    D, A = p.max_delay, p.active_queue
    bucket = (state.t + delay) % D
    hb = dest_h * D + bucket
    key = torch.where(valid, hb, n_hcu * D)                 # invalid rank last
    rank = _rank_within_key(key)
    base = state.delay_count.reshape(-1)[hb.long()]
    slot = base + rank
    ok = valid & (slot < A)
    flat_idx = torch.where(ok, hb * A + slot, n_hcu * D * A)
    delay_rows = _put_drop(state.delay_rows.reshape(-1), flat_idx,
                           dest_row).reshape(n_hcu, D, A)
    arrivals = torch.zeros(n_hcu * D + 1, dtype=torch.int32,
                           device=dest_h.device)
    arrivals.index_add_(0, key.long(), valid.to(torch.int32))
    arrivals = arrivals[:-1].reshape(n_hcu, D)
    new_count = torch.clamp(state.delay_count + arrivals, max=A)
    dropped = torch.sum(state.delay_count + arrivals - new_count)
    return state._replace(delay_rows=delay_rows, delay_count=new_count,
                          drops_in=(state.drops_in + dropped).to(torch.int32))


def select_fired(fired: torch.Tensor, cap: int):
    """Compact fired HCU indices (fired[h] >= 0) into `cap` slots; padding
    slots carry h_idx == n. Returns (h_idx, j_idx, n_dropped)."""
    n = fired.shape[0]
    is_fired = fired >= 0
    order = torch.argsort((~is_fired).to(torch.int32), stable=True)
    idx = order[:cap]
    sel_valid = is_fired[idx]
    h_idx = torch.where(sel_valid, idx, n)
    j_idx = torch.where(sel_valid, fired[idx], 0)
    n_dropped = torch.sum(is_fired) - torch.sum(sel_valid)
    return h_idx.to(torch.int32), j_idx.to(torch.int32), n_dropped.to(torch.int32)


# ---------------------------------------------------------------------------
# session batching (serving): a leading (S,) lane dim over NetworkState
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of NetworkStates of one structure (the
    HCUState included), field by field; a None field stays None."""
    out = []
    for vals in zip(*trees, strict=True):
        if vals[0] is None:
            out.append(None)
        elif isinstance(vals[0], tuple):
            out.append(tree_map(fn, *vals))
        else:
            out.append(fn(*vals))
    return type(trees[0])(*out)


def copy_into(held, new) -> None:
    """Copy every leaf of ``new`` into the same leaf of ``held`` (same
    structure and shapes), in place: the tensors of ``held`` keep their
    storage, so graphs captured on them stay valid. A leaf that already
    shares its storage is left alone."""
    for dst, src in _pairs(held, new):
        if src.data_ptr() != dst.data_ptr() or src.device != dst.device:
            dst.copy_(src)


def stack_sessions(state: NetworkState, n_sessions: int) -> NetworkState:
    """Replicate one NetworkState into ``n_sessions`` independent session
    lanes: every leaf gains a leading (S,) dim (new contiguous tensors on
    the state's device), so each lane ``take_session(stacked, i)`` is a
    contiguous view.

    Each lane then evolves under its own external stream (the state the
    recall server `repro_torch.launch.serve_bcpnn` carries). Lanes are
    advanced one at a time with exactly the single-session driver
    (`network_run` on the lane's views), never batched into one launch:
    that keeps every lane bit for bit an independent `Simulator.run`, as
    the JAX package's `lax.map` over the lanes does."""
    return tree_map(lambda a: a.unsqueeze(0).repeat(
        (n_sessions,) + (1,) * a.dim()), state)


def write_sessions(stacked: NetworkState, template: NetworkState,
                   lanes) -> NetworkState:
    """Copy ``template`` into the session lanes named by ``lanes`` (a
    host-side (K,) integer array or list; a tensor is read back). As the
    JAX package's drop-mode scatter: an entry in [-S, 0) counts from the
    end, any other out-of-range entry is ignored, so a caller pads with S
    to write fewer than K lanes. The copy is in place into the stacked
    tensors, which keep their storage: admission never rebinds the lanes,
    so the lanes' captured graphs survive it. Returns ``stacked``."""
    S = stacked.t.shape[0]
    if torch.is_tensor(lanes):
        lanes = lanes.tolist()
    keep = []
    for lane in np.asarray(lanes, dtype=np.int64).reshape(-1).tolist():
        lane = lane + S if -S <= lane < 0 else lane
        if 0 <= lane < S:
            keep.append(lane)
    for dst, src in _pairs(stacked, template):
        for lane in keep:
            dst[lane].copy_(src)
    return stacked


def take_session(stacked: NetworkState, lane: int) -> NetworkState:
    """One session lane as a single-session NetworkState of views into the
    stacked tensors (no copy: a write to it writes the lane; clone it to
    keep it)."""
    return tree_map(lambda a: a[lane], stacked)


def network_tick(state: NetworkState, conn: Connectivity, ext_rows,
                 p: BCPNNParams, *, eager: bool = False, merged: bool = False,
                 cap_fire: int | None = None, worklist: bool | None = None,
                 fused: bool | None = None, fused_cols: bool | None = None,
                 layout=None):
    """Advance the whole network one 1 ms tick with the backend that the
    flags select (`engine.select_backend`). ext_rows (H, A_ext) int32
    external input (padding == p.rows); ``layout`` the stored layout of
    ``state``'s planes. Returns (state', fired (H,)); the ij planes and
    i-vectors of ``state`` are updated in place (those of its flat copy
    where the backend carries flat planes)."""
    from repro_torch.core import engine as E
    be = E.select_backend(p, eager=eager, merged=merged, worklist=worklist,
                          fused=fused, fused_cols=fused_cols, layout=layout)
    state, fired = E.tick(be.carry_in(state), conn, ext_rows, p, be,
                          cap_fire)
    return be.carry_out(state), fired


def _run_ticks(state: NetworkState, conn: Connectivity, ext, p: BCPNNParams,
               be, cap_fire, fired: torch.Tensor,
               tick_kw: dict | None = None) -> NetworkState:
    """The ticks of ext (T, H, A_ext) between one `carry_in` and one
    `carry_out` of the backend: the body of a chunk. Tick k's fired vector
    is copied into ``fired[k]`` ((T, H) int32) as it comes, so nothing of a
    tick outlives it. ``tick_kw`` are `engine.tick`'s sharded hooks
    (`distributed.make_dist_run`). Returns state'."""
    from repro_torch.core import engine as E
    state = be.carry_in(state)
    for k, e in enumerate(ext):
        state, f = E.tick(state, conn, e, p, be, cap_fire, **(tick_kw or {}))
        fired[k].copy_(f)
    return be.carry_out(state)


def network_run(state: NetworkState, conn: Connectivity, ext: torch.Tensor,
                p: BCPNNParams, *, chunk: int = 128, eager: bool = False,
                merged: bool = False, cap_fire: int | None = None,
                worklist: bool | None = None, fused: bool | None = None,
                fused_cols: bool | None = None, layout=None,
                graphs: "ChunkGraphs | None" = None):
    """Run len(ext) ticks in chunks of ``chunk`` (the module docstring's
    contract): ext (T, H, A_ext) int32 pre-staged external spikes. Returns
    (state', fired (T, H) int32). Reads nothing back to the host.

    On the CPU each chunk runs its ticks one by one between one `carry_in`
    and one `carry_out` of the backend the flags select. On CUDA each
    chunk is one replay of a captured CUDA graph (`ChunkGraphs`), with no
    fallback: a capture that fails raises. The state is updated in place
    and returned (the JAX package donates it): its tensors are the graphs'
    static carry. ``graphs`` keeps the captures for the next call on the
    same state (the `Simulator` holds one); None captures afresh."""
    from repro_torch.core import engine as E
    be = E.select_backend(p, eager=eager, merged=merged, worklist=worklist,
                          fused=fused, fused_cols=fused_cols, layout=layout)
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    n = state.delay_rows.shape[0]
    dev = state.t.device
    T = ext.shape[0]
    if T == 0:
        return state, torch.zeros((0, n), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        fired = torch.empty((T, n), dtype=torch.int32)
        for i in range(0, T, chunk):
            state = _run_ticks(state, conn, ext[i:i + chunk], p, be, cap_fire,
                               fired[i:i + chunk])
        return state, fired
    graphs = ChunkGraphs() if graphs is None else graphs
    return graphs.run(state, conn, ext.to(dev, torch.int32), p, be, cap_fire,
                      chunk)


# ---------------------------------------------------------------------------
# CUDA-graph chunks
# ---------------------------------------------------------------------------

class _Chunk(NamedTuple):
    graph: torch.cuda.CUDAGraph
    ext: torch.Tensor        # (L, H, A_ext) static input
    fired: torch.Tensor      # (L, H) static fired rows


def _leaves(tree):
    """The tensor leaves of a NetworkState (its HCUState included), in
    field order."""
    for v in tree:
        if isinstance(v, tuple):
            yield from _leaves(v)
        elif v is not None:
            yield v


def _identity(*trees):
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for tree in trees for t in _leaves(tree))


def _pairs(held, new):
    """(held leaf, new leaf) of two states of one structure, field by field;
    raises where a field is a tensor on one side and not the other."""
    for f, a, b in zip(held._fields, held, new, strict=True):
        if type(a) is not type(b):
            raise RuntimeError(f"the tick changed the state's field {f} from "
                               f"{type(a).__name__} to {type(b).__name__}")
        if isinstance(a, tuple):
            yield from _pairs(a, b)
        elif a is not None:
            yield a, b


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that every capture on ``device`` records on, one per
    device and process: the scratch tick of `_load_kernels` sets up each
    library's per-stream state (cuBLAS's workspace) on it once for all."""
    return torch.cuda.Stream(device)


# (device, backend, cap_fire, parameters, A_ext) whose scratch tick this
# process has run; the scratch tick's launches count like any others
scratch_ticked: set = set()


def _load_kernels(p: BCPNNParams, be, cap_fire, A_ext: int,
                  stream: torch.cuda.Stream) -> None:
    """Before the first capture of a backend on a device: one tick of a
    two-HCU scratch network of the same backend and widths, on the
    device's capture stream, once per process. On the H100 (CUDA 12.8) a
    kernel that has never run loads inside a capture as well, but the
    eager path's first matmul cannot create its cuBLAS handle there. The
    held state is never ticked for this."""
    sig = (stream.device, be, cap_fire, p, A_ext)
    if sig in scratch_ticked:
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        key = rng.PRNGKey(0, stream.device)
        scratch = init_network(p, key, 2, merged=be.mode == "merged",
                               layout=be.layout)
        ext = torch.full((1, 2, A_ext), p.rows, dtype=torch.int32,
                         device=stream.device)
        _run_ticks(scratch, make_connectivity(p, key, 2), ext, p, be,
                   cap_fire, torch.empty((1, 2), dtype=torch.int32,
                                         device=stream.device))
    scratch_ticked.add(sig)


class ChunkGraphs:
    """The captured chunks of one held state: the counterpart of the JAX
    package's compiled `lax.scan` chunk, one `torch.cuda.CUDAGraph` per
    chunk length, replayed once per chunk.

    * Static carry: the state handed to the first `run` IS the carry. Its
      ij planes and i-vectors, which the worklist kernels rewrite in
      place, are captured as they are; every leaf that a tick replaces
      with a new tensor (the delay queue, the time, the counters, the
      j-vectors and support, and under the dense and eager backends the
      planes the backend rebuilds) is copied back into the carry's own
      tensor as the graph's last operations. No graph's output is another
      graph's input, so the graphs share one memory pool.
    * Static input (L, H, A_ext) and fired rows (L, H): the chunk's input
      is copied in before each replay and the fired rows out after it.
    * A graph never outlives the tensors it was captured on: the captures
      are keyed by the backend, the parameters and the identity of every
      leaf of the state and the connectivity, and a run on anything else
      drops them and captures afresh (as `clear` does).
    * Capture neither advances the state nor synchronises: it records on
      the device's capture stream (`_capture_stream`), which waits on the
      current one by event, so it may run under sync-debug "error".
    * The kernels' launch counters (`bcpnn_update.launches`) count the
      wrappers' launches: a capture records each launch into its graph
      and counts it there; a replay runs what was recorded and counts
      nothing (a device trace of a replay counts what ran).

    ``captured`` maps each chunk length to its graph, in capture order
    (each kept with ``keep_graph=True``, so ``raw_cuda_graph()`` can be
    inspected). ``pool`` (a `torch.cuda.graph_pool_handle`) shares one
    memory pool between several ChunkGraphs whose graphs are replayed one
    after another on one stream, as the recall server's lanes are; by
    default each has its own."""

    def __init__(self, pool=None):
        self._shared_pool = pool
        self.clear()

    def clear(self) -> None:
        """Drop every graph (and its memory, unless the pool is shared)."""
        self._key = self._carry = self._conn = None
        self._chunks: dict[tuple, _Chunk] = {}
        self._pool = self._shared_pool

    @property
    def captured(self) -> dict[int, torch.cuda.CUDAGraph]:
        return {L: c.graph for (L, _), c in self._chunks.items()}

    def run(self, state: NetworkState, conn: Connectivity, ext, p, be,
            cap_fire, chunk: int, tick_kw: dict | None = None):
        """Replay the chunks of ext (T, H, A_ext), on ``ext``'s device, on
        ``state``; returns (state, fired (T, H)). ``tick_kw`` are
        `engine.tick`'s sharded hooks, captured with the ticks (the
        exchange's collective included)."""
        tick_kw = tick_kw or {}
        key = (be, cap_fire, p, tuple(sorted(tick_kw.items())),
               _identity(state, conn))
        if key != self._key:
            self.clear()
            self._key, self._carry, self._conn = key, state, conn
        T, n, A_ext = ext.shape
        out = torch.empty((T, n), dtype=torch.int32, device=ext.device)
        for i in range(0, T, chunk):
            L = min(chunk, T - i)
            c = self._chunks.get((L, A_ext))
            if c is None:
                c = self._capture(L, A_ext, p, be, cap_fire, tick_kw)
            c.ext.copy_(ext[i:i + L])
            c.graph.replay()
            out[i:i + L].copy_(c.fired)
        return state, out

    def _capture(self, L: int, A_ext: int, p: BCPNNParams, be,
                 cap_fire, tick_kw: dict) -> _Chunk:
        carry, conn = self._carry, self._conn
        dev = carry.t.device
        n = carry.delay_rows.shape[0]
        side = _capture_stream(dev)
        _load_kernels(p, be, cap_fire, A_ext, side)
        ext = torch.full((L, n, A_ext), p.rows, dtype=torch.int32, device=dev)
        fired = torch.empty((L, n), dtype=torch.int32, device=dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                final = _run_ticks(carry, conn, ext, p, be, cap_fire, fired,
                                   tick_kw)
                copy_into(carry, final)
                del final
            except BaseException:
                try:        # end the capture; the error raised is the first
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph.instantiate()
        c = _Chunk(graph, ext, fired)
        self._chunks[(L, A_ext)] = c
        return c


def run(state: NetworkState, conn: Connectivity, ext_fn, n_ticks: int,
        p: BCPNNParams, **kw):
    """Per-tick host-loop driver: ext_fn(t) -> (H, A_ext) external rows of
    tick t (an array or tensor). One `network_tick` and one read of the
    time back to the host per tick (a synchronisation, by design: the
    dispatch-bound baseline for callers that need host-side control
    between ticks). ``kw`` are `network_tick`'s flags. Returns (state',
    fired (T, H))."""
    dev = state.t.device
    hist = []
    for _ in range(n_ticks):
        ext = torch.as_tensor(ext_fn(int(state.t) + 1)).to(dev, torch.int32)
        state, fired = network_tick(state, conn, ext, p, **kw)
        hist.append(fired)
    return state, torch.stack(hist)


def stage_external(ext, n_ticks: int | None = None, t0: int = 0,
                   device=None) -> torch.Tensor:
    """Stage external input as the dense (T, H, A_ext) int32 tensor that
    `network_run` consumes. `ext` is an array or tensor, an iterable of
    (H, A_ext) frames, or a callable ext_fn(t) sampled at t0+1 .. t0+n_ticks."""
    if callable(ext):
        if n_ticks is None:
            raise ValueError("n_ticks required with a callable")
        ext = [ext(t0 + 1 + k) for k in range(n_ticks)]
    if isinstance(ext, np.ndarray):
        ext = torch.from_numpy(ext)
    elif not torch.is_tensor(ext):
        ext = torch.from_numpy(np.stack([np.asarray(e) for e in ext]))
    return ext.to(device=device, dtype=torch.int32)
