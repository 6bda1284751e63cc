"""BCPNN-as-a-service: slot-recycling continuous-batching recall server (the
port of `repro.launch.serve_bcpnn`).

  PYTHONPATH=src python -m repro_torch.launch.serve_bcpnn --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve_bcpnn --device cpu

Many concurrent cue->attractor-recall sessions served from one Simulator's
trained state, on CUDA unless the caller passes ``device="cpu"``. The
pieces:

  RecallRequest   one client session: a partial cue (pattern row per HCU +
                  driven-HCU mask) and a tick budget; carries its own
                  lifecycle telemetry (queue/admit/finish timestamps, fired
                  trajectory, per-session drop counters).
  RequestQueue    fixed-capacity FIFO admission queue — the serving analogue
                  of the paper's spike queues (fixed slots, overflow is a
                  counted rejection, priced by Fig 7 / EQ1 through
                  `repro_torch.runtime.resilience.ServingHealthMonitor`).
  BCPNNRecallServer
                  `slots` session lanes as a leading (S,) dim over
                  `NetworkState` (`network.stack_sessions`). Each engine
                  step advances every lane `step_ticks` ticks (`_serve_step`)
                  and reads the step's fired rows and drop counters back in
                  one host read. A session completes when its recall
                  CONVERGES (every HCU has fired and no winner changed over
                  a full step) or its tick budget expires; its lane is freed
                  and the next queued cue is admitted by an in-place copy of
                  the template into the lane (`network.write_sessions`).

The lane step. The JAX package runs the lanes in one dispatch of
`jax.lax.map`, one lane at a time with the single-session scan. The port
runs them one after another too, each lane through exactly the
single-session driver (`network.network_run` on the lane's views,
`network.take_session`): on CUDA one `ChunkGraphs` per lane, all sharing
one graph memory pool, each capturing `step_ticks` calls of the tick on
its lane's tensors at the first step and replaying them at every later
one. Admission copies into the same tensors, so nothing is captured after
the first step. The lanes are never batched into one launch: that is what
keeps the bitwise contract (docs/SERVING.md).

Sharing model: the connectivity and the params are shared read-only across
all lanes. The per-lane NetworkState is fully private (the tick writes the
synaptic ij planes during recall, and the volatile j-vectors/delay queues
are per-slot by construction), so lane trajectories are exactly
independent runs: each lane's is bit for bit an independent
`Simulator.run(chunk=step_ticks)` from the same template state.

Free lanes keep ticking on silence until recycled (like the LM engine's pad
slots); their drops are not attributed to any session and their state is
reset from the template on the next admission.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import network as N
from repro_torch.runtime.resilience import ServingHealthMonitor


# ---------------------------------------------------------------------------
# the lane step
# ---------------------------------------------------------------------------

def _serve_step(stacked, conn, ext, p, kw, graphs=None):
    """Advance every session lane by ext.shape[1] ticks, lane by lane.

    stacked: NetworkState with a leading (S,) lane dim, updated in place;
    ext: (S, T, H, W) per-lane staged external input on the lanes' device;
    kw: the Simulator's driver flags (`network.network_run`'s); graphs: one
    `network.ChunkGraphs` per lane (CUDA), or None. Per lane the run is
    EXACTLY the single-session `network_run` with ``chunk=T`` — see the
    module docstring's bitwise contract. Returns fired (S, T, H) int32 on
    the lanes' device; reads nothing back to the host."""
    S, T = ext.shape[:2]
    n = stacked.delay_rows.shape[1]
    fired = torch.empty((S, T, n), dtype=torch.int32, device=ext.device)
    for lane in range(S):
        view = N.take_session(stacked, lane)
        new, f = N.network_run(view, conn, ext[lane], p, chunk=T,
                               graphs=None if graphs is None else graphs[lane],
                               **kw)
        # the CPU driver returns new tensors for the leaves a tick
        # replaces; the CUDA graphs copy them back into the views themselves
        N.copy_into(view, new)
        fired[lane].copy_(f)
    return fired


def _step_winners(fired_step: np.ndarray) -> np.ndarray:
    """Last WTA winner per HCU over one (T, H) step window (-1 = silent)."""
    T, H = fired_step.shape
    w = np.full((H,), -1, np.int64)
    for f in fired_step:
        upd = f >= 0
        w[upd] = f[upd]
    return w


# ---------------------------------------------------------------------------
# requests and the admission queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecallRequest:
    """One client session: cue in, attractor out, telemetry throughout."""
    rid: int
    cue_rows: np.ndarray            # (H,) int32 — pattern row per HCU
    cue_mask: np.ndarray            # (H,) bool  — which HCUs the cue drives
    budget_ticks: int = 48          # max biological ms before expiry
    # lifecycle (filled in by the server)
    status: str = "new"             # new|queued|rejected|active|done|expired
    submit_s: float | None = None
    admit_s: float | None = None
    finish_s: float | None = None
    ticks: int = 0                  # biological ms actually served
    winners: np.ndarray | None = None   # (H,) final winner per HCU
    fired: np.ndarray | None = None     # (ticks, H) fired trajectory
    drops: dict | None = None           # per-session {'in','fire','route'}
    lane: int | None = None             # the session lane it was served on

    @property
    def service_ms(self) -> float | None:
        """Wall milliseconds from admission to completion."""
        if self.admit_s is None or self.finish_s is None:
            return None
        return (self.finish_s - self.admit_s) * 1e3

    @property
    def sojourn_ms(self) -> float | None:
        """Wall milliseconds from submission to completion (incl. queueing)."""
        if self.submit_s is None or self.finish_s is None:
            return None
        return (self.finish_s - self.submit_s) * 1e3


class RequestQueue:
    """Fixed-capacity FIFO admission queue with drop accounting.

    The serving analogue of the delay-bucket spike queues: a fixed number of
    waiting slots, overflow is a counted REJECTION (never silent loss), and
    admission order is strictly FIFO. Invariants: admitted + rejected +
    waiting == submitted; rejections happen exactly when the queue is at
    capacity at offer time.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._q: collections.deque = collections.deque()
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def free(self) -> int:
        return self.capacity - len(self._q)

    def offer(self, req: RecallRequest) -> bool:
        """Submit a request; False (and req.status == 'rejected') if full."""
        self.submitted += 1
        if len(self._q) >= self.capacity:
            self.rejected += 1
            req.status = "rejected"
            return False
        req.status = "queued"
        self._q.append(req)
        return True

    def take(self, k: int) -> list:
        """Admit up to k requests, FIFO."""
        out = []
        while self._q and len(out) < k:
            out.append(self._q.popleft())
            self.admitted += 1
        return out

    def counters(self) -> dict:
        return {"submitted": self.submitted, "admitted": self.admitted,
                "rejected": self.rejected, "waiting": len(self._q),
                "capacity": self.capacity}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class BCPNNRecallServer:
    """Continuous-batching recall serving over `slots` session lanes.

        sim = Simulator(p, key=0, cap_fire=p.n_hcu)  # on CUDA
        train_assoc(sim, patterns, ...)              # or any warmed state
        srv = BCPNNRecallServer(sim, slots=8, queue_capacity=64)
        srv.submit(RecallRequest(0, cue_rows, cue_mask))
        done = srv.run()                             # drain to completion

    The server snapshots `sim.state` as its session TEMPLATE at construction
    (a true copy on the Simulator's device — the Simulator stays usable) and
    takes the backend/mode configuration from the facade, so whatever engine
    mode the Simulator runs (dense/worklist, lazy/eager, layouts) is what
    every lane runs; merged mode is rejected, as in the JAX package.

    Telemetry of the lane graphs (CUDA): `graphs` (one `ChunkGraphs` a
    lane), `captures` (graphs captured so far) and `capture_steps` (for
    each step that captured: its index, the graphs it captured and its
    wall seconds).
    """

    def __init__(self, sim, *, slots: int = 4, queue_capacity: int = 64,
                 step_ticks: int = 12, ext_width: int = 4,
                 monitor: ServingHealthMonitor | None = None,
                 req_rate: float = 0.0, clock=time.perf_counter):
        if sim.merged:
            raise NotImplementedError(
                "serving: merged mode's jring carry is untested under "
                "session stacking")
        self.p = sim.p
        self.n_hcu = sim.n_hcu
        self.device = sim.device
        self.slots = int(slots)
        self.step_ticks = int(step_ticks)
        self.ext_width = int(ext_width)
        self.conn = sim.conn
        self.be = sim.backend
        self.cap_fire = sim.cap_fire
        self._kw = dict(eager=sim.eager, merged=sim.merged,
                        worklist=sim.worklist, fused=sim.fused,
                        fused_cols=sim.fused_cols, cap_fire=sim.cap_fire,
                        layout=sim.layout)
        self.clock = clock
        # true copy: the Simulator updates its held state in place
        self.template = N.tree_map(lambda a: a.to(self.device, copy=True),
                                   sim.state)
        self.stacked = N.stack_sessions(self.template, self.slots)
        if self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self.graphs = [N.ChunkGraphs(pool) for _ in range(self.slots)]
        else:
            self.graphs = None
        self.capture_steps: list[dict] = []
        self._base_drops = N.drop_counters(self.template)
        self.queue = RequestQueue(queue_capacity)
        self.active: list[RecallRequest | None] = [None] * self.slots
        self._winners = np.full((self.slots, self.n_hcu), -1, np.int64)
        self._traj: list[list[np.ndarray]] = [[] for _ in range(self.slots)]
        self._drops_done = {"in": 0, "fire": 0, "route": 0}
        self.completed: list[RecallRequest] = []
        self.steps = 0
        self.monitor = monitor if monitor is not None else \
            ServingHealthMonitor(self.p, n_hcu=self.n_hcu * self.slots,
                                 queue_capacity=int(queue_capacity),
                                 req_rate=req_rate)
        self.monitor.begin(self._cum_drops(None, None, None))

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the lanes so far (0 on the CPU)."""
        return sum(len(g.captured) for g in self.graphs or ())

    # -- client API ----------------------------------------------------------
    def submit(self, req: RecallRequest) -> bool:
        req.submit_s = self.clock()
        return self.queue.offer(req)

    @property
    def busy(self) -> bool:
        return len(self.queue) > 0 or any(r is not None for r in self.active)

    def run(self, requests=None) -> list[RecallRequest]:
        """Submit `requests` (if given) and step until idle. Offers that
        find the queue full are rejected — pace submissions against
        `queue.free` for lossless closed-loop driving."""
        for r in requests or ():
            self.submit(r)
        while self.busy:
            self.step()
        return self.completed

    # -- engine step ---------------------------------------------------------
    def step(self) -> list[RecallRequest]:
        """Admit, advance every lane `step_ticks` ticks, retire finished
        sessions. Returns the sessions completed by this step."""
        now = self.clock()
        free = [i for i, r in enumerate(self.active) if r is None]
        newly = self.queue.take(len(free))
        if newly:
            # unused entries padded out of range, as the JAX package pads
            # its fixed-shape scatter; the copy is in place
            lanes = np.full((len(free),), self.slots, np.int32)
            for i, req in enumerate(newly):
                lane = free[i]
                lanes[i] = lane
                self.active[lane] = req
                req.lane = lane
                req.status = "active"
                req.admit_s = now
                self._winners[lane] = -1
                self._traj[lane] = []
            N.write_sessions(self.stacked, self.template, lanes)
        if not any(r is not None for r in self.active):
            return []

        ext = np.full((self.slots, self.step_ticks, self.n_hcu,
                       self.ext_width), self.p.rows, np.int32)
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            frame = np.full((self.n_hcu, self.ext_width), self.p.rows,
                            np.int32)
            mask = np.asarray(req.cue_mask, bool)
            frame[mask, 0] = np.asarray(req.cue_rows, np.int32)[mask]
            ext[lane] = frame[None]
        captured = self.captures
        self.monitor.chunk_start(self.step_ticks)
        t_step = time.perf_counter()
        fired = _serve_step(self.stacked, self.conn,
                            torch.from_numpy(ext).to(self.device), self.p,
                            self._kw, self.graphs)
        st = self.stacked
        # the step's one host read (it waits for the device): the fired
        # rows and the three drop counters of every lane
        out = torch.cat([fired.reshape(-1), st.drops_in, st.drops_fire,
                         st.drops_route]).cpu().numpy()
        if self.captures != captured:
            self.capture_steps.append({
                "step": self.steps, "graphs": self.captures - captured,
                "seconds": time.perf_counter() - t_step})
        self.steps += 1
        k = self.slots * self.step_ticks * self.n_hcu
        fired = out[:k].reshape(self.slots, self.step_ticks, self.n_hcu)
        d_in, d_fire, d_route = out[k:].reshape(3, self.slots)
        now = self.clock()
        done_now = []
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            f = fired[lane]
            self._traj[lane].append(f)
            step_w = _step_winners(f)
            upd = step_w >= 0
            changed = bool((step_w[upd] != self._winners[lane][upd]).any())
            self._winners[lane][upd] = step_w[upd]
            req.ticks += self.step_ticks
            # converged: every HCU has expressed a winner and a full step
            # passed without any winner flipping (a stable attractor);
            # unreachable on the very first step (winners start at -1)
            converged = (not changed) and bool((self._winners[lane] >= 0).all())
            if converged or req.ticks >= req.budget_ticks:
                req.status = "done" if converged else "expired"
                req.finish_s = now
                req.winners = self._winners[lane].copy()
                req.fired = np.concatenate(self._traj[lane], axis=0)
                req.drops = {
                    "in": int(d_in[lane]) - self._base_drops["in"],
                    "fire": int(d_fire[lane]) - self._base_drops["fire"],
                    "route": int(d_route[lane]) - self._base_drops["route"],
                }
                for key, v in req.drops.items():
                    self._drops_done[key] += v
                self.active[lane] = None
                self._traj[lane] = []
                self.completed.append(req)
                done_now.append(req)
        self.monitor.chunk_end(self.step_ticks,
                               self._cum_drops(d_in, d_fire, d_route))
        return done_now

    # -- accounting ----------------------------------------------------------
    def _cum_drops(self, d_in, d_fire, d_route) -> dict:
        """Cumulative session-attributed drops + request rejections, the
        dict the HealthMonitor prices per class. Free lanes (ticking on
        silence between sessions) are unattributed by design."""
        cum = dict(self._drops_done)
        if d_in is not None:
            for lane, req in enumerate(self.active):
                if req is None:
                    continue
                cum["in"] += int(d_in[lane]) - self._base_drops["in"]
                cum["fire"] += int(d_fire[lane]) - self._base_drops["fire"]
                cum["route"] += int(d_route[lane]) - self._base_drops["route"]
        cum["reject"] = self.queue.rejected
        return cum

    def stats(self, slo_ms: float | None = None) -> dict:
        """Structured serving report: queue counters, completion mix,
        latency percentiles, and the per-class drop-budget health verdict
        (the JAX package's schema, docs/SERVING.md)."""
        done = [r for r in self.completed if r.finish_s is not None]
        service = np.sort([r.service_ms for r in done]) if done else np.array([])
        sojourn = np.sort([r.sojourn_ms for r in done]) if done else np.array([])

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        out = {
            "slots": self.slots,
            "step_ticks": self.step_ticks,
            "steps": self.steps,
            "queue": self.queue.counters(),
            "completed": len(done),
            "done": sum(r.status == "done" for r in done),
            "expired": sum(r.status == "expired" for r in done),
            "p50_service_ms": pct(service, 50),
            "p95_service_ms": pct(service, 95),
            "p50_sojourn_ms": pct(sojourn, 50),
            "p95_sojourn_ms": pct(sojourn, 95),
            "health": self.monitor.report(),
        }
        if slo_ms is not None:
            out["slo_ms"] = float(slo_ms)
            p95 = out["p95_sojourn_ms"]
            out["slo_met"] = bool(p95 is not None and p95 <= slo_ms)
        return out


# ---------------------------------------------------------------------------
# demo CLI (toy scale)
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    from repro_torch.core import Simulator, test_scale

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--queue", type=int, default=8)
    ap.add_argument("--step-ticks", type=int, default=8)
    ap.add_argument("--budget", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="the Simulator's device (default: cuda)")
    args = ap.parse_args(argv)

    p = test_scale(n_hcu=8, rows=64, cols=8)
    sim = Simulator(p, key=0, cap_fire=p.n_hcu, device=args.device)
    srv = BCPNNRecallServer(sim, slots=args.slots, queue_capacity=args.queue,
                            step_ticks=args.step_ticks)
    rng = np.random.default_rng(0)
    pending = [RecallRequest(rid, rng.integers(0, p.rows, p.n_hcu),
                             rng.random(p.n_hcu) < 0.6,
                             budget_ticks=args.budget)
               for rid in range(args.requests)]
    t0 = time.perf_counter()
    while pending or srv.busy:
        while pending and srv.queue.free > 0:
            srv.submit(pending.pop(0))
        srv.step()
    dt = time.perf_counter() - t0
    s = srv.stats()
    print(f"served {s['completed']} sessions ({s['done']} converged, "
          f"{s['expired']} expired) on {sim.device} in {dt:.2f}s "
          f"({s['completed']/dt:.1f} qps), p95 service "
          f"{s['p95_service_ms']:.0f} ms, health={s['health']['status']}")


if __name__ == "__main__":
    main()
