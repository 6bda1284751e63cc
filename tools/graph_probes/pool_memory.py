"""How much device memory the CUDA-graph driver's captures take, by chunk
length, at human_scale(n_hcu=256). For the fused path and the eager one:
the process's first capture of the backend (its scratch tick, then a
one-tick graph), then chunks of 8, 32, 128 and 256 ticks (eager: 8, 32
and 128), each on fresh graphs: the peak allocated during the call over
what was allocated before it, and what stays allocated and reserved after
it. Then the allocator's memory history of two calls (the first capture
of the unfused backend, and a 32-tick fused capture): the tensors alive
at each one's peak, by the line of the port that allocated them.

Only `Simulator.run` and torch's allocator statistics are used, so the
script measures another tree of the port as well (SRC: that tree's `src`
directory; default this checkout's):

    python3 tools/graph_probes/pool_memory.py [SRC]    # on a CUDA card
"""
import collections
import json
import os
import subprocess
import sys
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)
import numpy as np, torch
from repro_torch.core import Simulator
from repro_torch.core.params import human_scale
from repro_torch.kernels import _build
_build.build_all()
MiB = 2 ** 20
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), "src", SRC)
p = human_scale(n_hcu=256)
rs = np.random.default_rng(0)
T = 1500
ext = np.full((T, p.n_hcu, 8), p.rows, np.int32)
cnt = np.minimum(8, rs.poisson(4.0, (T, p.n_hcu)))
for k in range(8):
    ext[:, :, k] = np.where(cnt > k, rs.integers(0, p.rows, (T, p.n_hcu)), p.rows)
ext = torch.from_numpy(ext).cuda()


def measure(run):
    """``run()``'s memory over what was allocated before it."""
    torch.cuda.synchronize(); torch.cuda.empty_cache()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    run(); torch.cuda.synchronize()
    return {"peak_mib": (torch.cuda.max_memory_allocated() - alloc0) / MiB,
            "allocated_after_mib": (torch.cuda.memory_allocated() - alloc0) / MiB,
            "reserved_after_mib": (torch.cuda.memory_reserved() - res0) / MiB}


def origin(frames):
    for fr in frames:
        if "repro_torch" in fr["filename"]:
            return f"{fr['filename'].split('repro_torch/')[-1]}:{fr['line']} {fr['name']}"
    return "(no frame of the port)"


def alive_at_peak(tag, run):
    """Replay the allocator's history of ``run()``: the tensors alive at its
    peak, by the line of the port that allocated them."""
    torch.cuda.synchronize(); torch.cuda.empty_cache()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    run(); torch.cuda.synchronize()
    trace = torch.cuda.memory._snapshot()["device_traces"]
    torch.cuda.memory._record_memory_history(enabled=None)
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in (e for dev in trace for e in dev):
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    by = collections.defaultdict(lambda: [0, 0])
    for size, frames in at_peak.values():
        v = by[origin(frames)]; v[0] += size; v[1] += 1
    print("PEAK", tag, json.dumps({"peak_mib_over_start": peak / MiB,
          "tensors": len(at_peak)}), flush=True)
    for line, (size, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"PEAK_ALIVE {tag} {size / MiB:9.3f} MiB in {n:5d} tensors  {line}", flush=True)


for path, kw, chunks in (("fused", {}, (8, 32, 128, 256)),
                         ("eager", dict(eager=True), (8, 32, 128))):
    sim = Simulator(p, key=0, **kw)
    # the process's first capture of the backend: its scratch tick, then
    # a one-tick graph
    mem = measure(lambda: sim.run(ext[:1], chunk=1))
    print("MEM", json.dumps({"path": path, "chunk": "first capture (1 tick, "
          "after the scratch tick)", **mem}), flush=True)
    t = 1
    for chunk in chunks:
        sim.graphs.clear()
        mem = measure(lambda: sim.run(ext[t:t + chunk], chunk=chunk))
        t += chunk
        print("MEM", json.dumps({"path": path, "chunk": chunk, **mem,
              "peak_mib_per_tick": mem["peak_mib"] / chunk}), flush=True)
    del sim
    torch.cuda.empty_cache()

# what is alive at the peaks: a fresh process's first fused capture is
# gone by now, so a new backend (unfused) stands in for it; then a
# 32-tick fused capture
sim = Simulator(p, key=0, fused=False, fused_cols=False)
alive_at_peak("unfused_first_capture", lambda: sim.run(ext[:1], chunk=1))
del sim
sim = Simulator(p, key=0)
sim.run(ext[:1], chunk=1)
sim.graphs.clear()
alive_at_peak("fused_32", lambda: sim.run(ext[1:33], chunk=32))
