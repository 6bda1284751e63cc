"""Where the CUDA-graph driver's time goes by chunk length, on the fused
path at human_scale(n_hcu=256). For chunks of 8, 32, 128 and 256 ticks,
each on its own graphs: the first call's time (capture, instantiation,
one replay) and the graph's node count; the host's time inside one
`graph.replay()` and one replay's device span (CUDA events); and two
256-tick `Simulator.run` calls' host-return and end-to-end µs/tick.

    python3 tools/graph_probes/chunk_length.py    # from the repository root, on a CUDA card
"""
import json
import os
import subprocess
import sys
import time
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
import numpy as np, torch
from chip_smoke import graph_nodes
from repro_torch.core import Simulator
from repro_torch.core.params import human_scale
from repro_torch.kernels import _build
_build.build_all()
smi = lambda: subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(smi())
p = human_scale(n_hcu=256)
rs = np.random.default_rng(0)
T = 3000          # every chunk's capture and runs, from one input
ext = np.full((T, p.n_hcu, 8), p.rows, np.int32)
cnt = np.minimum(8, rs.poisson(4.0, (T, p.n_hcu)))
for k in range(8):
    m = cnt > k
    ext[:, :, k] = np.where(m, rs.integers(0, p.rows, (T, p.n_hcu)), p.rows)
ext = torch.from_numpy(ext).cuda()
sim = Simulator(p, key=0)
sim.run(ext[:1], chunk=1)        # the backend's scratch tick, before any count
t = 1
def take(n):
    global t
    e = ext[t:t + n]; t += n; return e
for chunk in (8, 32, 128, 256):
    sim.graphs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(take(chunk), chunk=chunk); torch.cuda.synchronize()
    first = time.perf_counter() - t0
    g = sim.graphs.captured[chunk]
    launch, span = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); t0 = time.perf_counter(); g.replay(); launch.append(time.perf_counter() - t0); b.record()
        torch.cuda.synchronize(); span.append(a.elapsed_time(b))
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter(); sim.run(take(256), chunk=chunk); enq = time.perf_counter() - t0
        torch.cuda.synchronize(); wall = time.perf_counter() - t0
        runs.append((enq / 256 * 1e6, wall / 256 * 1e6))
    print("CHUNK", json.dumps({"chunk": chunk, "first_call_s": first, "nodes": graph_nodes(g),
          "replay_host_ms": [x * 1e3 for x in launch], "replay_device_ms": span,
          "replay_device_us_per_tick": [x * 1e3 / chunk for x in span],
          "run256_enqueue_wall_us_per_tick": runs}), flush=True)

print(smi())
