"""Is the fused path's device time a tick under CUDA-graph replay a
property of the capture, of the process or of time? At
human_scale(n_hcu=256), capture a 128-tick chunk five times on one held
state; replay each capture six times alone and four times through
`Simulator.run`, each timed by CUDA events, beside the card's clocks;
then 32 per-tick ticks and one more replay.

    python3 tools/graph_probes/recapture.py    # from the repository root, on a CUDA card
"""
import json
import subprocess
import sys
import time
sys.path.insert(0, "src")
import numpy as np, torch
from repro_torch.core import Simulator
from repro_torch.core.params import human_scale
from repro_torch.kernels import _build
_build.build_all()
smi = lambda: subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,power.draw,pstate", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(smi())
p = human_scale(n_hcu=256)
rs = np.random.default_rng(0)
T = 128
ext = np.full((T, p.n_hcu, 8), p.rows, np.int32)
cnt = np.minimum(8, rs.poisson(4.0, (T, p.n_hcu)))
for k in range(8):
    ext[:, :, k] = np.where(cnt > k, rs.integers(0, p.rows, (T, p.n_hcu)), p.rows)
ext = torch.from_numpy(ext).cuda()
sim = Simulator(p, key=0)
for cap in range(5):
    sim.graphs.clear()
    t0 = time.perf_counter()
    sim.run(ext)          # capture + one replay
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    g = sim.graphs.captured[T]
    per = []
    for r in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); g.replay(); b.record(); torch.cuda.synchronize()
        per.append(round(a.elapsed_time(b) * 1e3 / T, 1))
    # the same replays through the driver, back to back
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for r in range(4):
        sim.run(ext)
    b.record(); torch.cuda.synchronize()
    print("CAPTURE", cap, json.dumps({"first_call_s": first,
          "replay_us_per_tick": per, "run4x_us_per_tick": a.elapsed_time(b) * 1e3 / (4 * T)}), smi(), flush=True)
# per-tick driver for reference, then graphs again
t = Simulator(p, key=0)
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
for e in ext[:8]: t.tick(e)
torch.cuda.synchronize()
a.record()
for e in ext[8:40]: t.tick(e)
b.record(); torch.cuda.synchronize()
print("PER_TICK device span us/tick", a.elapsed_time(b) * 1e3 / 32)
del t
a.record(); sim.run(ext); b.record(); torch.cuda.synchronize()
print("GRAPH after per-tick us/tick", a.elapsed_time(b) * 1e3 / T, smi())
