"""Does a CUDA-graph capture of the BCPNN tick need its kernels loaded
first? Each local path in a fresh process, at BCPNNParams(n_hcu=8,
rows=1200, cols=70): 12 ticks through `Simulator.run(chunk=5)` (two
captures), once with `network._load_kernels` (the scratch tick before
the first capture) switched off and once with it: the run's time, the
chunk lengths captured, and the fired history against the per-tick
driver.

    python3 tools/graph_probes/lazy_loading.py    # from the repository root, on a CUDA card
"""
import json
import os
import subprocess
import sys
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHILD = r'''
import sys, json, time, traceback
sys.path.insert(0, "src")
import numpy as np, torch
from repro_torch.core import Simulator, network as N
from repro_torch.core.params import BCPNNParams
from repro_torch.kernels import _build
path, preload = sys.argv[1], sys.argv[2]
kw = {"fused": {}, "unfused": dict(fused=False, fused_cols=False),
      "dense": dict(worklist=False), "eager": dict(eager=True),
      "blocked": dict(layout="blocked")}[path]
if preload == "none":
    N._load_kernels = lambda *a, **k: None
p = BCPNNParams(n_hcu=8, rows=1200, cols=70, fanout=8, active_queue=16)
rs = np.random.default_rng(0)
ext = np.full((12, 8, 8), p.rows, np.int32)
for t in range(12):
    for h in range(8):
        n = min(8, rs.poisson(4.0)); ext[t, h, :n] = rs.integers(0, p.rows, n)
ext = torch.from_numpy(ext).cuda()
_build.build_all()
out = {"path": path, "preload": preload}
try:
    g = Simulator(p, key=0, chunk=5, **kw)
    t0 = time.perf_counter()
    f = g.run(ext); torch.cuda.synchronize()
    out["capture_s"] = time.perf_counter() - t0
    out["captures"] = list(g.graphs.captured)
    tk = Simulator(p, key=0, **kw)
    want = torch.stack([tk.tick(e) for e in ext])
    out["equal"] = bool(torch.equal(f, want))
    out["ok"] = True
except Exception as e:
    out["ok"] = False
    out["error"] = traceback.format_exc()[-1500:]
print("PROBE", json.dumps(out))
'''
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version", "--format=csv,noheader"], capture_output=True, text=True).stdout)
import torch
print("torch", torch.__version__, torch.version.cuda, "CUDA_MODULE_LOADING", os.environ.get("CUDA_MODULE_LOADING"))
for preload in ("none", "scratch_tick"):
    for path in ("fused", "unfused", "dense", "eager", "blocked"):
        r = subprocess.run([sys.executable, "-c", CHILD, path, preload], cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = [l for l in r.stdout.splitlines() if l.startswith("PROBE")]
        print(lines[0] if lines else f"PROBE {path} {preload} rc={r.returncode} {r.stderr[-1500:]}", flush=True)
