#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero:

  1. device  — card name and power limit (nvidia-smi), torch and CUDA.
  2. build   — nvcc builds every kernel source of `repro_torch.kernels.csrc`.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               seeded inputs at the shapes the human-width main path gives
               it (sentinel and padding entries included): integers exactly,
               floats rtol=1e-5, atol=1e-6 (weights atol=1e-5). Then each is
               timed with CUDA events (median of 20 launches, L2 flushed
               before each) beside its plain version and its bound.
  4. fixture — tests/fixtures/head_lazy_worklist.npz on the card through the
               kernels: the fired history and integer leaves exactly, float
               leaves to the CPU tests' tolerances.
  5. main path — `Simulator(human_scale(n_hcu=256))`: R=10000, C=100,
               fanout 100, 256 HCUs (5.1 GB of ij planes), Poisson input
               (lambda 4, width 8, seed 0): 16 warm-up ticks, then 200 timed
               ticks with the kernels' launch counters set to 0 just before.
               The timed ticks run under CUDA sync-debug mode "error", so a
               host synchronisation inside the tick fails the run. Each
               kernel must have launched once per tick; planes finite;
               fired rate within 0.5x-2x of out_rate.
  6. report  — one JSON line of the kernels, then the last line
               {"ok": true, "device": {...}}.

It imports the port only (never JAX or the JAX package) and exits non-zero
without printing a result where no CUDA device is present.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SECTOR = 32                   # bytes per DRAM/L2 sector
OPS_PER_CELL = 33             # float32 ops of cell_math, transcendentals as one
NOW = 100
N_TIMED = 20
WARM_TICKS, TIMED_TICKS = 16, 200
# float tolerances of the CPU contract (tests/test_torch_engine.py)
FIXTURE_TOL = {"hcus_wij": (4e-6, 4e-6), "hcus_h": (4e-6, 1e-4)}
FIXTURE_DEFAULT_TOL = (4e-6, 4e-7)
INT_LEAVES = ("hcus_tij", "hcus_ti", "delay_rows", "delay_count", "t",
              "drops_in", "drops_fire")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ext_tensor(p, T, width=8, lam=4.0, seed=0):
    """Poisson external input, as benchmarks/tick_loop.py stages it."""
    rng = np.random.default_rng(seed)
    out = np.full((T, p.n_hcu, width), p.rows, np.int32)
    for t in range(T):
        for h in range(p.n_hcu):
            n = min(width, rng.poisson(lam))
            out[t, h, :n] = rng.integers(0, p.rows, n)
    return out


def max_err(got, want):
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_close(name, got, want, rtol=1e-5, atol=1e-6):
    """Integers exactly, floats |got - want| <= atol + rtol |want|; returns
    the max abs error."""
    import torch
    if got.dtype in (torch.int32, torch.int64):
        if not torch.equal(got, want):
            fail(f"{name}: integers differ")
        return 0.0
    ok = ((got - want).abs() <= atol + rtol * want.abs()).all()
    err = max_err(got, want)
    if not bool(ok):
        fail(f"{name}: max abs error {err} beyond rtol={rtol}, atol={atol}")
    return err


def time_cuda(fn, flush):
    """Median ms of N_TIMED calls, each timed alone with CUDA events after
    the L2 cache is flushed by reading a buffer larger than it (a read
    leaves no dirty lines for the timed call to write back); two warm-up
    calls first."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(N_TIMED):
        flush.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def row_inputs(p, gen, dev):
    """Row-phase operands at the main path's shapes: W = H*(active_queue+8)
    slot-ordered entries, ~14 unique rows per HCU (the delay-queue and
    external spikes a tick brings at lambda 4 and out_rate 0.1), the rest
    the H*R sentinel."""
    import torch
    n, R, C = p.n_hcu, p.rows, p.cols
    A = p.active_queue + 8
    HR, W = n * R, n * A
    k = 14
    pick = torch.rand(n, R, generator=gen, device=dev).argsort(dim=1)[:, :k]
    pick = pick.sort(dim=1).values
    pick[-1, -1] = R - 1                                   # the last row
    rows = torch.full((n, A), HR, dtype=torch.int32, device=dev)
    rows[:, :k] = (torch.arange(n, device=dev)[:, None] * R + pick).to(torch.int32)
    rows = rows.reshape(-1)
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    valid = rows < HR
    return dict(
        rows=rows,
        counts=torch.where(valid, torch.randint(1, 4, (W,), generator=gen,
                                                device=dev).float(), 0.0),
        zj=u(W, C) * 2, p_i=u(W) * 0.1 + 1e-4, pj=u(W, C) * 0.1 + 1e-4,
        zi_new=u(W) * 3, ei_new=u(W) * 0.5, pi_new=u(W) * 0.1 + 1e-4)


def col_inputs(p, gen, dev):
    """Column-phase operands at the main path's shapes: K = int(0.35 H)+1
    entries, out_rate * H of them fired (26 of 256) with unique HCUs, the
    last one at the last HCU's last column, the rest padding (h == H)."""
    import torch
    n, R, C = p.n_hcu, p.rows, p.cols
    K = max(2, int(0.35 * n) + 1)
    fired = max(1, round(p.out_rate * n))
    h = torch.full((K,), n, dtype=torch.int32, device=dev)
    h[:fired] = torch.randperm(n - 1, generator=gen, device=dev)[:fired].to(torch.int32)
    h[fired - 1] = n - 1
    j = torch.zeros(K, dtype=torch.int32, device=dev)
    j[:fired] = torch.randint(0, C, (fired,), generator=gen, device=dev,
                              dtype=torch.int32)
    j[fired - 1] = C - 1
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    return dict(h_idx=h, j_idx=j, zi_t=u(K, R) * 3, p_i=u(K, R) * 0.1 + 1e-4,
                pj_sc=u(K) * 0.1 + 1e-4)


def random_planes(p, gen, dev):
    import torch
    HR, C = p.n_hcu * p.rows, p.cols
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    return dict(
        zij=u(HR, C) * 2, eij=u(HR, C) * 0.5, pij=u(HR, C) * 0.05 + 1e-5,
        wij=torch.randn(HR, C, generator=gen, device=dev),
        tij=torch.randint(0, NOW + 1, (HR, C), generator=gen, device=dev,
                          dtype=torch.int32),
        zi=u(HR) * 2, ei=u(HR) * 0.5, pi=u(HR) * 0.1 + 1e-4,
        ti=torch.randint(0, NOW + 1, (HR,), generator=gen, device=dev,
                         dtype=torch.int32))


def phase_kernels(p, dev):
    """Phase 3: each kernel against its plain version, then timed."""
    import torch
    from repro_torch.core import hcu as H
    from repro_torch.kernels import bcpnn_update as BU
    k, eps = H.coeffs_ij(p), p.eps
    n, R, C = p.n_hcu, p.rows, p.cols
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    planes = random_planes(p, gen, dev)
    now = torch.tensor(NOW, dtype=torch.int32, device=dev)
    rin, cin = row_inputs(p, gen, dev), col_inputs(p, gen, dev)
    flush = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    names9 = ("zij", "eij", "pij", "wij", "tij", "zi", "ei", "pi", "ti")
    names5 = names9[:5]
    report = []

    # -- row phase --------------------------------------------------------
    def row_call(fn, pl):
        return fn(*(pl[f] for f in names9), rin["rows"], now, rin["counts"],
                  rin["zj"], rin["p_i"], rin["pj"], rin["zi_new"],
                  rin["ei_new"], rin["pi_new"], k, eps)
    ker = {f: t.clone() for f, t in planes.items()}
    wrow_k = row_call(BU.fused_row_update_kernel, ker)
    torch.cuda.synchronize()
    pla = {f: t.clone() for f, t in planes.items()}
    wrow_p = row_call(BU.fused_row_update_plain, pla)
    torch.cuda.synchronize()
    errs = {f: check_close(f"row {f}", ker[f], pla[f],
                           atol=1e-5 if f == "wij" else 1e-6) for f in names9}
    errs["wrow"] = check_close("row wrow", wrow_k, wrow_p, atol=1e-5)
    print("row kernel vs plain, max abs error:", json.dumps(errs))
    del pla
    ms = time_cuda(lambda: row_call(BU.fused_row_update_kernel, ker), flush)
    plain_ms = time_cuda(lambda: row_call(BU.fused_row_update_plain, ker), flush)
    nv = int((rin["rows"] < n * R).sum())
    W = rin["rows"].shape[0]
    row_bytes = nv * C * 4 * 12 + (W - nv) * C * 4 + W * 4 * 6 + nv * 4 * 4
    row_ops = nv * C * OPS_PER_CELL
    report.append(entry("fused_row_update", errs, ms, plain_ms, row_bytes,
                        row_ops, "fused_row_update_kernel_call"))
    print(f"row kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{nv} valid of {W} slots, {row_bytes} bytes")

    # -- column phase -----------------------------------------------------
    def col_call(fn, pl):
        fn(*(pl[f] for f in names5), cin["h_idx"], cin["j_idx"], now,
           cin["zi_t"], cin["p_i"], cin["pj_sc"], k, eps, n, R)
    ker = {f: planes[f].clone() for f in names5}
    col_call(BU.fused_col_update_kernel, ker)
    torch.cuda.synchronize()
    pla = {f: planes[f].clone() for f in names5}
    col_call(BU.fused_col_update_plain, pla)
    torch.cuda.synchronize()
    errs = {f: check_close(f"col {f}", ker[f], pla[f],
                           atol=1e-5 if f == "wij" else 1e-6) for f in names5}
    print("column kernel vs plain, max abs error:", json.dumps(errs))
    del pla
    ms = time_cuda(lambda: col_call(BU.fused_col_update_kernel, ker), flush)
    plain_ms = time_cuda(lambda: col_call(BU.fused_col_update_plain, ker), flush)
    nf = int((cin["h_idx"] < n).sum())
    K = cin["h_idx"].shape[0]
    # 9 strided plane accesses per cell (read z e p t, write z e p w t),
    # a 32-byte sector each; zi_t and p_i are contiguous
    col_bytes = nf * R * (9 * SECTOR + 8) + K * 12
    col_ops = nf * R * OPS_PER_CELL
    report.append(entry("fused_col_update", errs, ms, plain_ms, col_bytes,
                        col_ops, "fused_col_update_kernel_call"))
    print(f"column kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{nf} fired of {K} entries, {col_bytes} bytes "
          f"({nf * R * (9 * 4 + 8)} if cells moved 4 bytes each)")
    del ker, planes
    torch.cuda.empty_cache()
    return report


REPLACES = {
    "fused_row_update_kernel_call": "src/repro/kernels/bcpnn_update.py:335",
    "fused_col_update_kernel_call": "src/repro/kernels/bcpnn_update.py:451",
}


def entry(name, errs, ms, plain_ms, nbytes, nops, tpu_fn):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bcpnn_update.cu",
            "replaces": REPLACES[tpu_fn], "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_fixture(dev):
    """Phase 4: the head fixture through the kernels on the card."""
    import torch
    from repro_torch import convert
    from repro_torch.core import Simulator
    from repro_torch.core.params import test_scale
    d = dict(np.load(ROOT / "tests" / "fixtures" / "head_lazy_worklist.npz"))
    sim = Simulator(test_scale(4, 64, 16), key=0, device=dev)
    for k, v in convert.conn_to_numpy(sim.conn).items():
        if not np.array_equal(v, d[k]):
            fail(f"fixture: {k} differs")
    fired = sim.run(d["ext"]).cpu().numpy()
    torch.cuda.synchronize()
    if not np.array_equal(fired, d["fired"]):
        fail("fixture: fired history differs")
    got = convert.state_to_numpy(sim.state)
    for k in INT_LEAVES:
        if not np.array_equal(got[k], d[k]):
            fail(f"fixture: {k} differs")
    gaps = {}
    for k in d:
        if k.startswith("hcus_") and k not in INT_LEAVES:
            rtol, atol = FIXTURE_TOL.get(k, FIXTURE_DEFAULT_TOL)
            diff = np.abs(got[k].astype(np.float64) - d[k])
            if not (diff <= atol + rtol * np.abs(d[k])).all():
                fail(f"fixture: {k} max abs gap {diff.max()}")
            gaps[k] = float(diff.max())
    print(f"fixture head_lazy_worklist on the card: fired history exact "
          f"({int((fired >= 0).sum())} spikes), integer leaves exact, "
          f"float gaps {json.dumps(gaps)}")


def phase_main(report):
    """Phase 5: the main path at human width through the kernels."""
    import torch
    from repro_torch.core import Simulator
    from repro_torch.core.params import human_scale
    from repro_torch.kernels import bcpnn_update as BU
    p = human_scale(n_hcu=256)
    t0 = time.perf_counter()
    sim = Simulator(p, key=0)                    # the default device: CUDA
    ext = torch.from_numpy(ext_tensor(p, WARM_TICKS + TIMED_TICKS)).cuda()
    torch.cuda.synchronize()
    print(f"main path: human_scale(n_hcu=256) R={p.rows} C={p.cols} "
          f"fanout={p.fanout} A={p.active_queue}, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sim.run(ext[:WARM_TICKS])
    torch.cuda.synchronize()
    for name in BU.launches:
        BU.launches[name] = 0
    # any operation that waits for the device inside the ticks raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    fired = sim.run(ext[WARM_TICKS:])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(BU.launches)
    for e in report:
        e["launches"] = counts[e["name"]]
        if counts[e["name"]] != TIMED_TICKS:
            fail(f"{e['name']} launched {counts[e['name']]} times in "
                 f"{TIMED_TICKS} ticks")
    st = sim.state
    for f in ("zij", "eij", "pij", "wij", "zi", "ei", "pi", "zj", "ej", "pj", "h"):
        if not bool(torch.isfinite(getattr(st.hcus, f)).all()):
            fail(f"main path: non-finite values in {f}")
    if int(st.t) != WARM_TICKS + TIMED_TICKS:
        fail(f"main path: t = {int(st.t)}")
    if tuple(fired.shape) != (TIMED_TICKS, p.n_hcu):
        fail(f"main path: fired history of shape {tuple(fired.shape)}")
    rate = float((fired >= 0).float().mean())
    if not 0.5 * p.out_rate <= rate <= 2 * p.out_rate:
        fail(f"main path: fired rate {rate} per HCU per tick")
    us = wall / TIMED_TICKS * 1e6
    print(f"main path: {TIMED_TICKS} ticks in {wall:.3f} s = {us:.1f} us/tick, "
          f"fired rate {rate:.4f} per HCU per tick, drops {sim.drops()}, "
          f"launches {json.dumps(counts)}")
    profile_ticks(sim, ext[:10])
    return us


def profile_ticks(sim, ext):
    """Device time of the main path by kernel over 10 more ticks
    (torch.profiler); prints "not measured" where the trace has none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(ext)
        torch.cuda.synchronize()
    # kernel-level rows only: an operator's row also sums its kernels' time
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
    rows = [(e.key, dev_t(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_t(e) > 0]
    if not rows:
        print("profile: device time not measured (no CUDA activity in the trace)")
        return
    total = sum(r[1] for r in rows)
    ours = {name: sum(r[1] for r in rows if tag in r[0])
            for name, tag in (("fused_row_update", "fused_row_kernel"),
                              ("fused_col_update", "fused_col_kernel"))}
    n = len(ext)
    print(f"profile over {n} ticks: device busy {total / n:.1f} us/tick in "
          f"{sum(r[2] for r in rows) / n:.0f} device ops/tick; "
          + ", ".join(f"{k} {v / n:.1f} us/tick" for k, v in ours.items()))
    top = sorted(rows, key=lambda r: -r[1])[:8]
    for key, t, c in top:
        print(f"  {t / n:9.1f} us/tick {c / n:6.1f}/tick  {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built} in {time.perf_counter() - t0:.2f} s")

    from repro_torch.core.params import human_scale
    dev = torch.device("cuda")
    report = phase_kernels(human_scale(n_hcu=256), dev)
    phase_fixture(dev)
    phase_main(report)
    print("kernels' library_ms is null: no single PyTorch call computes "
          "either worklist phase")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
