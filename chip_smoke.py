#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero:

  1. device  — card name and power limit (nvidia-smi), torch and CUDA.
  2. build   — nvcc builds every kernel source of `repro_torch.kernels.csrc`.
  3. kernels — each of the five kernels against its plain PyTorch version on
               the card, on seeded inputs at the shapes the human-width paths
               give it (sentinel and padding entries included): integers
               exactly, floats rtol=1e-5, atol=1e-6 (weights atol=1e-5). Then
               each is timed with CUDA events (median of 20 launches, L2
               flushed before each) beside its plain version and its bound.
  4. fixtures — the head fixtures of tests/fixtures on the card through the
               kernels, each under the flags it was captured with
               (head_lazy_worklist in all four fused / fused_cols
               combinations, head_lazy_dense with worklist=False, head_eager
               with eager=True, head_host_lazy through `run_host`): the fired
               history and integer leaves exactly, float leaves to the CPU
               tests' tolerances.
  5. paths   — `Simulator(human_scale(n_hcu=256))`: R=10000, C=100, fanout
               100, 256 HCUs (5.1 GB of ij planes), Poisson input (lambda 4,
               width 8, seed 0). The main path (the fused worklist backend):
               16 warm-up ticks, then 200 timed ticks; the unfused worklist
               backend (fused=False, fused_cols=False) and the dense backend
               (worklist=False): 16 warm-up and 100 timed ticks each. The
               kernels' launch counters are set to 0 just before the timed
               ticks, which run under CUDA sync-debug mode "error", so a host
               synchronisation inside the tick fails the run. Each kernel of
               a path must have launched once per tick and no other kernel at
               all; planes finite; fired rate within 0.5x-2x of out_rate.
               Each path gets a 10-tick profile. Then the eager golden model
               (eager=True) runs 20 ticks beside the main path's first 20
               from the same key and input: the fired histories must be
               equal.
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
OTHER_TICKS = 100         # timed ticks of the unfused and dense paths
EAGER_TICKS = 20
PROFILE_TICKS = 10
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

    # -- unfused worklist row update --------------------------------------
    # the row phase's worklist compacted valid-first, sentinel past nv
    valid = rin["rows"] < n * R
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    nv_t = valid.sum().to(torch.int32).reshape(1)
    wl = dict(rows=torch.where(valid[order], rin["rows"][order], n * R),
              counts=rin["counts"][order], zj=rin["zj"][order],
              p_i=rin["p_i"][order], pj=rin["pj"][order])

    def wl_call(fn, pl):
        fn(*(pl[f] for f in names5), wl["rows"], nv_t, now, wl["counts"],
           wl["zj"], wl["p_i"], wl["pj"], k, eps)
    ker = {f: planes[f].clone() for f in names5}
    wl_call(BU.worklist_row_update_kernel, ker)
    torch.cuda.synchronize()
    pla = {f: planes[f].clone() for f in names5}
    wl_call(BU.worklist_row_update_plain, pla)
    torch.cuda.synchronize()
    errs = {f: check_close(f"worklist {f}", ker[f], pla[f],
                           atol=1e-5 if f == "wij" else 1e-6) for f in names5}
    print("worklist row kernel vs plain, max abs error:", json.dumps(errs))
    del pla
    ms = time_cuda(lambda: wl_call(BU.worklist_row_update_kernel, ker), flush)
    plain_ms = time_cuda(lambda: wl_call(BU.worklist_row_update_plain, ker),
                         flush)
    nv = int(nv_t)
    # a live entry reads z e p t zj pj and writes z e p w t (C cells each),
    # plus its row, count and p_i
    wl_bytes = nv * (11 * C * 4 + 12) + 8
    report.append(entry("worklist_row_update", errs, ms, plain_ms, wl_bytes,
                        nv * C * OPS_PER_CELL, "worklist_update_kernel_call"))
    print(f"worklist row kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{nv} live of {W} entries, {wl_bytes} bytes")
    del ker, planes
    torch.cuda.empty_cache()

    # -- gathered row blocks (dense backend) ------------------------------
    A = W // n
    rb = block_inputs((n, A, C), gen, dev)
    rb.update(counts=rin["counts"].reshape(n, A), p_i=rin["p_i"].reshape(n, A),
              zj=_rand(gen, dev, n, C) * 2, pj=_rand(gen, dev, n, C) * 0.1 + 1e-4)
    rb_call = lambda fn: fn(rb["zij"], rb["eij"], rb["pij"], rb["tij"], now,
                            rb["counts"], rb["zj"], rb["p_i"], rb["pj"], k,
                            eps)
    # reads z e p t, writes z e p w t per cell; counts, p_i per slot and
    # zj, pj per (HCU, column)
    rb_bytes = n * A * C * 9 * 4 + n * A * 8 + n * C * 8 + 4
    report.append(check_block("row_update", rb_call, flush, rb_bytes,
                              n * A * C * OPS_PER_CELL,
                              "row_update_kernel_call"))

    # -- gathered columns (dense backend, unfused column step) ------------
    K = cin["h_idx"].shape[0]
    cb = block_inputs((K, R), gen, dev)
    cb_call = lambda fn: fn(cb["zij"], cb["eij"], cb["pij"], cb["tij"], now,
                            cin["zi_t"], cin["p_i"], cin["pj_sc"], k, eps)
    # every entry is computed, padding included: reads z e p t zi_t p_i,
    # writes z e p w t per cell, and pj_sc per entry
    cb_bytes = K * R * 11 * 4 + K * 4 + 4
    report.append(check_block("col_update", cb_call, flush, cb_bytes,
                              K * R * OPS_PER_CELL, "col_update_kernel_call"))
    print(f"column blocks: {K} entries ({nf} fired) of {R} rows")
    return report


def _rand(gen, dev, *shape):
    import torch
    return torch.rand(*shape, generator=gen, device=dev)


def block_inputs(lead, gen, dev):
    """Gathered z, e, p, t blocks of shape lead."""
    import torch
    return dict(zij=_rand(gen, dev, *lead) * 2, eij=_rand(gen, dev, *lead) * 0.5,
                pij=_rand(gen, dev, *lead) * 0.05 + 1e-5,
                tij=torch.randint(0, NOW + 1, lead, generator=gen, device=dev,
                                  dtype=torch.int32))


def check_block(name, call, flush, nbytes, nops, tpu_fn):
    """A block kernel against its plain version, then both timed."""
    import torch
    from repro_torch.kernels import bcpnn_update as BU
    kernel = getattr(BU, f"{name}_kernel")
    plain = getattr(BU, f"{name}_plain")
    got = call(kernel)
    torch.cuda.synchronize()
    want = call(plain)
    torch.cuda.synchronize()
    errs = {f: check_close(f"{name} {f}", g, w,
                           atol=1e-5 if f == "wij" else 1e-6)
            for f, g, w in zip(("zij", "eij", "pij", "wij", "tij"), got, want)}
    print(f"{name} kernel vs plain, max abs error:", json.dumps(errs))
    del got, want
    ms = time_cuda(lambda: call(kernel), flush)
    plain_ms = time_cuda(lambda: call(plain), flush)
    print(f"{name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{nbytes} bytes")
    return entry(name, errs, ms, plain_ms, nbytes, nops, tpu_fn)


REPLACES = {
    "fused_row_update_kernel_call": "src/repro/kernels/bcpnn_update.py:335",
    "fused_col_update_kernel_call": "src/repro/kernels/bcpnn_update.py:451",
    "worklist_update_kernel_call": "src/repro/kernels/bcpnn_update.py:237",
    "row_update_kernel_call": "src/repro/kernels/bcpnn_update.py:170",
    "col_update_kernel_call": "src/repro/kernels/bcpnn_update.py:523",
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


# fixture -> the flags it was captured with (tests/fixtures/capture_head.py)
# and whether it ran the host-loop driver
FIXTURES = [("lazy_worklist", dict(worklist=True, fused=f, fused_cols=fc),
             False) for f in (True, False) for fc in (True, False)] + [
    ("lazy_dense", dict(worklist=False), False),
    ("eager", dict(eager=True), False),
    ("host_lazy", dict(worklist=False), True)]


def phase_fixtures(dev):
    """Phase 4: the head fixtures through the kernels on the card."""
    import torch
    from repro_torch import convert
    from repro_torch.core import Simulator
    from repro_torch.core.params import test_scale
    for name, kw, host in FIXTURES:
        d = dict(np.load(ROOT / "tests" / "fixtures" / f"head_{name}.npz"))
        sim = Simulator(test_scale(4, 64, 16), key=0, device=dev, **kw)
        for k, v in convert.conn_to_numpy(sim.conn).items():
            if not np.array_equal(v, d[k]):
                fail(f"fixture {name}: {k} differs")
        if host:
            ext = torch.from_numpy(d["ext"])
            fired = sim.run_host(lambda t: ext[t - 1], ext.shape[0])
        else:
            fired = sim.run(d["ext"])
        fired = fired.cpu().numpy()
        torch.cuda.synchronize()
        tag = f"{name} {json.dumps(kw)}{' run_host' if host else ''}"
        if not np.array_equal(fired, d["fired"]):
            fail(f"fixture {tag}: fired history differs")
        got = convert.state_to_numpy(sim.state)
        for k in INT_LEAVES:
            if not np.array_equal(got[k], d[k]):
                fail(f"fixture {tag}: {k} differs")
        gaps = {}
        for k in d:
            if k.startswith("hcus_") and k not in INT_LEAVES:
                rtol, atol = FIXTURE_TOL.get(k, FIXTURE_DEFAULT_TOL)
                diff = np.abs(got[k].astype(np.float64) - d[k])
                if not (diff <= atol + rtol * np.abs(d[k])).all():
                    fail(f"fixture {tag}: {k} max abs gap {diff.max()}")
                gaps[k] = float(diff.max())
        print(f"fixture {tag} on the card: fired history exact "
              f"({int((fired >= 0).sum())} spikes), integer leaves exact, "
              f"largest float gap {max(gaps.values()):.3g} "
              f"({max(gaps, key=gaps.get)})")


# path -> (Simulator flags, timed ticks, the kernels it must launch once
# per tick; every other kernel must not launch)
PATHS = {
    "fused": (dict(), TIMED_TICKS, ("fused_row_update", "fused_col_update")),
    "unfused": (dict(fused=False, fused_cols=False), OTHER_TICKS,
                ("worklist_row_update", "col_update")),
    "dense": (dict(worklist=False), OTHER_TICKS, ("row_update", "col_update")),
}
# the path whose launch count each kernel reports
REPORT_PATH = {"fused_row_update": "fused", "fused_col_update": "fused",
               "worklist_row_update": "unfused", "row_update": "dense",
               "col_update": "unfused"}
KERNEL_TAGS = {"fused_row_update": "fused_row_kernel",
               "fused_col_update": "fused_col_kernel",
               "worklist_row_update": "worklist_row_kernel",
               "row_update": "row_block_kernel",
               "col_update": "col_block_kernel"}


def check_state(name, sim, fired, p, ticks, t_end):
    import torch
    st = sim.state
    for f in ("zij", "eij", "pij", "wij", "zi", "ei", "pi", "zj", "ej", "pj", "h"):
        if not bool(torch.isfinite(getattr(st.hcus, f)).all()):
            fail(f"{name} path: non-finite values in {f}")
    if int(st.t) != t_end:
        fail(f"{name} path: t = {int(st.t)}")
    if tuple(fired.shape) != (ticks, p.n_hcu):
        fail(f"{name} path: fired history of shape {tuple(fired.shape)}")
    rate = float((fired >= 0).float().mean())
    if not 0.5 * p.out_rate <= rate <= 2 * p.out_rate:
        fail(f"{name} path: fired rate {rate} per HCU per tick")
    return rate


def run_path(name, p, ext):
    """One human-width path: warm-up, timed ticks under sync-debug "error"
    with the launch counters from 0, the checks, a 10-tick profile.
    Returns (launch counts, µs/tick, profile summary)."""
    import torch
    from repro_torch.core import Simulator
    from repro_torch.kernels import bcpnn_update as BU
    kw, ticks, expect = PATHS[name]
    t0 = time.perf_counter()
    sim = Simulator(p, key=0, **kw)              # the default device: CUDA
    torch.cuda.synchronize()
    print(f"{name} path: {type(sim.backend).__name__}{tuple(sim.backend)}, "
          f"init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sim.run(ext[:WARM_TICKS])
    torch.cuda.synchronize()
    for k in BU.launches:
        BU.launches[k] = 0
    # any operation that waits for the device inside the ticks raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    fired = sim.run(ext[WARM_TICKS:WARM_TICKS + ticks])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(BU.launches)
    for k, c in counts.items():
        want = ticks if k in expect else 0
        if c != want:
            fail(f"{name} path: {k} launched {c} times in {ticks} ticks, "
                 f"expected {want}")
    rate = check_state(name, sim, fired, p, ticks, WARM_TICKS + ticks)
    us = wall / ticks * 1e6
    print(f"{name} path: {ticks} ticks in {wall:.3f} s = {us:.1f} us/tick, "
          f"fired rate {rate:.4f} per HCU per tick, drops {sim.drops()}, "
          f"launches {json.dumps(counts)}")
    prof = profile_ticks(name, sim, ext[:PROFILE_TICKS], expect)
    del sim, fired
    torch.cuda.empty_cache()
    return counts, us, prof


def phase_eager(p, ext):
    """The eager golden model beside the main path's first ticks: equal
    fired histories."""
    import torch
    from repro_torch.core import Simulator
    lazy = Simulator(p, key=0)
    f_lazy = lazy.run(ext[:EAGER_TICKS]).cpu()
    del lazy
    torch.cuda.empty_cache()
    eager = Simulator(p, key=0, eager=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_eager = eager.run(ext[:EAGER_TICKS])
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / EAGER_TICKS * 1e6
    print(f"eager path: {EAGER_TICKS} ticks at {us:.1f} us/tick, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    rate = check_state("eager", eager, f_eager, p, EAGER_TICKS, EAGER_TICKS)
    if not torch.equal(f_eager.cpu(), f_lazy):
        diff = int((f_eager.cpu() != f_lazy).sum())
        fail(f"eager path: fired history differs from the lazy path's in "
             f"{diff} places")
    print(f"eager path: fired history equals the lazy path's over "
          f"{EAGER_TICKS} ticks ({int((f_lazy >= 0).sum())} spikes, rate "
          f"{rate:.4f})")
    prof = profile_ticks("eager", eager, ext[:PROFILE_TICKS], ())
    del eager
    torch.cuda.empty_cache()
    return us, prof


def phase_paths(report):
    """Phase 5: every path at human width through the kernels."""
    import torch
    from repro_torch.core.params import human_scale
    p = human_scale(n_hcu=256)
    ext = torch.from_numpy(ext_tensor(p, WARM_TICKS + TIMED_TICKS)).cuda()
    print(f"paths: human_scale(n_hcu=256) R={p.rows} C={p.cols} "
          f"fanout={p.fanout} A={p.active_queue}")
    runs = {name: run_path(name, p, ext) for name in PATHS}
    for e in report:
        e["launches"] = runs[REPORT_PATH[e["name"]]][0][e["name"]]
    eager_us, eager_prof = phase_eager(p, ext)
    summary = {name: {"us_per_tick": us, **prof}
               for name, (_, us, prof) in runs.items()}
    summary["eager"] = {"us_per_tick": eager_us, **eager_prof}
    print("paths summary:", json.dumps(summary))


# the phase functions of the tick, timed by name in the profile, and the
# hand-written kernels each launches: a kernel launched through ctypes has
# no torch operator above it, so the profiler does not count it inside the
# phase's range, and its time is added to the phase's by name
PHASES = (("repro_torch.core.engine", "worklist_lazy_rows",
           ("fused_row_update", "worklist_row_update")),
          ("repro_torch.core.hcu", "row_updates", ("row_update",)),
          ("repro_torch.core.engine", "_column_worklist", ("fused_col_update",)),
          ("repro_torch.core.engine", "column_updates_batched", ("col_update",)),
          ("repro_torch.core.reference", "eager_tick", ()))


def profile_ticks(name, sim, ext, kernels):
    """Device time of a path by kernel and by tick phase over 10 more ticks
    (torch.profiler; each phase function runs inside a `record_function`
    range of its name for the length of the profile). Returns a summary;
    prints "not measured" where the trace has no device time."""
    import importlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        def wrapper(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapper

    saved = []
    for mod, fn, _ in PHASES:
        m = importlib.import_module(mod)
        saved.append((m, fn, getattr(m, fn)))
        setattr(m, fn, ranged(getattr(m, fn), f"phase:{fn}"))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.run(ext)
            torch.cuda.synchronize()
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
    dev_t = lambda e, attr: getattr(e, f"{attr}device_time_total",
                                    getattr(e, f"{attr}cuda_time_total", 0))
    avgs = prof.key_averages()
    is_phase = lambda e: e.key.startswith("phase:")
    # kernel-level rows only: an operator's row also sums its kernels'
    # time, and a phase range also has a row on the device timeline (its
    # span, idle gaps included)
    rows = [(e.key, dev_t(e, "self_"), e.count) for e in avgs
            if e.device_type == DeviceType.CUDA and dev_t(e, "self_") > 0
            and not is_phase(e)]
    n = len(ext)
    if not rows:
        print(f"{name} profile: device time not measured (no CUDA activity "
              "in the trace)")
        return {"device_busy_us_per_tick": None}
    total = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if tag in r[0]) / n
            for k, tag in KERNEL_TAGS.items()}
    # a phase's host-side range sums the device time of the torch ops'
    # kernels inside it; its hand-written kernels are added by name
    launched = {fn: ks for _, fn, ks in PHASES}
    phases = {}
    for e in avgs:
        if is_phase(e) and e.device_type == DeviceType.CPU:
            fn = e.key[len("phase:"):]
            phases[fn] = (dev_t(e, "") / n
                          + sum(ours[k] for k in launched[fn]))
    ours = {k: ours[k] for k in kernels}
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                   and not is_phase(e)), key=lambda e: -e.self_cpu_time_total)
    host_total = sum(e.self_cpu_time_total for e in host) / n
    print(f"{name} profile over {n} ticks: device busy {total / n:.1f} "
          f"us/tick in {sum(r[2] for r in rows) / n:.0f} device ops/tick"
          + "".join(f"; {k} {v:.1f} us/tick" for k, v in ours.items())
          + "; phases (device us/tick of all their kernels) "
          + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
    for key, t, c in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  device {t / n:9.1f} us/tick {c / n:6.1f}/tick  {key[:80]}")
    print(f"  host ops' self time {host_total:.1f} us/tick (profiled), top:")
    for e in host[:6]:
        print(f"  host {e.self_cpu_time_total / n:9.1f} us/tick "
              f"{e.count / n:6.1f}/tick  {e.key[:60]}")
    return {"device_busy_us_per_tick": total / n,
            "device_ops_per_tick": sum(r[2] for r in rows) / n,
            "kernel_us_per_tick": ours, "phase_device_us_per_tick": phases}


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
    phase_fixtures(dev)
    phase_paths(report)
    print("kernels' library_ms is null: no single PyTorch call computes "
          "a cell-math pass")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
