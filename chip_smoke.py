#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero:

  1. device  — card name and power limit (nvidia-smi), torch and CUDA.
  2. build   — nvcc builds every kernel source of `repro_torch.kernels.csrc`;
               prints the flash kernels' registers and spills (ptxas -v).
  3. kernels — each of the five kernels against its plain PyTorch version on
               the card, on seeded inputs at the shapes the human-width paths
               give it (sentinel and padding entries included): integers
               exactly, floats rtol=1e-5, atol=1e-6 (weights atol=1e-5). The
               three worklist kernels run on planes stored in each layout of
               LAYOUTS (flat, the tiles (xr, 4) for xr = 2 to 32, and
               (7, 5)), every stored cell compared, pad cells included.
               Then each is
               timed with CUDA events (median of 20 launches, L2 flushed
               before each), the worklist kernels under every layout, beside
               the plain version (flat) and two bounds: the function's bytes
               and the layout's 32-byte sectors
               (`layout.cache_lines_touched_per_s(..., line_bytes=32)`),
               and beside time_cuda's floor (an empty kernel,
               `torch.cuda._sleep(0)`, timed the same way). The unfused
               worklist kernel reads the slot-ordered worklist through its
               compaction (order, nv) and the (H, C) j-vectors in place.
               The (xr, 4) tile with the least row + column kernel time is
               the tile phase 5's fused_blocked path runs.
  4. fixtures — the head fixtures of tests/fixtures on the card through the
               kernels, each under the flags it was captured with
               (head_lazy_worklist in all four fused / fused_cols
               combinations, head_lazy_dense with worklist=False, head_eager
               with eager=True, head_host_lazy through `run_host`,
               head_merged_dense with merged=True, worklist=False and
               head_merged_worklist with merged=True, worklist=True), the
               five lazy ones again with the planes stored in tiles (8, 4)
               and (7, 5), and the two merged ones in both tiles too (their
               rings `jring` held exactly with the integer leaves). Each
               runs on the per-tick driver
               (`Simulator.tick`, or `run_host`), then on the CUDA-graph
               driver (`Simulator.run`) at chunks of 128 (one 40-tick graph)
               and 7 (graphs of 7 and 5 ticks): every run holds the fired
               history and integer leaves exactly and float leaves to the
               CPU tests' tolerances, after unpacking, and every graph run
               equals the per-tick run bit for bit.
  5. paths   — `Simulator(human_scale(n_hcu=256))`: R=10000, C=100, fanout
               100, 256 HCUs (5.1 GB of ij planes), Poisson input (lambda 4,
               width 8, seed 0). The main path (the fused worklist backend,
               200 timed ticks), the same backend with the planes stored in
               phase 3's tile (fused_blocked), the unfused worklist backend
               (fused=False, fused_cols=False), the dense backend
               (worklist=False), 100 timed ticks each, and the eager golden
               model (eager=True), 20. Each path first runs through the
               CUDA-graph driver (`Simulator.run`, chunk 128): warm-up ticks
               capture every chunk length the timed ticks replay, one call a
               capture (each first call timed, each graph's nodes counted),
               and the wrappers' launch counters must show one launch of
               each kernel of the path per captured tick; two timed runs
               back to back replay only (host µs/tick, the device's span by
               CUDA events and the SM clock sampled by nvidia-smi), the
               counters required to stay 0; a device-only trace of one more
               run of as many ticks (also under sync-debug "error") counts
               each kernel's executions (each kernel of the path once per
               replayed tick, no other one) and gives the device's busy
               time, and from the same trace the idle share of the
               profiled run (1 - the union of the device's operations over
               the trace's span; the profiler stretches the run, so an
               unprofiled replay's idle share is not measured). Then a
               fresh Simulator
               runs the per-tick `Simulator.tick` loop: 4 warm-up and 20
               timed ticks, each kernel of the path launched once a tick and
               no other, whose fired history must equal the graphs' over the
               same ticks, and a 10-tick per-phase profile (the graphs have
               no phase ranges). All timed runs run under CUDA sync-debug
               mode "error"; planes finite; fired rate within 0.5x-2x of
               out_rate. Peak GiB with and without graphs. fused_blocked's
               and eager's fired histories must equal the fused path's over
               the same ticks.
               Merged mode (merged=True, the worklist backend in mode
               "merged", 100 timed ticks) runs the same way twice: from the
               cold start (merged) and from a state whose rings each hold 8
               spike times before tick 0 (merged_warm: no bump applies, so
               every fire of a full ring takes the overflow flush). No
               hand-written kernel may launch on either (counters at capture
               and per tick, and the replay trace); the per-tick profile
               times the merged row phase, the WTA, the overflow flush and
               the patch; merged's fired history must equal the fused
               path's over the first 20 ticks. Fires and overflow flushes
               per timed tick are counted from the fired history (a fire
               on a column whose ring holds 8 times flushes and empties
               it, any other pushes), the count held against the rings
               read back after the timed runs.
  5b. checkpoints — the merged path's state (human_scale, 256 HCUs unless
               the disk holds less; warm rings, 20 ticks through the
               graphs) saved with `Simulator.save` into a temporary
               directory under build/ and loaded into a fresh CUDA
               Simulator: every leaf bit for bit, and one more tick fires
               the same and leaves the same state on both. Seconds and
               GB/s of the save, the load and `AsyncCheckpointer.save_async`
               (the snapshot to the host, then the background write, whose
               checkpoint loads bit for bit too). The committed legacy
               checkpoint (tests/fixtures/legacy_ckpt, the JAX package's
               (H, R, C) layout at t=10) restores into a CUDA Simulator and
               continues as an uninterrupted run. The directory is removed
               afterwards.
  6. flash   — the flash-attention kernels against their plain version on
               the card, on the model's layout: q (B, Sq, H, hd) and the KV
               cache (B, slots, Kv, hd) read in place. The qwen2-1.5b
               prefill (B 4, H 12, Kv 2, Sq 1024, 1152 slots, kv_len 1024,
               hd 128, causal) and one gemma2-9b layer (B 1, H 16, Kv 8,
               Sq = 4608 slots, hd 256, softcap 50, window 4096, scale
               1/16), each in bf16 (`flash_mma_kernel`, tensor cores) and
               float32 (`flash_fwd_kernel`, CUDA cores); then in bf16 the
               phase 10 prefills: zamba2-7b's shared block (H = Kv = 32,
               hd 112), qwen3-moe (H 64, Kv 4), llama-3.2-vision (H 32,
               Kv 8, hd 128), all B 4, Sq 1024, 1152 slots, and whisper's
               decoder (H = Kv = 20, hd 64, Sq 384, 512 slots): bf16 rtol
               8e-3 (one bf16 ulp), atol 1e-4; float32 rtol = atol = 2e-5;
               the wrapper's record of the kernel it took is checked. Each
               timed as in phase 3, and beside
               `torch.nn.functional.scaled_dot_product_attention` with
               enable_gqa=True on contiguous (B, H, Sq, hd) / (B, Kv,
               kv_len, hd) copies at every shape without softcap or window
               (the library yardstick; the port never calls it), and
               time_cuda's floor.
  6b. flash f32 — qwen2-1.5b at full width with compute_dtype="float32"
               and attn_impl="pallas_flash" (random weights from seed 0):
               one wave of 4 requests of 1024 tokens through
               `ServingEngine(4, 1152)`. The launch counters are set to 0
               just before: flash must launch 28 times, every time
               `flash_fwd_kernel`, and no BCPNN kernel. A warm prefill's
               logits are held against dense float32 attention on the same
               weights (max |diff| / max |dense| < 1e-3), and a profiled
               prefill must show 28 `flash_fwd_kernel` launches. Prints the
               wave's and a warm prefill's ms and the kernel's share of the
               profiled prefill's device time.
  7. lm      — the LM fixture (tests/fixtures/lm_serve_smoke.npz, qwen2-1.5b
               and gemma2-9b smoke configs at float32 compute) served on the
               card through the kernel: prefill logits within atol 2e-5 of
               the JAX package's, greedy tokens equal. Then qwen2-1.5b at
               full width (28 layers, d_model 1536, vocab 151936, 1.54 B
               float32 parameters from seed 0) with attn_impl="pallas_flash":
               `ServingEngine(batch_slots=4, max_len=1152)` serves 8 requests
               of 1024 random prompt tokens, 32 new tokens each, greedy (2
               waves). The launch counters are set to 0 just before the run;
               the flash kernel must launch exactly 28 x 2 times, every time
               `flash_mma_kernel`, and no BCPNN kernel at all; every token
               lies in the vocabulary. One more wave's prefill runs under
               CUDA sync-debug mode "error", and its logits are held against
               the same weights under attn_impl="dense": max |diff| / max
               |dense| < 0.03. Its profile must show 28 launches of
               `flash_mma_kernel` and none of `flash_fwd_kernel`. Prints ms
               per prefill wave, the flash kernel's share of a prefill's
               device time (torch.profiler), ms per decode step, tokens/s
               and peak GiB.
  7b. lm families — tests/fixtures/lm_families_smoke.npz (the smoke
               configs of qwen3-moe, llama4-maverick, zamba2, xlstm,
               llama-3.2-vision and whisper at float32 compute, written by
               tests/fixtures/capture_lm_families.py) on the card through
               the kernel, TF32 off: prefill logits within the CPU test's
               atol of the JAX package's (2e-5; zamba2 1e-4, xlstm 1e-3),
               8 greedy tokens of each of two 128-token prompts equal (the
               engine for the token-only families, `generate` with
               patch_embeds / frames for the others), and flash launched
               once per causal self-attention layer per prefill.
  8. recall  — resilience, the associative-memory protocol and recall
               serving (`repro_torch.runtime`, `repro_torch.experiments`,
               `repro_torch.launch.serve_bcpnn`):
               8a. tests/fixtures/assoc_serve_small.npz (the JAX package's,
                   tests/fixtures/capture_assoc.py) on the card through the
                   dense backend's kernels: `train_assoc` at
                   `assoc_params()` (3 patterns, 10 reps) gives its
                   attractor, `recall_accuracy` its (correct, total) plain,
                   after `sram_loss` and after `sram_loss` plus a plane
                   wipe, and the toy server (`test_scale(4, 48, 8)`, 3
                   lanes of 5 ticks) its sessions' fired trajectories,
                   statuses, ticks, winners and drops — all exactly.
               8b. `inject_retention_faults` at rate 1e-3 on a human-width
                   state of one HCU, all five planes, each mode: bit for
                   bit the same call on the CPU; the changed bits within 5
                   sigma of their binomial expectation; then 10 ticks on
                   the corrupted planes.
               8c. `ResilientRunner` on human_scale(256) (H cut only if the
                   disk under build/ holds less than four checkpoints),
                   phase 5's input, 256 ticks in 64-tick chunks,
                   save_every=1, crashes before chunks 1 and 3: the fired
                   history bit for bit an uninterrupted `Simulator.run`'s,
                   2 restarts, the graphs captured before the restores the
                   ones replayed after; each restore's seconds and the
                   health report. The checkpoints are removed afterwards.
               8d. `BCPNNRecallServer(slots=8, queue_capacity=32,
                   step_ticks=12)` at human width (256 HCUs, the serving
                   benchmark's dynamics, `cap_fire=256`) on a Simulator
                   trained by `train_assoc`: 48 sessions of budget 48, each
                   a 0.6 partial cue of a trained pattern, paced against
                   the queue. The fused row and column kernels launch once
                   a lane-tick at the first step's captures and nothing
                   else does; no step after the first captures; the first
                   two sessions to finish, re-run alone through
                   `Simulator.run(chunk=12)` from the template, equal
                   their lanes bit for bit (fired history and every leaf).
                   One more step, profiled, must leave every lane's tick
                   counter SERVE_STEP ticks past the template's on the
                   device, and each lane's graph must hold SERVE_STEP
                   kernel nodes of each fused kernel (driver API); the
                   trace's count of kernels is printed, not checked (it
                   can lose a record: tools/serve_profile_probe.py).
                   Prints qps, p50 / p95 service and sojourn ms, the
                   statuses, ms per step and per lane-tick, graph nodes a
                   step, peak GiB, the health verdict and drops, and the
                   served sessions' recall beside chance.
  9. sharded — the sharded runtime (`repro_torch.core.distributed`):
               9a. `Simulator.run_sharded` on a 1-rank NCCL group (this
                   process) at human_scale(256), fused, flat,
                   `lossless_route_config`: 100 ticks that capture one
                   100-tick graph with the exchange's all_to_all inside
                   (the fused kernels counted once a captured tick, no
                   other kernel), then 100 replayed ticks under sync-debug
                   "error", host clock ending in the fired rows' host read;
                   the fired history of the 200 ticks and every state leaf
                   bit for bit a local `Simulator.run` at cap_fire 256; a
                   device trace of 100 more replayed ticks (each fused
                   kernel once a tick, busy time, ops) and the exchange
                   alone.
               9b. the same at `default_route_config` (printing
                   drops_route), against the local run at the default
                   cap_fire.
               9c-9e on 4 gloo ranks spawned on the one card
               (`launch.ranks.spawn_ranks`, the only processes this script
               starts), tick by tick: 9c. run_sharded at 4 x 64 HCUs
               under `lossless_route_config`, 100 ticks: the gathered
               fired history bit for bit the local run's and each rank's
               slice of every state leaf bit for bit its state at tick 100
               (the parent's tensors, through CUDA IPC); µs/tick measures
               4 processes time-slicing one card, not scaling. 9d.
               head_sharded_dense / head_sharded_worklist across the 4
               ranks (the worklist one in the four fused / fused_cols
               combinations: kernels 1-5) under the fixtures' contract. 9e.
               `ElasticRunner` at test_scale(8, 64, 16) losing ranks 2-3
               before chunk 3: the survivors bit for bit the local run.
 10. families — the MoE, hybrid, SSM, VLM and audio families at full
               width (random weights from seed 0, float32 parameters, bf16
               compute, attn_impl="pallas_flash"), one model at a time,
               each freed before the next (FAMILY_RUNS): qwen3-moe-235b-a22b
               cut from 94 to 2 layers (one layer's experts are 9.7 GB),
               zamba2-7b, xlstm-125m (also a queue alternating 1024- and
               512-token prompts, which must be served in equal-length
               waves: order 0, 2, 4, 6, 1, 3, 5, 7) through
               `ServingEngine(4, max_len=1152)`, 8 requests of 1024 + 32
               greedy tokens; llama-3.2-vision-11b (patch_embeds (4, 1601,
               1280)) and whisper-large-v3 (frames (4, 1500, 1280), 384 +
               32 tokens, max_len 512) through `generate`. The launch
               counters are set to 0 before each run: flash must launch
               once per causal self-attention layer per prefill (2, 13, 0,
               32, 32), every time `flash_mma_kernel`, and no BCPNN kernel;
               every token in the vocabulary. Prints parameters and init
               s, prefill ms per wave and decode ms per step (host clock,
               synchronised at both ends), tokens/s, peak GiB (above what
               earlier phases still hold, and with it), qwen3-moe's
               drop_frac and lb_loss of its first `moe_ffn` call at the
               prefill shape, and one profiled prefill's device time by
               kernel with flash's share (its launches counted again).
 11. train   — LM training (`repro_torch.train`, `repro_torch.launch.train`),
               after printing the GiB that earlier phases leave allocated
               (at the start of phase 10 too):
               11a. tests/fixtures/train_smoke.npz (written by
                   tests/fixtures/capture_train.py) on the card at float32,
                   TF32 off: every LM id's smoke config, its first-step
                   gradients and 20 steps of AdamW(lr=1e-3, warmup 5) on
                   MarkovLM batches of 4 x 16, held to the bounds of
                   tests/test_torch_train.py.
               11b. qwen2-1.5b at full width (1.54 B float32 parameters,
                   bf16 compute, remat on, dense attention) through
                   `train(..., smoke=False)`: batch 8 x seq 1024,
                   MarkovLM seed 0, 30 steps of the launcher's AdamW
                   (warm-up 20) at lr 5e-4 (TRAIN_LR: its default 3e-3
                   diverges at this width). The launch counters are set to 0
                   just before: no kernel may launch (the flash kernel has
                   no backward). Every loss finite, the mean of the last 5
                   below that of the first 5. Prints ms a step (the median
                   of steps 3-29 but the profiled one, host clock to the
                   loss's host read), tokens/s, peak GiB, the losses and
                   grad norms, and step 10's device time by row (GEMMs,
                   casts, attention, cross entropy, the optimizer; from a
                   torch.profiler trace, by each kernel's launching op).
               11c. the same run stopped at step 20 (`AsyncCheckpointer`
                   at the end, in a temporary directory under build/,
                   removed afterwards) and resumed by a second `train`
                   call (`restore_latest`) to step 30: its losses within
                   rtol 1e-5, atol 1e-6 of 11b's, and how many are bit for
                   bit.
 12. mesh    — LM training through the mesh (`launch.train.train(mesh=
               ...)`, `launch.shardings`, DTensor parameters):
               12a. qwen2-1.5b at full width as in 11b, 5 steps, on a
                   1-rank NCCL group through `make_host_mesh()` (mesh (1,
                   1)): the launch counters set to 0 just before, no
                   kernel may launch; the losses bit for bit 11b's first 5.
                   Prints ms a step (the median of steps 1-4), tokens/s
                   and peak GiB beside 11b's: the difference is DTensor's
                   dispatch.
               12b. 2 gloo ranks spawned on the one card, qwen2-1.5b at
                   published widths and MESH_LAYERS = 4 of its 28 layers
                   (a cut for time: gloo stages every collective through
                   the host; 28 layers fit but take 230 s),
                   3 steps on mesh (1, 2) (tensor parallel) and on (2, 1)
                   with ZeRO moments, each held against the one-device
                   run of the same model in this process: losses within
                   rtol MESH_LOSS_RTOL and grad norms within
                   MESH_GNORM_RTOL at every step, no kernel launched.
                   Prints ms a step and peak GiB by rank.
 13. report  — one JSON line of the kernels (with each BCPNN kernel's
               launches on the phase 8 paths, counted at capture, and on
               the sharded paths of phase 9 under ``launches_by_path``;
               flash's launches are the LM serving runs' of phases 6b, 7
               and 10, by model under ``launches_by_path``, beside phase
               11b's and 12's training runs, which launch none, and its
               numbers at every phase 6 shape under ``by_shape``), then
               the last line {"ok": true, "device": {...}}.

It imports the port only (never JAX or the JAX package) and exits non-zero
without printing a result where no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
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
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
SECTOR = 32                   # bytes per DRAM/L2 sector
OPS_PER_CELL = 33             # float32 ops of cell_math, transcendentals as one
NOW = 100
N_TIMED = 20
TIMED_TICKS = 200         # timed ticks of the fused path
OTHER_TICKS = 100         # timed ticks of the fused_blocked, unfused and dense paths
EAGER_TICKS = 20
PROFILE_TICKS = 10
PER_TICK_WARM, PER_TICK_TICKS = 4, 20   # the per-tick driver beside the graphs
GRAPH_REPEATS = 2         # timed runs through the graphs, back to back
# float tolerances of the CPU contract (tests/test_torch_engine.py)
FIXTURE_TOL = {"hcus_wij": (4e-6, 4e-6), "hcus_h": (4e-6, 1e-4)}
FIXTURE_DEFAULT_TOL = (4e-6, 4e-7)
INT_LEAVES = ("hcus_tij", "hcus_ti", "delay_rows", "delay_count", "t",
              "drops_in", "drops_fire")
MERGED_MATCH_TICKS = 20   # merged's fired history against the fused path's
CKPT_TICKS = 20           # ticks of the merged state before the checkpoint


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ext_tensor(p, T, width=8, lam=4.0, seed=0):
    """Poisson external input (T, H, width) int32, as benchmarks/tick_loop.py
    stages it: `repro_torch.data.poisson_external_drive`'s ticks."""
    import torch
    from repro_torch.data import poisson_external_drive
    return torch.stack(list(poisson_external_drive(
        p, T, seed=seed, width=width, lam=lam, device="cpu"))).numpy()


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


def floor_ms(flush):
    """`time_cuda`'s floor: a kernel that returns at once
    (`torch.cuda._sleep(0)`), timed the same way, L2 flush included. A
    small kernel's distance from its bound is read against it."""
    import torch
    return time_cuda(lambda: torch.cuda._sleep(0), flush)


def row_inputs(p, gen, dev):
    """Row-phase operands at the main path's shapes: W = H*(active_queue+8)
    slot-ordered entries, ~14 unique rows per HCU (the delay-queue and
    external spikes a tick brings at lambda 4 and out_rate 0.1), the rest
    the H*R sentinel; zj / pj the (H, C) j-vectors."""
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
        zj=u(n, C) * 2, p_i=u(W) * 0.1 + 1e-4, pj=u(n, C) * 0.1 + 1e-4,
        zi_new=u(W) * 3, ei_new=u(W) * 0.5, pi_new=u(W) * 0.1 + 1e-4)


def col_inputs(p, gen, dev):
    """Column-phase operands at the main path's shapes: K = int(0.35 H)+1
    entries, out_rate * H of them fired (26 of 256) with unique HCUs, the
    last one at the last HCU's last column, the rest padding (h == H); pj
    the (H, C) j-vector P (the i-vectors are the planes')."""
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
    return dict(h_idx=h, j_idx=j,
                pj=torch.rand(n, C, generator=gen, device=dev) * 0.1 + 1e-4)


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


# the plane layouts of phase 3: name -> tile (None: flat). The worklist
# kernels are checked under each and timed under each; the (xr, 4) tile
# whose row and column kernels take the least time together is the one
# the fused_blocked path of phase 5 runs
LAYOUTS = (("flat", None), ("2x4", (2, 4)), ("4x4", (4, 4)), ("8x4", (8, 4)),
           ("16x4", (16, 4)), ("32x4", (32, 4)), ("7x5", (7, 5)))
TILE_CANDIDATES = ("2x4", "4x4", "8x4", "16x4", "32x4")
NAMES9 = ("zij", "eij", "pij", "wij", "tij", "zi", "ei", "pi", "ti")


def sector_bytes(p, tile, kind):
    """Bytes one access of a logical row / column of one plane moves in
    32-byte sectors under ``tile`` (None: flat, the tile (1, C)), by the
    layout's own line model."""
    from repro_torch.core import layout as L
    xr, xc = tile or (1, p.cols)
    rates = (0.5, 0.0) if kind == "row" else (0.0, 0.5)
    return L.cache_lines_touched_per_s(xr, xc, p.rows, p.cols, *rates,
                                       line_bytes=SECTOR) * SECTOR


def check_inplace(tag, kname, call, base, names, flush, time_plain):
    """A worklist kernel against its plain version on copies of the stored
    planes ``base`` (every stored cell compared, pad cells included), then
    timed. Returns (errors, ms, plain ms or None)."""
    import torch
    from repro_torch.kernels import bcpnn_update as BU
    kernel = getattr(BU, f"{kname}_kernel")
    plain = getattr(BU, f"{kname}_plain")
    ker = {f: base[f].clone() for f in names}
    out_k = call(kernel, ker)
    torch.cuda.synchronize()
    pla = {f: base[f].clone() for f in names}
    out_p = call(plain, pla)
    torch.cuda.synchronize()
    errs = {f: check_close(f"{tag} {f}", ker[f], pla[f],
                           atol=1e-5 if f == "wij" else 1e-6) for f in names}
    if out_k is not None:
        errs["wrow"] = check_close(f"{tag} wrow", out_k, out_p, atol=1e-5)
    del pla, out_p
    ms = time_cuda(lambda: call(kernel, ker), flush)
    plain_ms = time_cuda(lambda: call(plain, ker), flush) if time_plain else None
    del ker
    return errs, ms, plain_ms


def phase_kernels(p, dev):
    """Phase 3: each kernel against its plain version, then timed; the
    three worklist kernels under every layout of LAYOUTS. Returns (the
    report's entries, the tile phase 5's blocked path runs)."""
    import torch
    from repro_torch.core import hcu as H
    from repro_torch.core import layout as L
    k, ki, eps = H.coeffs_ij(p), H.coeffs_i(p), p.eps
    n, R, C = p.n_hcu, p.rows, p.cols
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    planes = random_planes(p, gen, dev)
    now = torch.tensor(NOW, dtype=torch.int32, device=dev)
    rin, cin = row_inputs(p, gen, dev), col_inputs(p, gen, dev)
    flush = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    names5 = NAMES9[:5]
    W, A = rin["rows"].shape[0], rin["rows"].shape[0] // n
    nv = int((rin["rows"] < n * R).sum())
    nf = int((cin["h_idx"] < n).sum())
    K = cin["h_idx"].shape[0]
    # the unfused worklist: the row phase's slot-ordered worklist and its
    # valid-first compaction, as `worklist.build_worklist` makes them
    valid = rin["rows"] < n * R
    order = torch.argsort((~valid).to(torch.int32), stable=True).to(torch.int32)
    nv_t = valid.sum().to(torch.int32).reshape(1)
    live_hcus = int((valid.reshape(n, A).any(dim=1)).sum())
    print(f"kernels: {nv} valid of {W} row slots ({live_hcus} HCUs), {nf} "
          f"fired of {K} column entries, R={R} C={C}, {n} HCUs; time_cuda's "
          f"floor (an empty kernel) {floor_ms(flush):.5f} ms")

    def row_call(lay):
        return lambda fn, pl: fn(
            *(pl[f] for f in NAMES9), rin["rows"], now, rin["counts"],
            rin["zj"], rin["p_i"], rin["pj"], rin["zi_new"], rin["ei_new"],
            rin["pi_new"], k, eps, layout=lay)

    def col_call(lay):
        return lambda fn, pl: fn(
            *(pl[f] for f in NAMES9), cin["pj"], cin["h_idx"], cin["j_idx"],
            now, k, ki, eps, n, R, layout=lay)

    def wl_call(lay):
        return lambda fn, pl: fn(
            *(pl[f] for f in names5), rin["rows"], order, nv_t, now,
            rin["counts"], rin["zj"], rin["p_i"], rin["pj"], k, eps,
            layout=lay)

    # bytes each kernel moves at these inputs, by the function (each plane
    # cell, vector and weight row once) and by the layout's 32-byte sectors
    # (`row` / `col`: one access of a logical row / column of one plane)
    def row_bytes(row):
        return (nv * (9 * row + C * 4 + 16) + (W - nv) * C * 4 + n * C * 8
                + W * 24)

    def col_bytes(col):
        return nf * (9 * col + R * 16 + 4) + K * 8

    # the unfused kernel: a live entry's planes and its slot's order, row,
    # count and p_i; the j-vectors of the HCUs with a live entry; nv, now
    def wl_bytes(row):
        return nv * (9 * row + 16) + live_hcus * C * 8 + 8

    specs = (("fused_row_update", row_call, NAMES9, row_bytes, "row",
              nv * C, "fused_row_update_kernel_call"),
             ("fused_col_update", col_call, NAMES9, col_bytes, "col",
              nf * R, "fused_col_update_kernel_call"),
             ("worklist_row_update", wl_call, names5, wl_bytes, "row",
              nv * C, "worklist_update_kernel_call"))
    per = {s[0]: {} for s in specs}
    plain = {}
    for lname, tile in LAYOUTS:
        lay = None if tile is None else L.BlockedLayout(R, C, *tile)
        base = {f: lay.store(planes[f]) if lay is not None and f in names5
                else planes[f] for f in NAMES9}
        for kname, call, names, nbytes, kind, cells, _ in specs:
            errs, ms, plain_ms = check_inplace(
                f"{kname} {lname}", kname, call(lay), base, names, flush,
                time_plain=tile is None)
            if plain_ms is not None:
                plain[kname] = plain_ms
            fn_b = nbytes(C * 4 if kind == "row" else R * 4)
            sec_b = nbytes(sector_bytes(p, tile, kind))
            per[kname][lname] = {
                "ms": ms, "max_abs_err": max(errs.values()),
                "function_bytes": fn_b,
                "function_bound_ms": fn_b / HBM_BYTES_PER_S * 1e3,
                "sector_bytes": sec_b,
                "sector_bound_ms": sec_b / HBM_BYTES_PER_S * 1e3}
            print(f"{kname} [{lname}]: {ms:.5f} ms, max abs error "
                  f"{max(errs.values())}, bound {fn_b} bytes "
                  f"({fn_b / HBM_BYTES_PER_S * 1e3:.5f} ms), sectors "
                  f"{sec_b} bytes ({sec_b / HBM_BYTES_PER_S * 1e3:.5f} ms)")
        del base
        torch.cuda.empty_cache()
    report = []
    for kname, _, _, nbytes, kind, cells, tpu_fn in specs:
        flat = per[kname]["flat"]
        e = entry(kname, {"all": max(v["max_abs_err"]
                                     for v in per[kname].values())},
                  flat["ms"], plain[kname], flat["function_bytes"],
                  cells * OPS_PER_CELL, tpu_fn)
        e["layouts"] = per[kname]
        report.append(e)
    sums = {t: per["fused_row_update"][t]["ms"] + per["fused_col_update"][t]["ms"]
            for t in TILE_CANDIDATES}
    best = min(sums, key=sums.get)
    print("row + column kernel ms by tile: " + json.dumps(sums)
          + f"; phase 5 runs {best}")
    del planes
    torch.cuda.empty_cache()

    # -- gathered row blocks (dense backend) ------------------------------
    rb = block_inputs((n, A, C), gen, dev)
    rb.update(counts=rin["counts"].reshape(n, A), p_i=rin["p_i"].reshape(n, A),
              zj=rin["zj"], pj=rin["pj"])
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
    cb = block_inputs((K, R), gen, dev)
    cb.update(zi_t=_rand(gen, dev, K, R) * 3,
              p_i=_rand(gen, dev, K, R) * 0.1 + 1e-4,
              pj_sc=_rand(gen, dev, K) * 0.1 + 1e-4)
    cb_call = lambda fn: fn(cb["zij"], cb["eij"], cb["pij"], cb["tij"], now,
                            cb["zi_t"], cb["p_i"], cb["pj_sc"], k, eps)
    # every entry is computed, padding included: reads z e p t zi_t p_i,
    # writes z e p w t per cell, and pj_sc per entry
    cb_bytes = K * R * 11 * 4 + K * 4 + 4
    report.append(check_block("col_update", cb_call, flush, cb_bytes,
                              K * R * OPS_PER_CELL, "col_update_kernel_call"))
    print(f"column blocks: {K} entries ({nf} fired) of {R} rows")
    return report, dict(LAYOUTS)[best]


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
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
}


def entry(name, errs, ms, plain_ms, nbytes, nops, tpu_fn,
          source="src/repro_torch/kernels/csrc/bcpnn_update.cu",
          ops_per_s=FP32_OPS_PER_S, library_ms=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[tpu_fn], "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# fixture -> the flags it was captured with (tests/fixtures/capture_head.py)
# and whether it ran the host-loop driver; the lazy ones also with the
# planes stored column-blocked (tiles (8, 4) and (7, 5), 64 x 16 HCUs)
FIXTURES = [("lazy_worklist", dict(worklist=True, fused=f, fused_cols=fc),
             False) for f in (True, False) for fc in (True, False)] + [
    ("lazy_dense", dict(worklist=False), False),
    ("eager", dict(eager=True), False),
    ("host_lazy", dict(worklist=False), True)]
FIXTURES += [(name, dict(kw, layout=tile), host)
             for tile in ((8, 4), (7, 5)) for name, kw, host in FIXTURES[:5]]
# merged mode: 4 HCUs of (24, 16) at out_rate 0.6 (MERGED_DIMS), every HCU
# in the fired batch
MERGED_DIMS = dict(n_hcu=4, rows=24, cols=16, fanout=4, active_queue=8,
                   max_delay=8, out_rate=0.6)
FIXTURES += [(name, dict(merged=True, worklist=wl, cap_fire=4, layout=tile),
              False) for tile in (None, (8, 4), (7, 5))
             for name, wl in (("merged_dense", False),
                              ("merged_worklist", True))]


# the chunk lengths phase 4 replays each fixture at through the graph
# driver: the default (one 40-tick graph) and 7, which leaves a remainder
# (graphs of 7 and 5 ticks)
FIXTURE_CHUNKS = (128, 7)


def fixture_gaps(tag, fired, got, d):
    """A run against a fixture's contract: the fired history and integer
    leaves exactly, float leaves to the CPU tests' tolerances. Returns the
    float gaps by leaf."""
    if not np.array_equal(fired, d["fired"]):
        fail(f"fixture {tag}: fired history differs")
    for k in INT_LEAVES + (("jring",) if "jring" in d else ()):
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
    return gaps


def phase_fixtures(dev):
    """Phase 4: the head fixtures through the kernels on the card. Each
    runs on the per-tick driver (`Simulator.tick`, or `run_host` where the
    fixture was captured with it), then on the CUDA-graph driver
    (`Simulator.run`) at each chunk of FIXTURE_CHUNKS: every run is held
    to the fixture's contract, and every graph run to the per-tick run's
    fired history and state bit for bit. Blocked runs are compared after
    unpacking (`convert.state_to_numpy`)."""
    import torch
    from repro_torch import convert
    from repro_torch.core import Simulator
    from repro_torch.core.layout import BlockedLayout
    from repro_torch.core.params import BCPNNParams, test_scale
    for name, kw, host in FIXTURES:
        p = (BCPNNParams(**MERGED_DIMS) if kw.get("merged")
             else test_scale(4, 64, 16))
        d = dict(np.load(ROOT / "tests" / "fixtures" / f"head_{name}.npz"))
        tile = kw.get("layout")
        kw = dict(kw, layout=tile and BlockedLayout(p.rows, p.cols, *tile))
        tag = (f"{name} {json.dumps(dict(kw, layout=tile))}"
               f"{' run_host' if host else ''}")
        sim = Simulator(p, key=0, device=dev, **kw)
        for k, v in convert.conn_to_numpy(sim.conn).items():
            if not np.array_equal(v, d[k]):
                fail(f"fixture {name}: {k} differs")
        ext = torch.from_numpy(d["ext"])
        if host:
            fired = sim.run_host(lambda t: ext[t - 1], ext.shape[0])
        else:
            fired = torch.stack([sim.tick(e) for e in ext.to(dev)])
        want = fired.cpu().numpy(), convert.state_to_numpy(sim.state,
                                                           sim.layout)
        gaps = fixture_gaps(f"{tag} per-tick", *want, d)
        graphs = []
        for chunk in FIXTURE_CHUNKS:
            sim = Simulator(p, key=0, device=dev, chunk=chunk, **kw)
            fired = sim.run(ext.to(dev)).cpu().numpy()
            got = convert.state_to_numpy(sim.state, sim.layout)
            fixture_gaps(f"{tag} graphs chunk {chunk}", fired, got, d)
            if not np.array_equal(fired, want[0]) or any(
                    not np.array_equal(got[k], want[1][k]) for k in got):
                fail(f"fixture {tag}: the graphs at chunk {chunk} differ "
                     f"from the per-tick driver")
            graphs.append(f"chunk {chunk}: graphs of "
                          f"{list(sim.graphs.captured)} ticks")
        torch.cuda.synchronize()
        print(f"fixture {tag} on the card: fired history exact "
              f"({int((want[0] >= 0).sum())} spikes), integer leaves exact, "
              f"largest float gap {max(gaps.values()):.3g} "
              f"({max(gaps, key=gaps.get)}); the graph driver bit for bit "
              f"the per-tick one ({'; '.join(graphs)})")


def reset_launches():
    """Every kernel's launch counter to 0 (and the flash wrapper's count by
    kernel)."""
    from repro_torch.kernels import bcpnn_update as BU
    from repro_torch.kernels import flash_attention as FA
    for counts in (BU.launches, FA.launches, FA.routes):
        for k in counts:
            counts[k] = 0


def read_launches():
    from repro_torch.kernels import bcpnn_update as BU
    from repro_torch.kernels import flash_attention as FA
    return {**BU.launches, **FA.launches}


# path -> (Simulator flags, timed ticks, the kernels it must launch once
# per tick; every other kernel must not launch). fused_blocked stores the
# planes in the (xr, 4) tile that phase 3 found fastest (`phase_paths`).
PATHS = {
    "fused": (dict(), TIMED_TICKS, ("fused_row_update", "fused_col_update")),
    "fused_blocked": (dict(layout=None), OTHER_TICKS,
                      ("fused_row_update", "fused_col_update")),
    "unfused": (dict(fused=False, fused_cols=False), OTHER_TICKS,
                ("worklist_row_update", "col_update")),
    "dense": (dict(worklist=False), OTHER_TICKS, ("row_update", "col_update")),
    "eager": (dict(eager=True), EAGER_TICKS, ()),
    "merged": (dict(merged=True), OTHER_TICKS, ()),
    "merged_warm": (dict(merged=True), OTHER_TICKS, ()),
}


def warm_rings(sim):
    """Fill every ring of a fresh merged Simulator with 8 spike times
    before tick 0 (-7 .. 0): no bump applies to any cell (each lies at or
    before every stamp), so the values equal the cold start's until a
    flush, and the first fire of each column finds its ring full."""
    import torch
    from repro_torch.core import merged as M
    ring = sim.state.jring
    ring.copy_(torch.arange(-M.RING_DEPTH + 1, 1, dtype=ring.dtype,
                            device=ring.device))


# path -> what is done to each of its Simulators before the first tick
PREPARE = {"merged_warm": warm_rings}


def ring_flushes(fired, held):
    """Replay a merged run's overflow rule on the host from its fired
    history (T, H): a fire on a column whose ring holds RING_DEPTH times
    flushes it (the ring empties, nothing is pushed), any other fire
    pushes one time. ``held`` (H, C): the times each ring holds at the
    start, updated in place. Returns the flushes of each tick (T,)."""
    from repro_torch.core import merged as M
    out = np.zeros(fired.shape[0], np.int64)
    for t, row in enumerate(fired):
        for h in np.nonzero(row >= 0)[0]:
            j = row[h]
            if held[h, j] == M.RING_DEPTH:
                held[h, j] = 0
                out[t] += 1
            else:
                held[h, j] += 1
    return out


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
        # min and max propagate NaN; no plane-sized temporary (isfinite of
        # a plane would hold its abs copy and three bool planes, 1.6 GiB)
        if not bool(torch.isfinite(torch.stack(torch.aminmax(
                getattr(st.hcus, f)))).all()):
            fail(f"{name} path: non-finite values in {f}")
    if int(st.t) != t_end:
        fail(f"{name} path: t = {int(st.t)}")
    if tuple(fired.shape) != (ticks, p.n_hcu):
        fail(f"{name} path: fired history of shape {tuple(fired.shape)}")
    rate = float((fired >= 0).float().mean())
    if not 0.5 * p.out_rate <= rate <= 2 * p.out_rate:
        fail(f"{name} path: fired rate {rate} per HCU per tick")
    return rate


class SMClocks:
    """The card's SM clock (MHz) sampled every 20 ms by `nvidia-smi -lms`
    in a child process for the length of a ``with`` block; ``median``
    and ``span`` (min, max) afterwards, None where no sample came."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        mhz = sorted(int(v) for v in out.split() if v.isdigit())
        self.median = statistics.median(mhz) if mhz else None
        self.span = (mhz[0], mhz[-1]) if mhz else None

    def __str__(self):
        return ("SM clock not sampled" if self.median is None else
                f"SM clock median {self.median} MHz ({self.span[0]}-"
                f"{self.span[1]})")


def check_counts(what, counts, want):
    """Each wrapper's launch count must equal ``want`` (kernel -> count;
    every other kernel 0)."""
    for k, c in counts.items():
        if c != want.get(k, 0):
            fail(f"{what}: {k} counted {c} launches, expected {want.get(k, 0)}")


def timed_ticks(name, driver, run, want):
    """``run()`` under sync-debug "error" with the launch counters from 0,
    then each wrapper's count must equal ``want`` (`check_counts`). Prints
    when the host returned from ``run()``, the device's span (CUDA events
    around it) and the SM clock. Returns (result, host seconds to the end
    of the device's work, device span in ms, counts)."""
    import torch
    reset_launches()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with SMClocks() as clocks:
        # any operation that waits for the device inside the ticks raises
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        a.record()
        out = run()
        b.record()
        enqueued = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span = a.elapsed_time(b)
    print(f"{name} path ({driver}): the host returned after {enqueued:.4f} s "
          f"of {wall:.4f} s; device span {span:.2f} ms; {clocks}")
    counts = read_launches()
    check_counts(f"{name} path ({driver})", counts, want)
    return out, wall, span, counts


def graph_nodes(graph):
    """The node count of a captured CUDA graph (the driver keeps each with
    keep_graph=True), by the driver API's `cuGraphGetNodes`."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if rc:
        fail(f"cuGraphGetNodes failed (CUresult {rc})")
    return count.value


def graph_kernels(graph):
    """The kernel nodes of a captured CUDA graph by function name, a
    Counter, read through the driver API (`cuGraphGetNodes`,
    `cuGraphNodeGetType`, `cuGraphKernelNodeGetParams_v2`, then
    `cuFuncGetName` or, for a node that holds a CUkernel,
    `cuKernelGetName`). What a replay runs is exactly these nodes."""
    import collections
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    P, u = ctypes.c_void_p, ctypes.c_uint

    class Params(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", P)] + [(f, u) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")]
            + [("params", P), ("extra", P), ("kern", P), ("ctx", P)])

    def call(fn, *args):
        rc = getattr(lib, fn)(*args)
        if rc:
            fail(f"{fn} failed (CUresult {rc})")

    g = P(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (P * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    out = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", P(node), ctypes.byref(kind))
        if kind.value != 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        prm = Params()
        call("cuGraphKernelNodeGetParams_v2", P(node), ctypes.byref(prm))
        name = ctypes.c_char_p()
        if prm.func:
            call("cuFuncGetName", ctypes.byref(name), P(prm.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), P(prm.kern))
        out[name.value.decode()] += 1
    return out


def run_path(name, p, ext, kw):
    """One human-width path, first through the CUDA-graph driver, then
    through the per-tick `Simulator.tick` loop on a fresh Simulator.

    Graphs: ``ticks`` warm-up ticks, one call per chunk, capture every
    chunk length the timed runs replay; the wrappers' launch counters,
    from 0, must show one launch of each kernel of the path per captured
    tick, and one more for the scratch tick before the backend's first
    capture (a capture records launches, a replay makes none on the
    host). Each capture's first call is timed and its graph's nodes
    counted. GRAPH_REPEATS timed runs of ``ticks`` ticks then replay only, under
    sync-debug "error", the counters from 0 and required to stay 0, each
    with its device span and SM clock; a device trace of one more run of
    ``ticks`` ticks counts each kernel's executions (once per replayed
    tick, `profile_replay`) and gives the busy time and the idle share.
    Per-tick: PER_TICK_WARM ticks, then PER_TICK_TICKS timed under
    sync-debug "error", each kernel launched once a tick, its fired
    history equal to the graphs' over the same ticks, then the per-phase
    profile (`profile_ticks`). Peak GiB of each driver from a fresh
    Simulator. A path of PREPARE has its hook applied to each new
    Simulator first. Returns (summary, the warm-up fired history, (the
    fired history of the warm-up and timed runs (numpy), for a merged
    path the rings' occupancy at the start and after the timed runs))."""
    import torch
    from repro_torch.core import Simulator, network
    _, ticks, expect = PATHS[name]
    prepare = PREPARE.get(name, lambda sim: None)
    P = PROFILE_TICKS
    assert ext.shape[0] >= (GRAPH_REPEATS + 2) * ticks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(p, key=0, **kw)              # the default device: CUDA
    prepare(sim)
    rings0 = None if sim.state.jring is None else occupancy(sim)
    torch.cuda.synchronize()
    print(f"{name} path: {type(sim.backend).__name__}{tuple(sim.backend)}, "
          f"init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    reset_launches()
    scratch = len(network.scratch_ticked)
    warm, first_s = [], {}
    for lo in range(0, ticks, sim.chunk):
        known = set(sim.graphs.captured)
        t0 = time.perf_counter()
        warm.append(sim.run(ext[lo:min(lo + sim.chunk, ticks)]))
        torch.cuda.synchronize()
        for L in set(sim.graphs.captured) - known:
            first_s[L] = time.perf_counter() - t0
    warm = torch.cat(warm)
    peak_warm = torch.cuda.max_memory_allocated() / 2**30
    at_capture = read_launches()
    # a backend's first capture in the process runs its scratch tick first
    scratch = len(network.scratch_ticked) - scratch
    check_counts(f"{name} path (graphs, warm-up)", at_capture,
                 {k: sum(first_s) + scratch for k in expect})
    nodes = {L: graph_nodes(g) for L, g in sim.graphs.captured.items()}
    print(f"{name} path: {ticks} warm-up ticks through the graphs, chunk "
          f"{sim.chunk}; launches counted at capture {json.dumps(at_capture)} "
          f"({sum(first_s)} captured ticks, {scratch} scratch tick)")
    us, spans, timed = [], [], []
    for rep in range(GRAPH_REPEATS):
        lo = (rep + 1) * ticks
        fired, wall, span, counts = timed_ticks(
            name, "graphs", lambda: sim.run(ext[lo:lo + ticks]), {})
        rate = check_state(name, sim, fired, p, ticks, lo + ticks)
        timed.append(fired.cpu())
        us.append(wall / ticks * 1e6)
        spans.append(span / ticks * 1e3)
        print(f"{name} path [graphs, run {rep + 1}]: {ticks} ticks in "
              f"{wall:.4f} s = {us[-1]:.1f} us/tick (device span "
              f"{spans[-1]:.1f} us/tick), fired rate {rate:.4f} per HCU per "
              f"tick, drops {sim.drops()}")
    lo += ticks
    rings = None if rings0 is None else (rings0, occupancy(sim))
    replay = profile_replay(name, sim, ext[lo:lo + ticks], expect, spans[-1])
    if set(sim.graphs.captured) != set(first_s):
        fail(f"{name} path: the timed ticks captured a graph")
    # the first call of a chunk length captures, instantiates and replays
    # it once (a backend's first capture in the process also runs the
    # scratch tick); less one replay at the timed rate is the capture's
    captures = [{"ticks": L, "first_call_s": s_, "nodes": nodes[L],
                 "capture_s": s_ - L * spans[-1] / 1e6}
                for L, s_ in first_s.items()]
    for c in captures:
        print(f"  graph of {c['ticks']} ticks: first call {c['first_call_s']:.3f} s "
              f"(capture, instantiation, one replay), less one replay at the "
              f"timed rate {c['capture_s']:.3f} s; {c['nodes']} nodes "
              f"({c['nodes'] / c['ticks']:.1f} a tick)")
    peak_graphs = torch.cuda.max_memory_allocated() / 2**30
    warm = warm.cpu()
    del sim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    sim = Simulator(p, key=0, **kw)
    prepare(sim)
    hist = [sim.tick(e) for e in ext[:PER_TICK_WARM]]
    lo, hi = PER_TICK_WARM, PER_TICK_WARM + PER_TICK_TICKS
    more, wall_t, _, counts_t = timed_ticks(
        name, "per-tick", lambda: [sim.tick(e) for e in ext[lo:hi]],
        {k: PER_TICK_TICKS for k in expect})
    m = min(hi, warm.shape[0])
    per_tick = torch.stack(hist + more)[:m].cpu()
    if not torch.equal(per_tick, warm[:m]):
        fail(f"{name} path: the per-tick driver's fired history differs from "
             f"the graphs' in {int((per_tick != warm[:m]).sum())} places")
    us_t = wall_t / PER_TICK_TICKS * 1e6
    peak_tick = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name} path [per-tick]: {PER_TICK_TICKS} ticks in {wall_t:.4f} s "
          f"= {us_t:.1f} us/tick; fired history equals the graphs' over "
          f"ticks 1-{m}; peak GiB allocated {peak_graphs:.3f} with graphs "
          f"({peak_warm:.3f} by the end of the warm-up), {peak_tick:.3f} "
          f"per-tick")
    prof = profile_ticks(name, sim, ext[hi:hi + P], expect)
    del sim
    torch.cuda.empty_cache()
    return {"us_per_tick_graphs": us, "device_span_us_per_tick": spans,
            "us_per_tick_per_tick": us_t, "captures": captures,
            "launches_at_capture": at_capture,
            "launches_per_tick_loop": counts_t, "replay": replay,
            "peak_gib_graphs": peak_graphs, "peak_gib_graphs_warm_up": peak_warm,
            "peak_gib_per_tick": peak_tick, "per_tick_profile": prof}, warm, \
        (torch.cat([warm] + timed).numpy(), rings)


def occupancy(sim):
    """Spike times each ring of a merged Simulator holds, (H, C), read
    back to the host."""
    from repro_torch.core import merged as M
    return (sim.state.jring != M.RING_EMPTY).sum(-1).cpu().numpy()


def phase_paths(report, tile):
    """Phase 5: every path at human width through the kernels (`run_path`);
    the fused_blocked path with the planes stored in ``tile``, its fired
    history held against the flat fused path's over the same ticks, the
    eager golden model's against the fused path's, and merged's over its
    first MERGED_MATCH_TICKS ticks; the merged paths' fires and overflow
    flushes per timed tick (`merged_flushes`)."""
    import torch
    from repro_torch.core.layout import BlockedLayout
    from repro_torch.core.params import human_scale
    p = human_scale(n_hcu=256)
    T = (GRAPH_REPEATS + 2) * TIMED_TICKS
    t0 = time.perf_counter()
    ext = torch.from_numpy(ext_tensor(p, T)).cuda()
    print(f"paths: human_scale(n_hcu=256) R={p.rows} C={p.cols} "
          f"fanout={p.fanout} A={p.active_queue}; fused_blocked tile {tile}; "
          f"{T} ticks of input staged in {time.perf_counter() - t0:.2f} s")
    flags = {name: kw for name, (kw, _, _) in PATHS.items()}
    flags["fused_blocked"] = dict(layout=BlockedLayout(p.rows, p.cols, *tile))
    runs = {name: run_path(name, p, ext, flags[name]) for name in PATHS}
    fused = runs["fused"][1]
    for name, n in (("fused_blocked", None), ("eager", None),
                    ("merged", MERGED_MATCH_TICKS)):
        b = runs[name][1][:n]
        if not torch.equal(b, fused[:b.shape[0]]):
            fail(f"{name} path: fired history differs from the fused "
                 f"path's in {int((b != fused[:b.shape[0]]).sum())} places")
        print(f"{name} path: fired history equals the fused path's over "
              f"{b.shape[0]} ticks ({int((b >= 0).sum())} spikes)")
    for name in ("merged", "merged_warm"):
        b = runs[name][1]
        print(f"{name} path against the fused path over {b.shape[0]} ticks: "
              f"fired history differs in {int((b != fused[:b.shape[0]]).sum())}"
              f" of {b.numel()} places (bit for bit required over the first "
              f"{MERGED_MATCH_TICKS} of merged)")
        merged_flushes(name, runs[name])
    for e in report:
        e["launches"] = runs[REPORT_PATH[e["name"]]][0]["replay"][
            "executions"][e["name"]]
    summary = {name: r[0] for name, r in runs.items()}
    print("paths summary:", json.dumps(summary))


def phase_checkpoints(dev):
    """Phase 5b: `Simulator.save` / `load` and `AsyncCheckpointer` on the
    merged path's full state, and the committed legacy checkpoint, on the
    card; every check bit for bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, latest_step
    from repro_torch.core import Simulator, rng
    from repro_torch.core.params import human_scale, test_scale
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    p = human_scale(n_hcu=256)
    per_hcu = p.rows * p.cols * 20 + p.rows * 16 + p.cols * 8 * 4 + 4096
    free = shutil.disk_usage(base).free
    n = min(p.n_hcu, int(0.8 * free // per_hcu))
    if n < 2:
        fail(f"checkpoints: {free} bytes free under {base}")
    cut = "" if n == p.n_hcu else f" (cut from {p.n_hcu}: {free} bytes free)"
    p = human_scale(n_hcu=n)
    ext = torch.from_numpy(ext_tensor(p, CKPT_TICKS + 1, seed=1)).cuda()
    sim = Simulator(p, key=0, merged=True)
    warm_rings(sim)
    sim.run(ext[:CKPT_TICKS])
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(sim.state))
    print(f"checkpoints: human_scale(n_hcu={n}){cut}, merged, warm rings, "
          f"{CKPT_TICKS} ticks through the graphs; state {nbytes / 1e9:.3f} "
          f"GB; {free / 1e9:.1f} GB free under {base}")
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix="ckpt_"))
    try:
        t0 = time.perf_counter()
        sim.save(str(tmp / "sync"))
        t_save = time.perf_counter() - t0
        back = Simulator(p, key=0, merged=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back.load(str(tmp / "sync"))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same_state("checkpoints: the loaded state", sim, back)
        if back.graphs.captured or any(t.device.type != back.device.type
                                       for t in leaves(back.state)):
            fail("checkpoints: load kept graphs or left the device")
        shutil.rmtree(tmp / "sync")
        f1, f2 = sim.tick(ext[CKPT_TICKS]), back.tick(ext[CKPT_TICKS])
        if not torch.equal(f1, f2):
            fail("checkpoints: the tick after the load fires otherwise")
        same_state("checkpoints: the state one tick after the load", sim, back)
        ck = AsyncCheckpointer(str(tmp / "async"))
        tree = sim.state._replace(base_key=rng.key_data(sim.state.base_key))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_async(int(sim.state.t), tree)
        t_snap = time.perf_counter() - t0
        ck.wait()
        t_write = time.perf_counter() - t0 - t_snap
        if latest_step(str(tmp / "async")) != int(sim.state.t):
            fail("checkpoints: the async save left no complete step")
        del back
        back = Simulator(p, key=0, merged=True).load(str(tmp / "async"))
        same_state("checkpoints: the async checkpoint", sim, back)
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gbs = lambda t: f"{t:.3f} s, {nbytes / t / 1e9:.2f} GB/s"
    print(f"checkpoints: save {gbs(t_save)}; load {gbs(t_load)}; save_async "
          f"snapshot {gbs(t_snap)}, background write {gbs(t_write)}; every "
          f"leaf bit for bit after the load and the async save, and the next "
          f"tick fires as the saved state's ({int((f1 >= 0).sum())} spikes)")
    del sim
    torch.cuda.empty_cache()

    q = test_scale(n_hcu=2, rows=32, cols=16)
    d = np.load(ROOT / "tests" / "fixtures" / "legacy_ckpt_ext.npz")
    ext = torch.from_numpy(d["ext"]).cuda()
    legacy = Simulator(q, key=0).load(str(ROOT / "tests" / "fixtures" /
                                          "legacy_ckpt"))
    if int(legacy.state.t) != 10 or any(t.device.type != legacy.device.type
                                        for t in leaves(legacy.state)):
        fail("checkpoints: the legacy checkpoint restored wrongly")
    fired = legacy.run(ext[10:]).cpu()
    ref = Simulator(q, key=0)
    want = ref.run(ext).cpu()
    if not (np.array_equal(want[:10].numpy(), d["fired_prefix"])
            and torch.equal(fired, want[10:])):
        fail("checkpoints: the legacy checkpoint continues otherwise")
    print(f"checkpoints: the legacy (H, R, C) checkpoint restored at t=10 "
          f"and continued {fired.shape[0]} ticks as the uninterrupted run "
          f"({int((fired >= 0).sum())} spikes)")


def leaves(tree):
    """The tensor leaves of a (nested) NamedTuple, in field order."""
    for v in tree:
        if isinstance(v, tuple):
            yield from leaves(v)
        elif v is not None:
            yield v


def same_state(what, a, b):
    """Every leaf of two Simulators' states bit for bit."""
    import torch
    for x, y in zip(leaves(a.state), leaves(b.state), strict=True):
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"{what} differs from the saved one")


def merged_flushes(name, run):
    """Fires and overflow flushes per timed tick of a merged path, from its
    fired history (`ring_flushes`); the rule's ring occupancy after the
    timed runs must equal the rings read back then. Adds them to the
    path's summary."""
    summary, _, (fired, (start, end)) = run
    occ = start.copy()
    per_tick = ring_flushes(fired, occ)
    if not np.array_equal(occ, end):
        fail(f"{name} path: the flush rule replayed from the fired history "
             f"leaves other ring occupancies than the rings hold")
    ticks = PATHS[name][1]
    timed = slice(ticks, fired.shape[0])
    fires = int((fired[timed] >= 0).sum())
    flushes = int(per_tick[timed].sum())
    n = fired.shape[0] - ticks
    summary.update(fires_per_tick=fires / n, flushes_per_tick=flushes / n,
                   flushes_warm_up=int(per_tick[:ticks].sum()))
    print(f"{name} path: {n} timed ticks, {fires / n:.2f} fires and "
          f"{flushes / n:.3f} overflow flushes per tick ({flushes} of "
          f"{fires} fires; {int(per_tick[:ticks].sum())} flushes in the "
          f"{ticks} warm-up ticks); host us/tick through the graphs "
          + ", ".join(f"{u:.1f}" for u in summary["us_per_tick_graphs"])
          + f", per-tick loop {summary['us_per_tick_per_tick']:.1f}")


def profile_replay(name, sim, ext, expect, unprofiled, run=None):
    """The graph driver (``run``, `sim.run` by default) over len(ext) more
    ticks (replays only, under sync-debug "error") in torch.profiler with
    device activity only. From
    that one trace: each hand-written kernel's executions, which must be
    one a tick for each kernel of ``expect`` and none for any other; the
    device's busy time (its operations' durations summed) and operations
    a tick; the span
    from the first operation's start to the last one's end; and the idle
    share, 1 - (the union of the operations' intervals) / span. The
    profiler stretches the run it records (its span is printed beside the
    ``unprofiled`` one, µs/tick by CUDA events), so this is the idle share
    of the profiled run; an unprofiled replay's is not measured. Returns a
    summary."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(ext)
    t0 = time.perf_counter()
    with SMClocks() as clocks, profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            (run or sim.run)(ext)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not evs:
        fail(f"{name} replay profile: no device activity in the trace")
    ran = {k: sum(tag in e[2] for e in evs) for k, tag in KERNEL_TAGS.items()}
    for k, c in ran.items():
        if c != (n if k in expect else 0):
            fail(f"{name} replay profile: {k}'s kernel ran {c} times in {n} "
                 f"replayed ticks, expected {n if k in expect else 0}")
    union, end = 0.0, evs[0][0]
    for s_, e_, _ in evs:
        union += max(0.0, e_ - max(s_, end))
        end = max(end, e_)
    span = max(e[1] for e in evs) - evs[0][0]
    by = collections.defaultdict(lambda: [0.0, 0])
    for s_, e_, nm in evs:
        by[nm][0] += e_ - s_
        by[nm][1] += 1
    busy = sum(v[0] for v in by.values()) / n
    ours = {k: sum(v[0] for nm, v in by.items() if tag in nm) / n
            for k, tag in KERNEL_TAGS.items() if k in expect}
    idle = 1 - union / span
    print(f"{name} replay profile over {n} ticks (replays only, device "
          f"activity only, {time.perf_counter() - t0:.1f} s with the trace): "
          f"kernels ran {json.dumps(ran)}; device busy {busy:.1f} us/tick in "
          f"{len(evs) / n:.1f} device ops/tick; span {span / n:.1f} us/tick "
          f"against {unprofiled:.1f} unprofiled; idle share of the profiled "
          f"run {idle:.4f} (of an unprofiled replay: not measured); {clocks}"
          + "".join(f"; {k} {v:.1f} us/tick" for k, v in ours.items()))
    for nm, (t, c) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  device {t / n:9.1f} us/tick {c / n:6.1f}/tick  {nm[:80]}")
    return {"executions": ran, "device_busy_us_per_tick": busy,
            "device_ops_per_tick": len(evs) / n,
            "profiled_span_us_per_tick": span / n,
            "unprofiled_span_us_per_tick": unprofiled,
            "idle_share_profiled_run": idle,
            "kernel_us_per_tick": ours}


# the phase functions of the tick, timed by name in the profile, and the
# hand-written kernels each launches: a kernel launched through ctypes has
# no torch operator above it, so the profiler does not count it inside the
# phase's range, and its time is added to the phase's by name
PHASES = (("repro_torch.core.engine", "worklist_lazy_rows",
           ("fused_row_update", "worklist_row_update")),
          ("repro_torch.core.hcu", "row_updates", ("row_update",)),
          ("repro_torch.core.engine", "_column_worklist", ("fused_col_update",)),
          ("repro_torch.core.engine", "column_updates_batched", ("col_update",)),
          ("repro_torch.core.reference", "eager_tick", ()),
          ("repro_torch.core.engine", "worklist_merged_rows", ()),
          ("repro_torch.core.hcu", "periodic_update", ()),
          ("repro_torch.core.merged", "overflow_flush", ()),
          ("repro_torch.core.worklist", "patch_cells", ()))


def profile_ticks(name, sim, ext, kernels):
    """Device time of a path by kernel and by tick phase over 10 more ticks
    of the per-tick driver (`Simulator.tick`: a graph replay runs no
    Python, so it has no phase ranges); torch.profiler, each phase
    function inside a `record_function` range of its name for the length
    of the profile. Returns a summary; prints "not measured" where the
    trace has no device time."""
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
            for e in ext:
                sim.tick(e)
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
    print(f"{name} profile over {n} ticks of the per-tick driver (the "
          f"graphs have no phase ranges): device busy {total / n:.1f} "
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


# flash attention: name -> (B, H, Kv, Sq, slots, hd, dtype, flash kwargs),
# q (B, Sq, H, hd) and a (B, slots, Kv, hd) KV cache; the first is the
# call qwen2-1.5b's prefill makes in phase 7
QWEN2 = (4, 12, 2, 1024, 1152, 128)
GEMMA2 = (1, 16, 8, 4608, 4608, 256)
QWEN2_KW = dict(scale=128 ** -0.5, causal=True, kv_len=1024)
GEMMA2_KW = dict(scale=1 / 16, causal=True, window=4096, softcap=50.0)


def prefill_kw(hd, kv_len):
    return dict(scale=hd ** -0.5, causal=True, kv_len=kv_len)


FLASH_SHAPES = {
    "qwen2-1.5b prefill bf16": (*QWEN2, "bfloat16", QWEN2_KW),
    "qwen2-1.5b prefill f32": (*QWEN2, "float32", QWEN2_KW),
    "gemma2-9b layer bf16": (*GEMMA2, "bfloat16", GEMMA2_KW),
    "gemma2-9b layer f32": (*GEMMA2, "float32", GEMMA2_KW),
    # the phase 10 prefills: zamba2's shared block (MHA, hd 112, run as
    # 128 with zero-filled dims), qwen3-moe (G 16), llama-3.2-vision's
    # self-attention (G 4), whisper's decoder self-attention (MHA, hd 64)
    "zamba2-7b shared block bf16": (4, 32, 32, 1024, 1152, 112, "bfloat16",
                                    prefill_kw(112, 1024)),
    "qwen3-moe prefill bf16": (4, 64, 4, 1024, 1152, 128, "bfloat16",
                               prefill_kw(128, 1024)),
    "llama-3.2-vision prefill bf16": (4, 32, 8, 1024, 1152, 128, "bfloat16",
                                      prefill_kw(128, 1024)),
    "whisper decoder prefill bf16": (4, 20, 20, 384, 512, 64, "bfloat16",
                                     prefill_kw(64, 384)),
}
# (rtol, atol) of the kernel against its plain version: both compute in
# float32, so bf16 outputs differ by at most one rounding (one ulp, < 2^-7
# relative), float32 outputs by summation order
FLASH_TOL = {"bfloat16": (8e-3, 1e-4), "float32": (2e-5, 2e-5)}
# the kernel each dtype takes at these head dims (128, 256)
FLASH_ROUTE = {"bfloat16": "mma", "float32": "simt"}


def valid_pairs(Sq, Skv, causal=True, window=None, kv_len=None, **_):
    """(query, key) pairs the mask lets through, per head."""
    kv_len = Skv if kv_len is None else kv_len
    q = np.arange(Sq)
    lo = np.maximum(0, q - window + 1) if window is not None else 0
    hi = np.minimum(kv_len, q + 1) if causal else np.full(Sq, kv_len)
    return int(np.maximum(0, hi - lo).sum())


def sdpa_ms(q, k, v, kw, flush):
    """The library yardstick: SDPA with GQA on (B, H, Sq, hd) q and (B, Kv,
    kv_len, hd) k / v, contiguous copies made before the timing."""
    import torch.nn.functional as F
    L = kw["kv_len"]
    q4 = q.transpose(1, 2).contiguous()
    k4, v4 = (t[:, :L].transpose(1, 2).contiguous() for t in (k, v))
    return time_cuda(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=kw["scale"], enable_gqa=True),
        flush)


def phase_flash(dev):
    """Phase 6: the flash kernels against their plain version, then timed,
    at every shape of FLASH_SHAPES. Returns the report entry of the qwen2
    bf16 call (phase 7's main path), with every shape's numbers under
    ``by_shape``."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    flush = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    print(f"flash: time_cuda's floor (an empty kernel) {floor_ms(flush):.5f} ms")
    report = None
    for name, (B, H, Kv, Sq, Skv, hd, dtype, kw) in FLASH_SHAPES.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        dt = getattr(torch, dtype)
        q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, Skv, Kv, hd, generator=gen, device=dev).to(dt)
                for _ in range(2))
        routes = dict(FA.routes)
        got = FA.flash_attention_kernel(q, k, v, **kw)
        torch.cuda.synchronize()
        kind = FLASH_ROUTE[dtype]
        if FA.routes != {r: n + (r == kind) for r, n in routes.items()}:
            fail(f"flash {name}: took {FA.routes} (before {routes}), "
                 f"expected {kind}")
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        rtol, atol = FLASH_TOL[dtype]
        err = check_close(f"flash {name}", got.float(), want.float(),
                          rtol=rtol, atol=atol)
        del got, want
        ms = time_cuda(lambda: FA.flash_attention_kernel(q, k, v, **kw), flush)
        plain_ms = time_cuda(lambda: FA.flash_attention_plain(q, k, v, **kw),
                             flush)
        # SDPA has no softcap and no window
        lib_ms = (sdpa_ms(q, k, v, kw, flush)
                  if "softcap" not in kw and "window" not in kw else None)
        # q and o once; k and v once per kv head, only up to kv_len: later
        # cache slots are masked out and never read
        kv_rows = min(kw.get("kv_len", Skv), Skv)
        nbytes = 2 * B * hd * (Sq * H + kv_rows * Kv) * q.element_size()
        nops = 4 * hd * B * H * valid_pairs(Sq, Skv, **kw)
        ops_per_s = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
        e = entry("flash_attention", {"out": err}, ms, plain_ms, nbytes, nops,
                  "flash_attention",
                  source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  ops_per_s=ops_per_s, library_ms=lib_ms)
        print(f"flash {name} ({kind} kernel): max abs error {err:.3g} (rtol "
              f"{rtol}, atol {atol}), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa (gqa) "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"{nbytes} bytes, {nops} flop, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})")
        report = report or dict(e, by_shape={})
        report["by_shape"][name] = {k: e[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        del q, k, v
    torch.cuda.empty_cache()
    return report


LM_FIXTURE_ARCHS = ("qwen2-1.5b", "gemma2-9b")
LM_FIXTURE_ATOL = 2e-5       # float32 logits, |logits| < 0.6
LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_MAX_LEN = 4, 8, 1024, 32, 1152
LM_PROFILE_STEPS = 4


def phase_lm_fixture(dev):
    """Phase 7, first part: the LM fixture served on the card through the
    kernel."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Request, ServingEngine
    d = dict(np.load(ROOT / "tests" / "fixtures" / "lm_serve_smoke.npz"))
    prompts = d["prompts"]
    for arch in LM_FIXTURE_ARCHS:
        pre = f"{arch}/param"
        flat = {k[len(pre):]: (d[k].astype(np.uint32) << 16).view(np.float32)
                for k in d if k.startswith(pre)}
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32",
                                  attn_impl="pallas_flash")
        model = convert.lm_model_from_numpy(flat, cfg, dev)
        reset_launches()
        with torch.no_grad():
            logits, _ = model.prefill(
                {"tokens": torch.from_numpy(prompts).long().to(dev)},
                model.init_cache(len(prompts), 256))
        gap = float(np.abs(logits.cpu().numpy() - d[f"{arch}/logits"]).max())
        if not gap <= LM_FIXTURE_ATOL:
            fail(f"LM fixture {arch}: prefill logits gap {gap}")
        eng = ServingEngine(model, len(prompts), 256)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, 8))
        toks = np.array([r.out for r in sorted(eng.run(), key=lambda r: r.rid)])
        if not np.array_equal(toks, d[f"{arch}/tokens"]):
            fail(f"LM fixture {arch}: greedy tokens differ from the JAX "
                 f"package's: {toks.tolist()}")
        n = read_launches()["flash_attention"]
        if n != 2 * cfg.n_layers:
            fail(f"LM fixture {arch}: flash launched {n} times, expected "
                 f"{2 * cfg.n_layers}")
        print(f"LM fixture {arch} on the card: prefill logits within {gap:.3g} "
              f"of the JAX package's, {toks.size} greedy tokens equal, "
              f"{n} flash launches")


def timed(fn, bucket):
    """fn, with the host time of each call (from a synchronised start to a
    synchronised end) appended to bucket."""
    import torch

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        bucket.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def device_rows(prof):
    """(kernel name, device ms) of a profile, and their sum."""
    from torch.autograd import DeviceType
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
    rows = [(e.key, dev_t(e) / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_t(e) > 0]
    return rows, sum(t for _, t in rows)


def print_rows(rows, per=1):
    for key, t in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  device {t / per:9.3f} ms  {key[:80]}")


def phase_lm(dev, smi):
    """Phase 7, second part: qwen2-1.5b at full width served through the
    flash kernel. Returns the flash kernel's launch count in the run."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import Request, ServingEngine
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), attn_impl="pallas_flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0)                  # the default device: CUDA
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.parameters())
    print(f"lm: {cfg.arch_id} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (kv {cfg.n_kv}), head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab}: {n_params} parameters ({cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}), init {time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(model, LM_SLOTS, LM_MAX_LEN)
    pre_ms, dec_ms = [], []
    eng.prefill = timed(eng.prefill, pre_ms)
    eng.decode = timed(eng.decode, dec_ms)
    gen = np.random.default_rng(0)
    prompts = [gen.integers(0, cfg.vocab, LM_PROMPT) for _ in range(LM_REQUESTS)]
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, LM_NEW))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    counts = read_launches()
    waves = -(-LM_REQUESTS // LM_SLOTS)
    for k, c in counts.items():
        want = cfg.n_layers * waves if k == "flash_attention" else 0
        if c != want:
            fail(f"lm: {k} launched {c} times, expected {want}")
    if FA.routes != {"mma": cfg.n_layers * waves, "simt": 0}:
        fail(f"lm: flash launches by kernel {FA.routes}, expected every "
             f"one flash_mma_kernel")
    toks = [t for r in done for t in r.out]
    if len(done) != LM_REQUESTS or len(toks) != LM_REQUESTS * LM_NEW:
        fail(f"lm: {len(done)} requests, {len(toks)} tokens served")
    if not all(0 <= t < cfg.vocab for t in toks):
        fail("lm: a token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ntok = len(toks)
    print(f"lm serve [{smi}]: {LM_REQUESTS} requests x {LM_PROMPT} prompt + "
          f"{LM_NEW} new tokens in {waves} waves of {LM_SLOTS}: {wall:.3f} s, "
          f"{ntok / wall:.1f} tokens/s; prefill ms per wave "
          f"{', '.join(f'{t:.2f}' for t in pre_ms)}; decode ms per step median "
          f"{statistics.median(dec_ms):.3f} (min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f}, {len(dec_ms)} steps); peak "
          f"{peak:.2f} GiB allocated; launches {json.dumps(counts)}")

    # one more wave's prefill: no host synchronisation inside, flash
    # against dense on the same weights, the kernel's share of device time
    batch, pad = eng.wave_inputs([Request(0, p, 1) for p in prompts[:LM_SLOTS]])
    torch.cuda.synchronize()
    with torch.no_grad():
        caches = model.init_cache(LM_SLOTS, LM_MAX_LEN)
        torch.cuda.set_sync_debug_mode("error")
        logits, _ = model.prefill(batch, caches, pad)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dense = Model(dataclasses.replace(cfg, attn_impl="dense"),
                      device="meta")
        dense.load_state_dict(model.state_dict(), assign=True)
        want, _ = dense.prefill(batch, dense.init_cache(LM_SLOTS, LM_MAX_LEN))
        rel = float((logits.float() - want.float()).abs().max()
                    / want.float().abs().max())
        del dense, want
        if not rel < 0.03:
            fail(f"lm: flash vs dense prefill logits rel err {rel}")
        if not bool(torch.isfinite(logits.float()).all()):
            fail("lm: non-finite prefill logits")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            caches = model.init_cache(LM_SLOTS, LM_MAX_LEN)
            logits, caches = model.prefill(batch, caches, pad)
            torch.cuda.synchronize()
        rows, total = device_rows(prof)
        if not total:
            fail("lm: no CUDA activity in the prefill's profile")
        n_mma, n_simt = (sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA
                             and name in e.key)
                         for name in ("flash_mma_kernel", "flash_fwd_kernel"))
        if (n_mma, n_simt) != (cfg.n_layers, 0):
            fail(f"lm: the prefill's profile shows {n_mma} flash_mma_kernel "
                 f"and {n_simt} flash_fwd_kernel launches, expected "
                 f"{cfg.n_layers} and 0")
        flash = sum(t for k, t in rows if "flash_mma_kernel" in k)
        print(f"lm prefill wave [{smi}]: sync-debug 'error' passed; flash vs "
              f"dense logits rel err {rel:.3g} (< 0.03); {n_mma} "
              f"flash_mma_kernel launches in the profile; flash kernel "
              f"{flash:.3f} ms of {total:.3f} ms device time "
              f"({flash / total:.1%})")
        print_rows(rows)
        # decode steps on that prefill's caches: host and device time
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(LM_PROFILE_STEPS):
                logits, caches = model.decode_step(tok, LM_PROMPT + i, caches,
                                                   pad)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
        rows, total = device_rows(prof)
        ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        print(f"lm decode [{smi}]: {LM_PROFILE_STEPS} profiled steps, "
              f"{host:.3f} ms per step on the host clock (profiled), device "
              f"busy {total / LM_PROFILE_STEPS:.3f} ms per step in "
              f"{ops / LM_PROFILE_STEPS:.0f} device ops per step")
        print_rows(rows, LM_PROFILE_STEPS)
    del model, eng, caches, logits
    torch.cuda.empty_cache()
    return counts["flash_attention"]


# phase 6b: flash_fwd_kernel against dense attention on the same float32
# model, relative to the largest |logit|: both compute in float32 and
# differ by summation order alone (phase 7's bf16 bound is 0.03)
F32_DENSE_REL = 1e-3


def phase_flash_f32(dev, smi):
    """Phase 6b: one prefill wave of qwen2-1.5b at full width with float32
    compute, through `flash_fwd_kernel`. Returns its flash launches."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import Request, ServingEngine
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              attn_impl="pallas_flash",
                              compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, seed=0)                  # the default device: CUDA
    eng = ServingEngine(model, LM_SLOTS, LM_MAX_LEN)
    pre_ms = []
    eng.prefill = timed(eng.prefill, pre_ms)
    gen = np.random.default_rng(0)
    prompts = [gen.integers(0, cfg.vocab, LM_PROMPT) for _ in range(LM_SLOTS)]
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, 1))
    reset_launches()
    done = eng.run()
    counts, routes = read_launches(), dict(FA.routes)
    want = {k: cfg.n_layers * (k == "flash_attention") for k in counts}
    if counts != want or routes != {"mma": 0, "simt": cfg.n_layers}:
        fail(f"6b: launches {json.dumps(counts)}, by kernel {routes}; "
             f"expected {cfg.n_layers} of flash_fwd_kernel and nothing else")
    toks = [t for r in done for t in r.out]
    if len(toks) != LM_SLOTS or not all(0 <= t < cfg.vocab for t in toks):
        fail(f"6b: tokens {toks}")
    batch, pad = eng.wave_inputs([Request(0, p, 1) for p in prompts])
    with torch.no_grad():
        warm = timed(model.prefill, pre_ms)
        logits, _ = warm(batch, model.init_cache(LM_SLOTS, LM_MAX_LEN), pad)
        dense = Model(dataclasses.replace(cfg, attn_impl="dense"),
                      device="meta")
        dense.load_state_dict(model.state_dict(), assign=True)
        ref, _ = dense.prefill(batch, dense.init_cache(LM_SLOTS, LM_MAX_LEN))
        rel = float((logits - ref).abs().max() / ref.abs().max())
        del dense, ref
        if not (rel < F32_DENSE_REL and bool(torch.isfinite(logits).all())):
            fail(f"6b: flash vs dense float32 prefill logits rel err {rel}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(batch, model.init_cache(LM_SLOTS, LM_MAX_LEN), pad)
            torch.cuda.synchronize()
    rows, total = device_rows(prof)
    n_fwd = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "flash_fwd_kernel" in e.key)
    if n_fwd != cfg.n_layers:
        fail(f"6b: the profile shows {n_fwd} flash_fwd_kernel launches")
    flash = sum(t for k, t in rows if "flash_fwd_kernel" in k)
    print(f"6b [{smi}]: {cfg.arch_id} at full width, float32 compute: one "
          f"wave of {LM_SLOTS} x {LM_PROMPT} tokens through ServingEngine("
          f"{LM_SLOTS}, {LM_MAX_LEN}): flash launches by kernel "
          f"{json.dumps(routes)}; prefill ms {pre_ms[0]:.2f} (the wave, "
          f"first), {pre_ms[1]:.2f} (warm); flash vs dense float32 logits "
          f"rel err {rel:.3g} (< {F32_DENSE_REL}); profiled prefill: "
          f"{n_fwd} flash_fwd_kernel launches, {flash:.3f} ms of "
          f"{total:.3f} ms device time ({flash / total:.1%}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print_rows(rows)
    del model, eng, logits
    torch.cuda.empty_cache()
    return counts["flash_attention"]


FAMILY_FIXTURE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                        "zamba2-7b", "xlstm-125m", "llama-3.2-vision-11b",
                        "whisper-large-v3")
# float32 prefill logits against the JAX package's, as on the CPU
# (tests/test_torch_serve.py: FAMILY_FIXTURE_ATOL)
FAMILY_FIXTURE_ATOL = {"zamba2-7b": 1e-4, "xlstm-125m": 1e-3}
FAMILY_FIXTURE_DEFAULT_ATOL = 2e-5
# the kinds whose causal self-attention prefill takes the flash kernel
FLASH_KINDS = ("attn", "attn_local", "attn_moe", "shared_attn", "dec_cross")


def flash_per_prefill(cfg):
    from repro_torch.models.transformer import layer_kinds
    return sum(k in FLASH_KINDS for k in layer_kinds(cfg))


def memory_batch(tokens, extra, dev):
    """{"tokens", and "patch_embeds" / "frames" where the family has one}."""
    import torch
    batch = {"tokens": torch.as_tensor(tokens).long().to(dev)}
    batch.update({k: torch.as_tensor(v).to(dev) for k, v in extra.items()})
    return batch


def phase_lm_families_fixture(dev):
    """Phase 7b: tests/fixtures/lm_families_smoke.npz (the six MoE, SSM /
    hybrid, VLM and audio smoke configs, float32 compute, flash on) served
    on the card through the kernel: prefill logits within the CPU test's
    atol of the JAX package's, greedy tokens equal (the engine for the
    token-only families, `generate` with the memory for the others), and
    the flash kernel launched once per causal self-attention layer per
    prefill."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Request, ServingEngine
    from repro_torch.train.serve_step import generate
    d = dict(np.load(ROOT / "tests" / "fixtures" / "lm_families_smoke.npz"))
    prompts = d["prompts"]
    for arch in FAMILY_FIXTURE_ARCHS:
        pre = f"{arch}/param"
        flat = {k[len(pre):]: (d[k].astype(np.uint32) << 16).view(np.float32)
                for k in d if k.startswith(pre)}
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32",
                                  attn_impl="pallas_flash")
        model = convert.lm_model_from_numpy(flat, cfg, dev)
        extra = {k: d[f"{arch}/{k}"] for k in ("patch_embeds", "frames")
                 if f"{arch}/{k}" in d}
        batch = memory_batch(prompts, extra, dev)
        reset_launches()
        with torch.no_grad():
            logits, _ = model.prefill(batch, model.init_cache(len(prompts), 256))
        gap = float(np.abs(logits.float().cpu().numpy()
                           - d[f"{arch}/logits"]).max())
        atol = FAMILY_FIXTURE_ATOL.get(arch, FAMILY_FIXTURE_DEFAULT_ATOL)
        if not gap <= atol:
            fail(f"LM families fixture {arch}: prefill logits gap {gap} "
                 f"> {atol}")
        if extra:
            toks = generate(model, batch, 8, 256).cpu().numpy()
        else:
            eng = ServingEngine(model, len(prompts), 256)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid, p, 8))
            toks = np.array([r.out for r in
                             sorted(eng.run(), key=lambda r: r.rid)])
        if not np.array_equal(toks, d[f"{arch}/tokens"]):
            fail(f"LM families fixture {arch}: greedy tokens differ from "
                 f"the JAX package's: {toks.tolist()}")
        n = read_launches()["flash_attention"]
        want = 2 * flash_per_prefill(cfg)
        if n != want:
            fail(f"LM families fixture {arch}: flash launched {n} times, "
                 f"expected {want}")
        print(f"LM families fixture {arch} on the card: prefill logits "
              f"within {gap:.3g} (atol {atol}) of the JAX package's, "
              f"{toks.size} greedy tokens equal, {n} flash launches")
        del model


# phase 10: arch -> (entry point, requests, prompt tokens, new tokens,
# max_len, layers kept (None: all), flash launches a prefill); random
# weights from seed 0, float32 parameters, bf16 compute, pallas_flash
FAMILY_RUNS = {
    "qwen3-moe-235b-a22b": ("engine", 8, 1024, 32, 1152, 2, 2),
    "zamba2-7b": ("engine", 8, 1024, 32, 1152, None, 13),
    "xlstm-125m": ("engine", 8, 1024, 32, 1152, None, 0),
    "llama-3.2-vision-11b": ("generate", 4, 1024, 32, 1152, None, 32),
    "whisper-large-v3": ("generate", 4, 384, 32, 512, None, 32),
}
FAMILY_SLOTS = 4
# xlstm's second queue: prompts alternating 1024 and 512 tokens, grouped
# into equal-length waves
XLSTM_ALTERNATING = (1024, 512)


def run_engine(model, cfg, prompts, new, max_len, pre_ms, dec_ms):
    """Serve ``prompts`` through ServingEngine(FAMILY_SLOTS, max_len);
    returns (completed requests in completion order, wall s)."""
    from repro_torch.launch.serve import Request, ServingEngine
    eng = ServingEngine(model, FAMILY_SLOTS, max_len)
    eng.prefill = timed(eng.prefill, pre_ms)
    eng.decode = timed(eng.decode, dec_ms)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, new))
    t0 = time.perf_counter()
    done = eng.run()
    return done, time.perf_counter() - t0


def moe_aux_of_first_call(model, batch, caches):
    """drop_frac and lb_loss of the first `moe_ffn` call of a prefill."""
    import torch
    from repro_torch.models import moe as moe_mod
    orig, seen = moe_mod.moe_ffn, []

    def first(params, x, cfg):
        out, aux = orig(params, x, cfg)
        seen.append((tuple(x.shape), float(aux["drop_frac"]),
                     float(aux["lb_loss"]), moe_mod.capacity(cfg, x.shape[0]
                                                             * x.shape[1])))
        return out, aux
    moe_mod.moe_ffn = first
    try:
        with torch.no_grad():
            model.prefill(batch, caches)
    finally:
        moe_mod.moe_ffn = orig
    return seen[0]


def phase_family(arch, dev, smi):
    """One phase 10 model: build it at full width, serve its traffic, check
    the flash launches and the outputs, profile one prefill. Returns the
    flash launches of the run."""
    import dataclasses
    import gc
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.transformer import Model
    from repro_torch.train.serve_step import generate
    how, n_req, plen, new, max_len, layers, per_prefill = FAMILY_RUNS[arch]
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas_flash")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if flash_per_prefill(cfg) != per_prefill:
        fail(f"{arch}: {flash_per_prefill(cfg)} flash layers, the table "
             f"says {per_prefill}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30   # by earlier phases
    t0 = time.perf_counter()
    model = Model(cfg, seed=0)                  # the default device: CUDA
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.parameters())
    print(f"{arch}: {cfg.n_layers} layers{'' if layers is None else ' (cut)'}"
          f", d_model {cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv}), "
          f"head_dim {cfg.head_dim}, vocab {cfg.vocab}: {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB float32), init {init_s:.2f} s")
    gen = np.random.default_rng(0)
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(0)
    pre_ms, dec_ms = [], []
    reset_launches()
    if how == "engine":
        prompts = [gen.integers(0, cfg.vocab, plen) for _ in range(n_req)]
        done, wall = run_engine(model, cfg, prompts, new, max_len, pre_ms,
                                dec_ms)
        outs = [r.out for r in done]
        waves = -(-n_req // FAMILY_SLOTS)
        batch = {"tokens": torch.as_tensor(np.stack(prompts[:FAMILY_SLOTS]))
                 .long().to(dev)}
    else:
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        n_mem = cfg.n_patches if cfg.family == "vlm" else cfg.n_enc_frames
        mem = torch.randn(n_req, n_mem, cfg.vision_dim, generator=tgen,
                          device=dev)
        toks = gen.integers(0, cfg.vocab, (n_req, plen))
        batch = memory_batch(toks, {key: mem}, dev)
        model.prefill = timed(model.prefill, pre_ms)
        model.decode_step = timed(model.decode_step, dec_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, batch, new, max_len)
        wall = time.perf_counter() - t0
        del model.prefill, model.decode_step
        outs = out.cpu().tolist()
        waves = 1
    counts = read_launches()
    want = per_prefill * waves
    for k, c in counts.items():
        if c != (want if k == "flash_attention" else 0):
            fail(f"{arch}: {k} launched {c} times, expected "
                 f"{want if k == 'flash_attention' else 0}")
    if FA.routes != {"mma": want, "simt": 0}:
        fail(f"{arch}: flash launches by kernel {FA.routes}, expected every "
             f"one flash_mma_kernel")
    toks = [t for o in outs for t in o]
    if len(outs) != n_req or len(toks) != n_req * new:
        fail(f"{arch}: {len(outs)} requests, {len(toks)} tokens served")
    if not all(0 <= t < cfg.vocab for t in toks):
        fail(f"{arch}: a token outside the vocabulary")
    extra = ""
    if arch == "xlstm-125m":
        # one queue alternating 1024- and 512-token prompts: equal-length
        # waves, FIFO within each length
        alt = [gen.integers(0, cfg.vocab, XLSTM_ALTERNATING[i % 2])
               for i in range(n_req)]
        alt_pre, alt_dec = [], []
        done, alt_wall = run_engine(model, cfg, alt, new, max_len, alt_pre,
                                    alt_dec)
        order = [r.rid for r in done]
        want_order = list(range(0, n_req, 2)) + list(range(1, n_req, 2))
        if order != want_order:
            fail(f"{arch}: alternating queue served in order {order}, "
                 f"expected {want_order}")
        extra = (f"; alternating 1024 / 512 queue: order {order}, "
                 f"{alt_wall:.3f} s, prefill ms per wave "
                 f"{', '.join(f'{t:.2f}' for t in alt_pre)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ntok = len(toks)
    print(f"{arch} [{smi}]: {how}, {n_req} requests x {plen} prompt + {new} "
          f"new tokens, {waves} wave(s) of {min(n_req, FAMILY_SLOTS)}: "
          f"{wall:.3f} s, {ntok / wall:.1f} tokens/s; prefill ms per wave "
          f"{', '.join(f'{t:.2f}' for t in pre_ms)}; decode ms per step "
          f"median {statistics.median(dec_ms):.3f} (min {min(dec_ms):.3f}, "
          f"max {max(dec_ms):.3f}, {len(dec_ms)} steps); peak "
          f"{peak - held:.2f} GiB allocated by the model's run ({peak:.2f} "
          f"with the {held:.2f} GiB held before it); flash launches "
          f"{counts['flash_attention']} "
          f"({per_prefill} a prefill){extra}")
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        if cfg.n_experts:
            shape, drop, lb, cap = moe_aux_of_first_call(
                model, batch, model.init_cache(B, max_len))
            print(f"{arch} moe_ffn at the prefill shape {shape}: drop_frac "
                  f"{drop:.6f}, lb_loss {lb:.6f} (cap {cap} a expert)")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            logits, _ = model.prefill(batch, model.init_cache(B, max_len))
            torch.cuda.synchronize()
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{arch}: non-finite prefill logits")
    rows, total = device_rows(prof)
    if not total:
        fail(f"{arch}: no CUDA activity in the prefill's profile")
    n_mma, n_simt = (sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and name in e.key)
                     for name in ("flash_mma_kernel", "flash_fwd_kernel"))
    if (n_mma, n_simt) != (per_prefill, 0):
        fail(f"{arch}: the prefill's profile shows {n_mma} flash_mma_kernel "
             f"and {n_simt} flash_fwd_kernel launches, expected "
             f"{per_prefill} and 0")
    flash = sum(t for k, t in rows if "flash_mma_kernel" in k)
    print(f"{arch} prefill profile [{smi}]: device {total:.3f} ms, flash "
          f"kernel {flash:.3f} ms ({flash / total:.1%}), {n_mma} "
          f"flash_mma_kernel launches")
    print_rows(rows)
    del model, logits, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def phase_families(dev, smi):
    """Phase 10: the five FAMILY_RUNS models at full width, one at a time.
    Returns the flash launches of each model's run."""
    t0 = time.perf_counter()
    launches = {}
    for arch in FAMILY_RUNS:
        launches[arch] = phase_family(arch, dev, smi)
    print(f"families: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 8: resilience, the associative-memory protocol and recall serving
# ---------------------------------------------------------------------------

ASSOC_REPS = 10               # train_assoc's presentations of each pattern
RETENTION_HCUS = 1            # human-width HCUs of phase 8b (CPU-checked)
RETENTION_RATE = 1e-3
RETENTION_TICKS = 10
RESILIENT_TICKS = 256         # phase 8c: 4 chunks of 64 ticks
RESILIENT_CHUNK = 64
RESILIENT_CRASHES = (1, 3)    # chunks with a crash before their first try
SERVE_SLOTS, SERVE_QUEUE, SERVE_STEP = 8, 32, 12
SERVE_SESSIONS, SERVE_BUDGET, SERVE_CUE = 48, 48, 0.6
SERVE_CHECKED = 2             # served sessions re-run solo, every leaf
BCPNN_KERNELS = ("fused_row_update", "fused_col_update",
                 "worklist_row_update", "row_update", "col_update")


def wipe_planes(state, p):
    """Every ij plane back to its init values (the fixture's plane wipe)."""
    import torch
    h = state.hcus
    return state._replace(hcus=h._replace(
        zij=torch.zeros_like(h.zij), eij=torch.zeros_like(h.eij),
        pij=torch.full_like(h.pij, p.p_init * p.p_init),
        wij=torch.zeros_like(h.wij), tij=torch.zeros_like(h.tij)))


def bcpnn_counts():
    counts = read_launches()
    return {k: counts[k] for k in BCPNN_KERNELS}


def phase_assoc_fixture():
    """Phase 8a: tests/fixtures/assoc_serve_small.npz on the card through
    the dense backend's kernels: the attractor of `train_assoc` at
    `assoc_params()`, `recall_accuracy` plain, after `sram_loss` and after
    `sram_loss` plus a plane wipe, and the toy server's sessions, each
    exactly the JAX package's. Returns the launch counters of the run
    (counted at capture)."""
    import torch
    from repro_torch.core import Simulator, network as N
    from repro_torch.core.params import test_scale
    from repro_torch.experiments import (assoc_params, recall_accuracy,
                                         sram_loss, train_assoc)
    from repro_torch.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest
    d = dict(np.load(ROOT / "tests" / "fixtures" / "assoc_serve_small.npz"))
    t0 = time.perf_counter()
    reset_launches()
    p = assoc_params()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu)
    attractor = train_assoc(sim, d["patterns"], reps=ASSOC_REPS)
    if not np.array_equal(attractor, d["attractor"]):
        fail(f"assoc fixture: attractor {attractor.tolist()} against the JAX "
             f"package's {d['attractor'].tolist()}")
    trained = N.tree_map(torch.clone, sim.state)
    recall = [recall_accuracy(sim, trained, d["patterns"], attractor,
                              rng=np.random.default_rng(0), corrupt=c)
              for c in (None, lambda s: sram_loss(s, p),
                        lambda s: wipe_planes(sram_loss(s, p), p))]
    if not np.array_equal(np.array(recall), d["recall"]):
        fail(f"assoc fixture: recall {recall} against the JAX package's "
             f"{d['recall'].tolist()}")
    q = test_scale(n_hcu=4, rows=48, cols=8)
    srv_sim = Simulator(q, key=0, cap_fire=q.n_hcu)
    srv_sim.run(d["warm"])
    srv = BCPNNRecallServer(srv_sim, slots=3, queue_capacity=8, step_ticks=5)
    done = srv.run([RecallRequest(i, d["cue_rows"][i], d["cue_mask"][i],
                                  budget_ticks=15)
                    for i in range(d["cue_rows"].shape[0])])
    got = {"srv_rid": [r.rid for r in done],
           "srv_status": [int(r.status == "done") for r in done],
           "srv_ticks": [r.ticks for r in done],
           "srv_drops": [[r.drops[k] for k in ("in", "fire", "route")]
                         for r in done],
           "srv_winners": np.stack([r.winners for r in done]).tolist(),
           "srv_fired": np.concatenate([r.fired for r in done]).tolist()}
    for k, v in got.items():
        if v != d[k].tolist():
            fail(f"assoc fixture: the toy server's {k} differs from the JAX "
                 f"package's")
    if srv.captures != srv.slots or \
            [c["step"] for c in srv.capture_steps] != [0]:
        fail(f"assoc fixture: the toy server captured {srv.captures} graphs "
             f"at steps {[c['step'] for c in srv.capture_steps]}")
    counts = bcpnn_counts()
    if not counts["row_update"] or not counts["col_update"] or \
            any(counts[k] for k in BCPNN_KERNELS[:3]):
        fail(f"assoc fixture: launches {counts}, expected the dense "
             f"backend's row_update and col_update only")
    print(f"assoc fixture: attractor {attractor.tolist()[0]}... and recall "
          f"{recall} (plain, sram_loss, sram_loss + wipe) equal the JAX "
          f"package's; the toy server's {len(done)} sessions "
          f"({sum(r.status == 'done' for r in done)} converged, "
          f"{int(d['srv_fired'].shape[0])} lane-ticks) equal it; launches at "
          f"capture {json.dumps(counts)}; {time.perf_counter() - t0:.1f} s")
    return counts


def popcount(x):
    """Set bits of an int32 tensor, summed (as int64)."""
    import torch
    v = x.to(torch.int64) & 0xFFFFFFFF
    return int(sum(((v >> b) & 1).sum() for b in range(32)))


def phase_retention():
    """Phase 8b: `inject_retention_faults` on a human-width state of
    RETENTION_HCUS HCUs (after 10 ticks), all five planes, each mode, at
    RETENTION_RATE, held bit for bit against the CPU: the CPU's call in
    mode "flip" gives its draw (one key hits the same bits in every mode,
    so each mode's planes are the draw applied to the old ones by an
    integer operation; one CPU call instead of three, since a draw of 32
    threefry words a cell takes seconds a plane on the host), and each
    mode's planes on the card must equal that draw applied to the CPU's
    planes. The changed bits lie within 5 sigma of their binomial
    expectation (rate x bits for "flip", rate x the set bits for "clear",
    rate x the clear bits for "set"). Then RETENTION_TICKS ticks on the
    corrupted planes."""
    import torch
    from repro_torch.core import Simulator, network as N, rng
    from repro_torch.core.params import human_scale
    from repro_torch.runtime import inject_retention_faults
    from repro_torch.runtime.resilience import IJ_PLANES
    t0 = time.perf_counter()
    p = human_scale(n_hcu=RETENTION_HCUS)
    ext = torch.from_numpy(ext_tensor(p, 2 * RETENTION_TICKS, seed=2)).cuda()
    sim = Simulator(p, key=0)
    sim.run(ext[:RETENTION_TICKS])
    st = N.tree_map(torch.clone, sim.state)
    host = N.tree_map(lambda a: a.cpu(), st)
    bits = lambda t: t.view(torch.int32)
    t1 = time.perf_counter()
    cpu = inject_retention_faults(host, rng.PRNGKey(7), RETENTION_RATE,
                                  mode="flip")
    t_cpu = time.perf_counter() - t1
    draw = {f: bits(getattr(cpu.hcus, f)) ^ bits(getattr(host.hcus, f))
            for f in IJ_PLANES}
    out = []
    for mode in ("flip", "clear", "set"):
        t1 = time.perf_counter()
        got = inject_retention_faults(st, rng.PRNGKey(7, "cuda"),
                                      RETENTION_RATE, mode=mode)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        changed = exposed = 0
        for f in IJ_PLANES:
            a, o = bits(getattr(got.hcus, f)), bits(getattr(st.hcus, f))
            h, d = bits(getattr(host.hcus, f)), draw[f]
            want = {"flip": h ^ d, "clear": h & ~d, "set": h | d}[mode]
            if not torch.equal(a.cpu(), want):
                fail(f"retention: {mode} {f} differs from the CPU's")
            changed += popcount(a ^ o)
            ones = popcount(o)
            exposed += {"flip": 32 * o.numel(), "clear": ones,
                        "set": 32 * o.numel() - ones}[mode]
        mean = RETENTION_RATE * exposed
        sigma = (mean * (1 - RETENTION_RATE)) ** 0.5
        if abs(changed - mean) > 5 * sigma:
            fail(f"retention: {mode} changed {changed} bits, expected "
                 f"{mean:.0f} +- {5 * sigma:.0f}")
        out.append(f"{mode} {changed} bits changed (expected {mean:.0f}, "
                   f"sigma {sigma:.1f}; {t_card:.3f} s on the card)")
        del got
    N.copy_into(sim.state, inject_retention_faults(st, rng.PRNGKey(7, "cuda"),
                                                   RETENTION_RATE))
    fired = sim.run(ext[RETENTION_TICKS:])
    if tuple(fired.shape) != (RETENTION_TICKS, p.n_hcu) or \
            int(sim.state.t) != 2 * RETENTION_TICKS:
        fail("retention: the ticks after the faults went wrong")
    print(f"retention: human_scale(n_hcu={RETENTION_HCUS}), rate "
          f"{RETENTION_RATE}, all five planes, every mode bit for bit the "
          f"CPU's draw ({t_cpu:.1f} s on the CPU): " + "; ".join(out)
          + f"; then {RETENTION_TICKS} ticks on the corrupted planes "
          f"({int((fired >= 0).sum())} spikes); "
          f"{time.perf_counter() - t0:.1f} s")
    del sim, st, host, cpu, draw
    torch.cuda.empty_cache()


def phase_resilient():
    """Phase 8c: `ResilientRunner` on human_scale(256) (H cut only if the
    disk under build/ holds less than keep_last checkpoints), phase 5's
    Poisson input, RESILIENT_TICKS ticks in RESILIENT_CHUNK-tick chunks,
    save_every=1, crashes before chunks RESILIENT_CRASHES on their first
    try: the fired history equals an uninterrupted `Simulator.run` bit for
    bit, 2 restarts, and the graphs captured before the restores are the
    ones replayed after them. Returns the launch counters of the runner's
    run (counted at capture)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import Simulator
    from repro_torch.core.params import human_scale
    from repro_torch.runtime import ResilientRunner
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    p = human_scale(n_hcu=256)
    per_hcu = p.rows * p.cols * 20 + p.rows * 16 + p.cols * 16 + 4096
    free = shutil.disk_usage(base).free
    n = min(p.n_hcu, int(0.8 * free // (4 * per_hcu)))
    if n < 2:
        fail(f"resilient: {free} bytes free under {base}")
    cut = "" if n == p.n_hcu else f" (cut from {p.n_hcu}: {free} bytes free)"
    p = human_scale(n_hcu=n)
    ext = torch.from_numpy(ext_tensor(p, RESILIENT_TICKS)).cuda()
    t0 = time.perf_counter()
    ref = Simulator(p, key=0)
    want = ref.run(ext).cpu().numpy()
    del ref
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    sim = Simulator(p, key=0)
    seen, pending = [], set(RESILIENT_CRASHES)

    def injector(chunk):
        seen.append((chunk, dict(sim.graphs.captured)))
        if chunk in pending:
            pending.discard(chunk)
            return True
        return False

    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix="resilient_"))
    try:
        reset_launches()
        runner = ResilientRunner(sim, str(tmp), chunk_ticks=RESILIENT_CHUNK,
                                 save_every=1, fail_injector=injector)
        t0 = time.perf_counter()
        fired, health = runner.run(ext)
        wall = time.perf_counter() - t0
        counts = bcpnn_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if runner.restarts != len(RESILIENT_CRASHES) or pending:
        fail(f"resilient: {runner.restarts} restarts")
    if not np.array_equal(fired, want):
        fail(f"resilient: the fired history differs from the uninterrupted "
             f"run's in {int((fired != want).sum())} places")
    final = sim.graphs.captured
    before = {L: g for _, c in seen for L, g in c.items()}
    if any(final.get(L) is not g for L, g in before.items()) or \
            set(final) != {RESILIENT_CHUNK}:
        fail(f"resilient: the restores changed the graphs ({len(before)} "
             f"before, {len(final)} after)")
    if counts["fused_row_update"] != counts["fused_col_update"] or \
            not counts["fused_row_update"] or \
            any(counts[k] for k in BCPNN_KERNELS[2:]):
        fail(f"resilient: launches {counts}")
    rec = ", ".join(f"t={r['restored_tick']} in {r['recovery_s']:.3f} s"
                    for r in runner.recoveries)
    print(f"resilient: human_scale(n_hcu={n}){cut}, {RESILIENT_TICKS} ticks "
          f"in chunks of {RESILIENT_CHUNK}, save_every=1, crashes before "
          f"chunks {RESILIENT_CRASHES}: fired history bit for bit the "
          f"uninterrupted run's ({int((want >= 0).sum())} spikes; that run "
          f"{t_ref:.2f} s), {runner.restarts} restarts, restored {rec}; run "
          f"{wall:.2f} s; graphs captured: {len(before)} before the restores "
          f"({sorted(before)} ticks), the same {len(final)} after; launches "
          f"at capture {json.dumps(counts)}")
    print("resilient health:", json.dumps(health))
    del sim, runner
    torch.cuda.empty_cache()
    return counts


def serve_params():
    """The serving benchmark's dynamics (benchmarks/serve_bcpnn.py) on the
    paper's per-HCU dimensioning, at phase 5's 256 HCUs."""
    import dataclasses
    from repro_torch.core.params import human_scale
    return dataclasses.replace(human_scale(n_hcu=256), mean_delay=1.5,
                               out_rate=1.0, wta_temp=0.25, tau_p=400.0)


def phase_serve():
    """Phase 8d: `BCPNNRecallServer` at human width through the fused
    worklist kernels (see the module docstring). Returns the launch
    counters of the server's run (counted at capture)."""
    import torch
    from repro_torch.core import Simulator, network as N
    from repro_torch.experiments import train_assoc
    from repro_torch.launch.serve_bcpnn import BCPNNRecallServer, RecallRequest
    p = serve_params()
    gib = lambda b: b / 2**30
    per_state = 5 * p.n_hcu * p.rows * p.cols * 4 + 4 * p.n_hcu * p.rows * 4
    print(f"serve: sizing before the run: the Simulator's state, the template "
          f"and {SERVE_SLOTS} lanes hold {SERVE_SLOTS + 2} x "
          f"{per_state / 1e9:.2f} GB = {(SERVE_SLOTS + 2) * per_state / 1e9:.1f}"
          f" GB of planes and i-vectors; {SERVE_CHECKED} lane snapshots "
          f"{SERVE_CHECKED * per_state / 1e9:.1f} GB more")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(p, key=0, cap_fire=p.n_hcu)
    patterns = np.random.default_rng(3).integers(0, p.rows, (3, p.n_hcu))
    attractor = train_assoc(sim, patterns, reps=ASSOC_REPS)
    torch.cuda.synchronize()
    print(f"serve: train_assoc on {type(sim.backend).__name__}"
          f"{tuple(sim.backend)}, 3 patterns x {ASSOC_REPS} reps "
          f"({(ASSOC_REPS * (3 * 6 + 2))} ticks) in "
          f"{time.perf_counter() - t0:.2f} s; attractor HCUs with a winner "
          f"{int((attractor >= 0).sum())} of {attractor.size}")
    srv = BCPNNRecallServer(sim, slots=SERVE_SLOTS,
                            queue_capacity=SERVE_QUEUE, step_ticks=SERVE_STEP)
    rng = np.random.default_rng(1)
    pending = [RecallRequest(rid, patterns[rid % 3], rng.random(p.n_hcu)
                             < SERVE_CUE, budget_ticks=SERVE_BUDGET)
               for rid in range(SERVE_SESSIONS)]
    pattern_of = {r.rid: r.rid % 3 for r in pending}
    snaps, counts_first = {}, None
    scratch = len(N.scratch_ticked)
    reset_launches()
    t0 = time.perf_counter()
    step_s = []
    while pending or srv.busy:
        while pending and srv.queue.free > 0:
            srv.submit(pending.pop(0))
        t1 = time.perf_counter()
        done_now = srv.step()          # ends in the step's host read
        step_s.append(time.perf_counter() - t1)
        if counts_first is None:
            counts_first = bcpnn_counts()
        for req in done_now:
            if len(snaps) < SERVE_CHECKED:
                snaps[req.rid] = N.tree_map(
                    torch.clone, N.take_session(srv.stacked, req.lane))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    scratch = len(N.scratch_ticked) - scratch
    lane_ticks = SERVE_SLOTS * SERVE_STEP
    if counts_first != {**{k: 0 for k in BCPNN_KERNELS},
                        "fused_row_update": lane_ticks + scratch,
                        "fused_col_update": lane_ticks + scratch}:
        fail(f"serve: launches at the first step {counts_first}, expected "
             f"{lane_ticks} (one a lane-tick) of the fused kernels only")
    counts = bcpnn_counts()
    if counts != counts_first or srv.captures != SERVE_SLOTS or \
            [c["step"] for c in srv.capture_steps] != [0]:
        fail(f"serve: captures after the first step ({srv.captures} graphs, "
             f"steps {[c['step'] for c in srv.capture_steps]}, launches "
             f"{counts})")
    nodes = sum(graph_nodes(g) for lane in srv.graphs or ()
                for g in lane.captured.values())
    s = srv.stats()
    done = srv.completed
    if len(done) != SERVE_SESSIONS or s["queue"]["rejected"]:
        fail(f"serve: {len(done)} sessions completed, "
             f"{s['queue']['rejected']} rejected")
    correct = total = 0
    for r in done:
        a = attractor[pattern_of[r.rid]]
        probe = ~np.asarray(r.cue_mask) & (r.winners >= 0) & (a >= 0)
        correct += int((r.winners[probe] == a[probe]).sum())
        total += int(probe.sum())
    # the first step captures the lanes' graphs; the others replay them
    first_s = step_s[0]
    step_ms = statistics.mean(step_s[1:]) * 1e3
    report = {
        "sessions": len(done), "qps": len(done) / wall, "wall_s": wall,
        "done": s["done"], "expired": s["expired"], "steps": s["steps"],
        "p50_service_ms": s["p50_service_ms"],
        "p95_service_ms": s["p95_service_ms"],
        "p50_sojourn_ms": s["p50_sojourn_ms"],
        "p95_sojourn_ms": s["p95_sojourn_ms"],
        "ms_per_step": step_ms, "ms_per_lane_tick": step_ms / lane_ticks,
        "ms_per_step_range": [min(step_s[1:]) * 1e3, max(step_s[1:]) * 1e3],
        "first_step_s": first_s, "captures": srv.captures,
        "graph_nodes_per_step": nodes, "peak_gib": gib(peak),
        "health": s["health"]["status"], "drops": s["health"]["drops"],
        "recall": [correct, total], "chance": 1 / p.cols}
    print(f"serve: {len(done)} sessions of budget {SERVE_BUDGET} through "
          f"{SERVE_SLOTS} lanes x {SERVE_STEP} ticks in {wall:.2f} s = "
          f"{report['qps']:.2f} qps; {s['done']} converged, {s['expired']} "
          f"expired, {s['steps']} steps; service p50 "
          f"{s['p50_service_ms']:.1f} / p95 {s['p95_service_ms']:.1f} ms, "
          f"sojourn p50 {s['p50_sojourn_ms']:.1f} / p95 "
          f"{s['p95_sojourn_ms']:.1f} ms (the first wave's include the "
          f"captures); {step_ms:.1f} ms per engine step after the first "
          f"({min(step_s[1:]) * 1e3:.1f}-{max(step_s[1:]) * 1e3:.1f}; the "
          f"first, with the captures, {first_s:.2f} s), "
          f"{step_ms / lane_ticks:.3f} ms per lane-tick; {srv.captures} "
          f"graphs of {SERVE_STEP} ticks, {nodes} nodes a step "
          f"({nodes / lane_ticks:.1f} a lane-tick), none captured after the "
          f"first step; peak {gib(peak):.2f} GiB allocated (with "
          f"{len(snaps)} lane snapshots); health {s['health']['status']}, "
          f"drops {json.dumps(s['health']['drops'])}; recall of the served "
          f"sessions {correct}/{total} = {correct / max(total, 1):.3f} "
          f"(chance {1 / p.cols:.3f}); launches at the first step "
          f"{json.dumps(counts_first)}")
    report["profile"] = profile_serve_step(srv, patterns, p)
    template = srv.template
    checked = {r.rid: r for r in done if r.rid in snaps}
    del srv
    torch.cuda.empty_cache()
    for rid, req in checked.items():
        solo = Simulator(p, key=0, cap_fire=p.n_hcu)
        N.copy_into(solo.state, template)
        frame = np.full((p.n_hcu, 4), p.rows, np.int32)
        mask = np.asarray(req.cue_mask, bool)
        frame[mask, 0] = np.asarray(req.cue_rows, np.int32)[mask]
        ext = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frame, (req.ticks,) + frame.shape))).cuda()
        f = solo.run(ext, chunk=SERVE_STEP).cpu().numpy()
        if not np.array_equal(f, req.fired):
            fail(f"serve: session {rid}'s fired history differs from its "
                 f"solo run in {int((f != req.fired).sum())} places")
        for a, b in zip(leaves(solo.state), leaves(snaps[rid]), strict=True):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"serve: session {rid}'s lane differs from its solo run")
        print(f"serve: session {rid} ({req.status}, {req.ticks} ticks, "
              f"{int((f >= 0).sum())} spikes) equals its solo "
              f"Simulator.run(chunk={SERVE_STEP}) from the template bit for "
              f"bit, fired history and every leaf")
        del solo
    del sim, template, snaps
    torch.cuda.empty_cache()
    print("serve summary:", json.dumps(report))
    return counts


def profile_serve_step(srv, patterns, p):
    """One more engine step of SERVE_SLOTS fresh sessions (after the
    measured run), replays only, in torch.profiler with device activity
    only: the device's busy time and operations a lane-tick, the span and
    idle share of the profiled step, and the kernels that take the most
    time (the profiler stretches the step it records).

    What the step ran is checked on the program, not on the trace: every
    lane's tick counter on the device advanced SERVE_STEP ticks from the
    template's, and each lane's graph holds SERVE_STEP kernel nodes of
    each fused kernel and none of another BCPNN kernel (a replay runs
    every node). The trace's own count is printed beside: it lost a
    kernel record in 2 of 30 profiled steps whose lanes were all right
    (tools/serve_profile_probe.py)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve_bcpnn import RecallRequest
    rng = np.random.default_rng(2)
    for i in range(SERVE_SLOTS):
        srv.submit(RecallRequest(10_000 + i, patterns[i % 3],
                                 rng.random(p.n_hcu) < SERVE_CUE,
                                 budget_ticks=SERVE_BUDGET))
    torch.cuda.synchronize()
    captures = srv.captures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        srv.step()
        torch.cuda.synchronize()
    if srv.captures != captures:
        fail("serve profile: the profiled step captured")
    t_lanes = srv.stacked.t.cpu().tolist()
    if t_lanes != [int(srv.template.t) + SERVE_STEP] * SERVE_SLOTS:
        fail(f"serve profile: lane tick counters {t_lanes} after one step "
             f"of {SERVE_STEP} ticks from {int(srv.template.t)}")
    nodes = []
    for lane in srv.graphs:
        cnt = collections.Counter()
        for g in lane.captured.values():
            cnt.update(graph_kernels(g))
        nodes.append({k: sum(c for nm, c in cnt.items() if tag in nm)
                      for k, tag in KERNEL_TAGS.items()})
    want_nodes = {k: SERVE_STEP * (k in BCPNN_KERNELS[:2])
                  for k in KERNEL_TAGS}
    if any(d != want_nodes for d in nodes):
        fail(f"serve profile: the lanes' graphs hold {nodes} kernel nodes, "
             f"expected {want_nodes} each")
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not evs:
        fail("serve profile: no device activity in the trace")
    n = SERVE_SLOTS * SERVE_STEP
    union, end = 0.0, evs[0][0]
    for s_, e_, _ in evs:
        union += max(0.0, e_ - max(s_, end))
        end = max(end, e_)
    span = max(e[1] for e in evs) - evs[0][0]
    by = collections.defaultdict(lambda: [0.0, 0])
    for s_, e_, nm in evs:
        by[nm][0] += e_ - s_
        by[nm][1] += 1
    busy = sum(v[0] for v in by.values()) / n
    ran = {k: sum(tag in e[2] for e in evs) for k, tag in KERNEL_TAGS.items()}
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"serve profile: one step of {n} lane-ticks (replays only, device "
          f"activity only): every lane's t {t_lanes[0]} on the device, each "
          f"lane's graph {json.dumps(want_nodes)} kernel nodes; the trace "
          f"recorded {json.dumps(ran)} (not a check: the profiler can lose "
          f"a record); device busy "
          f"{busy:.1f} us per lane-tick in {len(evs) / n:.1f} device ops; "
          f"span {span / n:.1f} us per lane-tick, idle share of the profiled "
          f"step {1 - union / span:.4f}")
    for nm, (t, c) in top:
        print(f"  device {t / n:9.1f} us/lane-tick {c / n:6.1f}/lane-tick  "
              f"{nm[:80]}")
    return {"device_busy_us_per_lane_tick": busy,
            "device_ops_per_lane_tick": len(evs) / n,
            "profiled_span_us_per_lane_tick": span / n,
            "idle_share_profiled_step": 1 - union / span,
            "top": {nm[:80]: t / n for nm, (t, _) in top}}


def phase_recall(report):
    """Phase 8: 8a-8d; adds each kernel's launches on these paths to the
    report (`launches_by_path`, counted at capture)."""
    paths = {"assoc_fixture": phase_assoc_fixture()}
    phase_retention()
    paths["resilient"] = phase_resilient()
    paths["serve_human"] = phase_serve()
    for e in report:
        if e["name"] in BCPNN_KERNELS:
            e["launches_by_path"] = {k: v[e["name"]] for k, v in paths.items()}


# ---------------------------------------------------------------------------
# phase 9: the sharded runtime
# ---------------------------------------------------------------------------

SHARD_TICKS = 100             # ticks of each sharded run (9a-9c)
SHARD_RANKS = 4               # gloo ranks spawned on the one card (9c-9e)
EXCHANGE_CALLS = 100          # all_to_all calls timed alone
ELASTIC_TICKS, ELASTIC_CHUNK = 24, 4
ELASTIC_LOSS = {3: 2}         # chunk -> ranks lost before it (9e)
# head_sharded_* fixture case -> (fixture, flags, the kernels it launches)
SHARD_FIXTURES = {
    "dense": ("sharded_dense", dict(worklist=False),
              ("row_update", "col_update")),
    **{f"worklist fused={f} fused_cols={fc}":
       ("sharded_worklist", dict(worklist=True, fused=f, fused_cols=fc),
        ("fused_row_update" if f else "worklist_row_update",
         "fused_col_update" if fc else "col_update"))
       for f in (True, False) for fc in (True, False)},
}


def exchange_us(mesh, rc):
    """µs per all_to_all of the exchange's (ranks, cap_route) int32 word
    buffer on ``mesh``'s group, alone: EXCHANGE_CALLS calls on the host
    clock up to a synchronise (gloo's exchange runs on the host, where
    CUDA events do not see it)."""
    import torch
    import torch.distributed as dist
    send = torch.zeros((mesh.size, rc.cap_route), dtype=torch.int32,
                       device=mesh.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EXCHANGE_CALLS):
        dist.all_to_all_single(recv, send, group=mesh.group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / EXCHANGE_CALLS * 1e6


def words_per_tick(fired, p, mesh, rc):
    """Valid spike words a tick (the fired HCUs' fan-out) against the
    exchange's slots (ranks x ranks x cap_route) and bytes a rank sends."""
    valid = float((fired >= 0).sum(1).double().mean()) * p.fanout
    return {"valid_words_per_tick": valid,
            "slots_per_tick": mesh.size * mesh.size * rc.cap_route,
            "bytes_sent_per_rank_per_tick": mesh.size * rc.cap_route * 4}


def sharded_nccl(tag, p, ext, mesh, rc, want, ref=None):
    """9a / 9b: `Simulator.run_sharded` on the 1-rank NCCL ``mesh`` at
    ``rc``: SHARD_TICKS ticks that capture the chunk's graph (the launch
    counters from 0: one launch of each fused kernel a captured tick and
    the scratch tick's, none of another), then SHARD_TICKS timed ticks
    that replay it under sync-debug "error", host clock ending in the one
    host read of the fired rows (no launch may be counted). The fired
    history of both must equal ``want`` ((2 SHARD_TICKS, H), a local
    `Simulator.run`); with ``ref`` (that local Simulator) every leaf of the
    state too. Then a device trace of SHARD_TICKS more replayed ticks
    (`profile_replay`) and the exchange alone. Returns a summary."""
    import torch
    from repro_torch.core import Simulator, network
    from repro_torch.core import distributed as DD
    S = SHARD_TICKS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(p, key=0)
    run = lambda e: sim.run_sharded(e, mesh, rc=rc)
    reset_launches()
    scratch = len(network.scratch_ticked)
    t0 = time.perf_counter()
    first = run(ext[:S]).cpu()
    first_s = time.perf_counter() - t0
    scratch = len(network.scratch_ticked) - scratch
    at_capture = bcpnn_counts()
    check_counts(f"{tag} (capture)", at_capture,
                 {"fused_row_update": S + scratch,
                  "fused_col_update": S + scratch})
    nodes = {L: graph_nodes(g) for L, g in sim.graphs.captured.items()}
    if sim.state.hcus.zij.shape[0] != p.n_hcu * p.rows:
        fail(f"{tag}: the rank holds {sim.state.hcus.zij.shape[0]} rows")
    reset_launches()
    torch.cuda.synchronize()
    with SMClocks() as clocks:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fired = run(ext[S:2 * S])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fired = fired.cpu()
        wall = time.perf_counter() - t0
    check_counts(f"{tag} (replay)", bcpnn_counts(), {})
    fired = torch.cat([first, fired])
    diff = int((fired != want).sum())
    drops = sim.drops()
    if diff and not (drops["route"] and ref is None):
        fail(f"{tag}: the fired history differs from the local run's in "
             f"{diff} places (drops {drops})")
    if ref is not None:
        for (a, _), (b, _) in zip(DD._spec_pairs(sim.state,
                                                 DD._shard_specs()[0]),
                                  DD._spec_pairs(ref.state,
                                                 DD._shard_specs()[0])):
            if not torch.equal(a, b):
                fail(f"{tag}: the state differs from the local run's")
    us = wall / S * 1e6
    replay = profile_replay(tag, sim, ext[2 * S:3 * S],
                            ("fused_row_update", "fused_col_update"), us,
                            run=run)
    exch = exchange_us(mesh, rc)
    words = words_per_tick(fired, p, mesh, rc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: run_sharded on 1 NCCL rank, rc {tuple(rc)}: {S} ticks "
          f"replayed in {wall:.4f} s = {us:.1f} us/tick (host clock ending "
          f"in the fired rows' host read; {clocks}); first call {first_s:.3f}"
          f" s (capture of {sorted(nodes)} ticks, {sum(nodes.values())} "
          f"nodes, {scratch} scratch tick); fired history "
          + ("bit for bit the local run's" if not diff else
             f"differs from the local run's in {diff} places (route drops)")
          + (" and every leaf of the state" if ref is not None else "")
          + f" ({int((fired >= 0).sum())} spikes); drops {drops}; launches "
          f"at capture {json.dumps(at_capture)}; exchange alone {exch:.1f} "
          f"us; {words['valid_words_per_tick']:.1f} valid words a tick in "
          f"{words['slots_per_tick']} slots; peak {peak:.3f} GiB")
    out = {"us_per_tick": us, "first_call_s": first_s, "nodes": nodes,
           "launches_at_capture": at_capture, "drops": drops,
           "fired_differs": diff, "replay": replay, "exchange_us": exch,
           "peak_gib": peak, **words}
    del sim
    torch.cuda.empty_cache()
    return out


def sharded_gloo(rank, world, p, ext, want, state100):
    """9c on one rank: `run_sharded` of SHARD_TICKS ticks at
    `lossless_route_config` on the gloo group of SHARD_RANKS ranks on the
    one card (tick by tick: gloo's exchange cannot be captured), host
    clock from a barrier to the fired rows' host read. The gathered fired
    history must equal ``want`` and this rank's slice of every state leaf
    the local run's at the same tick (``state100``, the parent's tensors
    through CUDA IPC); the ranks' drop counters must sum to the local
    run's. Returns a summary of this rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import Simulator
    from repro_torch.core import distributed as DD
    from repro_torch.launch.mesh import make_bcpnn_mesh
    mesh = make_bcpnn_mesh(device=torch.device("cuda", 0))
    rc = DD.lossless_route_config(p, p.n_hcu // world)
    sim = Simulator(p, key=0)
    ext = torch.from_numpy(ext).cuda()
    reset_launches()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fired = sim.run_sharded(ext, mesh, rc=rc).cpu()
    wall = time.perf_counter() - t0
    counts = bcpnn_counts()
    st, ref = sim.state, state100
    mine = lambda b: b[rank * (b.shape[0] // world):
                       (rank + 1) * (b.shape[0] // world)]
    pairs = [(getattr(st.hcus, f), mine(getattr(ref.hcus, f)))
             for f in st.hcus._fields]
    pairs += [(st.delay_rows, mine(ref.delay_rows)),
              (st.delay_count, mine(ref.delay_count)), (st.t, ref.t),
              (st.base_key, ref.base_key)]
    same = [bool(torch.equal(a, b)) for a, b in pairs]
    drops = torch.stack([sim.state.drops_in, sim.state.drops_fire,
                         sim.state.drops_route])
    dist.all_reduce(drops, group=mesh.group)
    want_drops = [int(state100.drops_in), int(state100.drops_fire), 0]
    exch = exchange_us(mesh, rc)
    out = {"us_per_tick": wall / SHARD_TICKS * 1e6,
           "fired_equal": bool(np.array_equal(fired.numpy(), want)),
           "leaves_equal": all(same), "leaves": len(same),
           "drops_sum": drops.tolist(), "drops_want": want_drops,
           "launches": counts, "exchange_us": exch,
           "rows": sim.state.hcus.zij.shape[0],
           **words_per_tick(fired, p, mesh, rc)}
    del sim, st, ref, state100, pairs
    torch.cuda.empty_cache()
    return out


def sharded_fixtures(rank, world):
    """9d on one rank: head_sharded_dense / head_sharded_worklist (8 HCUs,
    `default_route_config(p, 2)`) across the SHARD_RANKS gloo ranks on the
    card, the worklist one in the four fused / fused_cols combinations
    (kernels 1-5); rank 0 holds the gathered run to the fixture's contract
    (`fixture_gaps`). Each rank's launch counters, from 0 for each case,
    must show one launch a tick of the case's two kernels and none of any
    other. Returns {case: (launches, largest float gap)}."""
    import torch
    from repro_torch import convert
    from repro_torch.core import distributed as DD
    from repro_torch.core import network as N
    from repro_torch.core import rng
    from repro_torch.core.params import test_scale
    from repro_torch.launch.mesh import make_bcpnn_mesh
    p = test_scale(8, 64, 16)
    dev = torch.device("cuda", 0)
    mesh = make_bcpnn_mesh(device=dev)
    h = p.n_hcu // world
    out = {}
    for case, (name, kw, kernels) in SHARD_FIXTURES.items():
        d = dict(np.load(ROOT / "tests" / "fixtures" / f"head_{name}.npz"))
        state = N.init_network(p, rng.PRNGKey(0, dev))
        s, c = DD.shard_network(mesh, state, convert.conn_from_numpy(d, dev))
        fn = DD.make_dist_run(mesh, p, DD.default_route_config(p, 2), **kw)
        reset_launches()
        s, f = fn(s, c, torch.from_numpy(d["ext"][:, rank * h:(rank + 1) * h]))
        counts = bcpnn_counts()
        T = d["ext"].shape[0]
        check_counts(f"sharded fixture {case} (rank {rank})", counts,
                     {k: T for k in kernels})
        fired = DD.gather_fired(mesh, f).cpu().numpy()
        got = convert.state_to_numpy(DD.gather_network(mesh, s))
        gaps = fixture_gaps(f"sharded {case}", fired, got, d)
        out[case] = (counts, max(gaps.values()))
    return out


def sharded_elastic(rank, world, ckpt):
    """9e on one rank: `ElasticRunner` on test_scale(8, 64, 16) (worklist
    backend, the fused kernels) over the SHARD_RANKS gloo ranks on the
    card, ELASTIC_TICKS ticks in ELASTIC_CHUNK-tick chunks, losing the
    last 2 ranks before chunk 3: the survivors' fired history and every
    plane bit for bit a local `Simulator.run` at cap_fire H. Returns a
    summary, or "lost" on a lost rank."""
    import torch
    from repro_torch.core import Simulator
    from repro_torch.core.params import test_scale
    from repro_torch.runtime import DeviceLoss, ElasticRunner
    p = test_scale(8, 64, 16)
    ext = ext_tensor(p, ELASTIC_TICKS, lam=3.0, seed=11)
    ref = Simulator(p, key=0, cap_fire=p.n_hcu, worklist=True)
    want = ref.run(ext).cpu().numpy()
    sim = Simulator(p, key=0, worklist=True)
    pending = dict(ELASTIC_LOSS)
    runner = ElasticRunner(sim, ckpt, chunk_ticks=ELASTIC_CHUNK,
                           fail_injector=lambda c: pending.pop(c, 0))
    reset_launches()
    t0 = time.perf_counter()
    try:
        fired, health = runner.run(ext)
    except DeviceLoss:
        return "lost"
    wall = time.perf_counter() - t0
    if not np.array_equal(fired, want):
        fail(f"elastic (rank {rank}): the fired history differs from the "
             f"local run's in {int((fired != want).sum())} places")
    for f in sim.state.hcus._fields:
        if not torch.equal(getattr(sim.state.hcus, f),
                           getattr(ref.state.hcus, f)):
            fail(f"elastic (rank {rank}): {f} differs from the local run's")
    return {"wall_s": wall, "restarts": runner.restarts,
            "recoveries": runner.recoveries, "devices": runner.devices,
            "status": health["status"], "drops": health["drops"],
            "launches": bcpnn_counts(), "spikes": int((want >= 0).sum())}


def sharded_ranks(rank, world, p, ext, want, state100, ckpt):
    """9c-9e on one of the spawned gloo ranks (cuda:0 for all)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    out = {"9c": sharded_gloo(rank, world, p, ext, want, state100)}
    del state100
    out["9d"] = sharded_fixtures(rank, world)
    out["9e"] = sharded_elastic(rank, world, ckpt)
    return out


def phase_sharded(report):
    """Phase 9: the sharded runtime (`repro_torch.core.distributed`,
    `Simulator.run_sharded`, `ElasticRunner`) on the card. 9a / 9b in this
    process on a 1-rank NCCL group at human width (`sharded_nccl`); 9c-9e
    on SHARD_RANKS gloo ranks spawned on the one card (`sharded_ranks`),
    the only ranks this script starts. Adds each BCPNN kernel's launches
    on these paths to the report (`launches_by_path`)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import Simulator
    from repro_torch.core import distributed as DD
    from repro_torch.core import network as N
    from repro_torch.core.params import human_scale
    from repro_torch.launch.mesh import make_bcpnn_mesh
    from repro_torch.launch.ranks import spawn_ranks
    mem = lambda where: print(f"sharded: {allocated_gib():.3f} GiB "
                              f"allocated {where}")
    mem("at the start of the phase")
    p = human_scale(n_hcu=256)
    S = SHARD_TICKS
    ext = torch.from_numpy(ext_tensor(p, 3 * S)).cuda()
    # the local references: at cap_fire H (the lossless exchange's fired
    # batch), its state at tick S kept for 9c; at the default cap for 9b
    t0 = time.perf_counter()
    ref = Simulator(p, key=0, cap_fire=p.n_hcu)
    want = [ref.run(ext[:S])]
    state100 = N.tree_map(lambda a: a.clone(), ref.state)
    want = torch.cat(want + [ref.run(ext[S:2 * S])]).cpu()
    print(f"sharded: local references of {2 * S} ticks at cap_fire "
          f"{p.n_hcu} ({int((want >= 0).sum())} spikes) in "
          f"{time.perf_counter() - t0:.2f} s")
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix="sharded_"))
    paths = {}
    try:
        dev = torch.device("cuda", 0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_bcpnn_mesh()
            a = sharded_nccl("9a lossless", p, ext, mesh,
                             DD.lossless_route_config(p, p.n_hcu), want, ref)
            del ref
            torch.cuda.empty_cache()
            local = Simulator(p, key=0)
            want_b = torch.cat([local.run(ext[:S]),
                                local.run(ext[S:2 * S])]).cpu()
            del local
            b = sharded_nccl("9b default", p, ext, mesh,
                             DD.default_route_config(p, p.n_hcu, 1), want_b)
            mem("after 9a and 9b")
        finally:
            dist.destroy_process_group()
        mem("after destroy_process_group")
        paths["sharded_nccl"] = a["launches_at_capture"]
        paths["sharded_nccl_default_rc"] = b["launches_at_capture"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn_ranks(sharded_ranks, SHARD_RANKS, backend="gloo",
                          args=(p, ext[:S].cpu().numpy(),
                                want[:S].numpy(), state100,
                                str(tmp / "elastic")),
                          timeout_s=300)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mem("after the gloo ranks (state100 held)")
    del state100
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    mem("after del state100 and ipc_collect")
    c = [res[r]["9c"] for r in range(SHARD_RANKS)]
    for r, x in enumerate(c):
        if not (x["fired_equal"] and x["leaves_equal"]) or \
                x["drops_sum"] != x["drops_want"]:
            fail(f"9c rank {r}: {json.dumps(x)}")
        check_counts(f"9c rank {r}", x["launches"],
                     {"fused_row_update": S, "fused_col_update": S})
    print(f"9c: run_sharded on {SHARD_RANKS} gloo ranks on the one card "
          f"(each {c[0]['rows']} rows, lossless rc), {S} ticks tick by "
          f"tick: fired history and every rank's slice of the {c[0]['leaves']}"
          f" state leaves bit for bit the local run's at tick {S} (and 9a's"
          f"), drop counters summing to its {c[0]['drops_want']}; us/tick "
          f"by rank {[round(x['us_per_tick'], 1) for x in c]} (time-slicing "
          f"{SHARD_RANKS} processes on one card, not scaling); exchange "
          f"alone {[round(x['exchange_us'], 1) for x in c]} us; "
          f"{c[0]['valid_words_per_tick']:.1f} valid words a tick in "
          f"{c[0]['slots_per_tick']} slots; the spawn {spawn_s:.1f} s")
    d = res[0]["9d"]
    for case, (counts, gap) in d.items():
        print(f"9d {case}: head fixture on {SHARD_RANKS} ranks on the card: "
              f"fired history and integer leaves exact, largest float gap "
              f"{gap:.3g}; launches on rank 0 {json.dumps(counts)}")
    e = [res[r]["9e"] for r in range(SHARD_RANKS)]
    lost = [r for r, x in enumerate(e) if x == "lost"]
    live = [x for x in e if x != "lost"]
    if lost != [2, 3] or any(x["restarts"] != 1 or x["devices"] != [0, 1]
                             for x in live):
        fail(f"9e: {json.dumps(e)}")
    print(f"9e: ElasticRunner on {SHARD_RANKS} gloo ranks, ranks {lost} "
          f"lost before chunk 3: the survivors' fired history and planes "
          f"bit for bit the local run's ({live[0]['spikes']} spikes), "
          f"recovery {json.dumps(live[0]['recoveries'])}, run "
          f"{live[0]['wall_s']:.2f} s, health {live[0]['status']}, drops "
          f"{json.dumps(live[0]['drops'])}")
    paths["sharded_gloo_4_ranks"] = {k: sum(x["launches"][k] for x in c)
                                     for k in BCPNN_KERNELS}
    paths["sharded_fixtures"] = {k: sum(v[0][k] for r in range(SHARD_RANKS)
                                        for v in res[r]["9d"].values())
                                 for k in BCPNN_KERNELS}
    paths["elastic"] = {k: sum(x["launches"][k] for x in live)
                        for k in BCPNN_KERNELS}
    for entry in report:
        if entry["name"] in BCPNN_KERNELS:
            entry.setdefault("launches_by_path", {}).update(
                {k: v[entry["name"]] for k, v in paths.items()})
    print("sharded summary:", json.dumps({"9a": a, "9b": b, "9c": c}))


# ---------------------------------------------------------------------------
# phase 11: LM training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS, TRAIN_STOP = 30, 20      # (c): stop at TRAIN_STOP, resume
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_PROFILED = 10                   # the step (b) profiles
# the launcher's default lr, 3e-3 (sized for the smoke configs), diverges
# at full width: on an H100, losses 12.25 -> 13.22 in 30 steps and a grad
# norm of 11.7 at step 13 (PERF.md §5, phase 11b)
TRAIN_LR = 5e-4
TRAIN_SKIP = 3                        # steps left out of the median


def allocated_gib():
    import torch
    return torch.cuda.memory_allocated() / 2**30


def phase_train_fixture(dev):
    """11a: tests/fixtures/train_smoke.npz on the card at float32 (TF32
    off): every family's first-step gradients and 20 train steps held to
    the CPU test's bounds (tests/test_torch_train.py)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_train as TT
    from repro_torch.configs import ARCH_IDS
    ref = TT.load_fixture()
    t0 = time.perf_counter()
    bad = []
    for arch in ARCH_IDS:
        g = TT.fixture_gaps(ref, arch, *TT.run_fixture(ref, arch, dev))
        try:
            TT.check_gaps(arch, g)
        except AssertionError:
            bad.append(arch)
        print(f"train fixture {arch} on the card: first-step gradient "
              f"{g['grad0']:.3g}, step 0 {max(g['step0'].values()):.3g}, "
              f"steps {max(g['steps'].values()):.3g}, parameters "
              f"{g['param_units']:.3g} lr*steps, moments "
              f"{g['moments']:.3g}, norms {g['norms']:.3g}"
              + (" BEYOND THE BOUNDS" if arch in bad else ""))
    if bad:
        fail(f"train fixture on the card: {bad} beyond the bounds of "
             f"tests/test_torch_train.py")
    print(f"train fixture: {len(ARCH_IDS)} families within the bounds in "
          f"{time.perf_counter() - t0:.1f} s")


# profile rows of a training step: (row, test on the launching op's name
# chain, innermost first); the first row that matches takes the kernel
TRAIN_ROWS = (
    ("optimizer (AdamW, clip norm)", lambda ops: "adamw" in ops),
    ("cross entropy (V = 151936)",
     lambda ops: "cross_entropy" in ops or any(
         k in " ".join(ops) for k in ("LogsumexpBackward", "GatherBackward"))),
    ("GEMMs, attention (float32 bmm)", lambda ops: ops[0] == "aten::bmm"),
    ("GEMMs (bf16 mm: projections, MLP, LM head)",
     lambda ops: ops[0] in ("aten::mm", "aten::addmm")),
    ("dtype casts (per-matmul bf16 and float32)",
     lambda ops: ops[0] == "aten::copy_" and "aten::_to_copy" in ops),
    ("attention softmax and mask",
     lambda ops: ops[0] in ("aten::_softmax", "aten::_softmax_backward_data",
                            "aten::where")),
    ("other (norms, RoPE, silu, residuals, embedding)", lambda ops: True),
)


def train_rows(prof):
    """Device ms of a profiled step by TRAIN_ROWS, from each kernel's
    launching op and that op's ancestors."""
    from torch.autograd import DeviceType
    rows = {name: 0.0 for name, _ in TRAIN_ROWS}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ops, up = [], e
        while up is not None:
            ops.append(up.name)
            up = up.cpu_parent
        row = next(name for name, test in TRAIN_ROWS if test(ops))
        rows[row] += sum(k.duration for k in e.kernels) / 1e3
    return rows


def phase_train(dev, smi):
    """11b and 11c: qwen2-1.5b at full width through `launch.train.train`,
    then stopped at TRAIN_STOP and resumed from its checkpoint. Returns
    the flash kernel's launches in 11b (0: training attends densely)."""
    import shutil
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    held = allocated_gib()
    print(f"train: {held:.3f} GiB allocated at the start of the phase")
    torch.cuda.reset_peak_memory_stats()
    steps, prof = [], {}

    def on_step(step, metrics, seconds):
        steps.append((step, metrics, seconds))
        if step == TRAIN_PROFILED - 1:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
        elif step == TRAIN_PROFILED:
            torch.cuda.synchronize()
            prof["p"].__exit__(None, None, None)

    reset_launches()
    t0 = time.perf_counter()
    model, losses = train(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                          smoke=False, lr=TRAIN_LR, log_every=10,
                          on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_launches()
    if any(counts.values()):
        fail(f"train: kernels launched {json.dumps(counts)}, expected none "
             f"(dense attention)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = model.cfg
    n_params = sum(t.numel() for t in model.parameters())
    ckpt_gb = 3 * 4 * n_params / 1e9      # params, mu, nu in float32
    del model
    torch.cuda.empty_cache()
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train: losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"train: the mean of the last 5 losses {last} is not below "
             f"that of the first 5, {first}")
    ms = [s * 1e3 for step, _, s in steps
          if step >= TRAIN_SKIP and step != TRAIN_PROFILED]
    med = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gnorms = [m["grad_norm"] for _, m, _ in steps]
    print(f"train [{smi}]: {cfg.arch_id} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}, {n_params} "
          f"float32 parameters, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat}, attn_impl {cfg.attn_impl}), batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, MarkovLM seed 0: {TRAIN_STEPS} steps in "
          f"{wall:.2f} s; ms a step (host clock to the loss's host read) "
          f"median {med:.2f} over steps {TRAIN_SKIP}-{TRAIN_STEPS - 1} but "
          f"the profiled {TRAIN_PROFILED} (min {min(ms):.2f}, max "
          f"{max(ms):.2f}; first {steps[0][2] * 1e3:.1f}); "
          f"{tokens / med * 1e3:.0f} tokens/s; peak {peak:.2f} GiB "
          f"allocated ({peak - held:.2f} above the {held:.2f} held); "
          f"losses first {losses[0]:.4f}, mean of the first 5 {first:.4f}, "
          f"last 5 {last:.4f}, last {losses[-1]:.4f}; launches "
          f"{json.dumps(counts)}")
    print(f"train losses: {[round(x, 4) for x in losses]}")
    print(f"train grad norms: {[round(x, 3) for x in gnorms]}")
    summary = dict(losses=losses, ms=med, tokens_per_s=tokens / med * 1e3,
                   peak=peak)
    rows = train_rows(prof["p"])
    total = sum(rows.values())
    if not total:
        fail("train: no CUDA activity in the profiled step")
    print(f"train profiled step {TRAIN_PROFILED} [{smi}]: device busy "
          f"{total:.2f} ms (host {steps[TRAIN_PROFILED][2] * 1e3:.1f} ms, "
          f"profiled)")
    for name, t in sorted(rows.items(), key=lambda r: -r[1]):
        print(f"  device {t:9.3f} ms  {t / total:6.1%}  {name}")
    kernel_rows, _ = device_rows(prof["p"])
    print_rows(kernel_rows)
    del prof["p"]

    # 11c: stop at TRAIN_STOP, resume from the checkpoint to TRAIN_STEPS
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base, prefix="train_ckpt_")
    step_s = []
    timed_steps = lambda step, metrics, seconds: step_s.append(seconds)
    print(f"train resume: {shutil.disk_usage(tmp).free / 1e9:.1f} GB free "
          f"under build/")
    try:
        t0 = time.perf_counter()
        _, head = train(TRAIN_ARCH, TRAIN_STOP, TRAIN_BATCH, TRAIN_SEQ,
                        smoke=False, ckpt_dir=tmp, lr=TRAIN_LR,
                        log_every=1000, on_step=timed_steps)
        t1 = time.perf_counter()
        _, tail = train(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                        smoke=False, ckpt_dir=tmp, lr=TRAIN_LR,
                        log_every=1000, on_step=timed_steps)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    resumed = head + tail
    if len(tail) != TRAIN_STEPS - TRAIN_STOP:
        fail(f"train resume: {len(tail)} steps after the restore")
    if not np.allclose(resumed, losses, rtol=1e-5, atol=1e-6):
        fail(f"train resume: losses {resumed} differ from the straight "
             f"run's {losses}")
    same = [a == b for a, b in zip(resumed, losses)]
    io = (t2 - t0) - sum(step_s)
    print(f"train resume [{smi}]: {TRAIN_STOP} steps and a checkpoint in "
          f"{t1 - t0:.1f} s, restore_latest and {TRAIN_STEPS - TRAIN_STOP} "
          f"steps and a checkpoint in {t2 - t1:.1f} s ({io:.1f} s of it not "
          f"in steps: two saves of {ckpt_gb:.2f} GB, a restore, two model "
          f"inits); losses within rtol "
          f"1e-5 of the straight run's; bit for bit at "
          f"{sum(same)} of {len(same)} steps (max |diff| "
          f"{max(abs(a - b) for a, b in zip(resumed, losses)):.3g}, steps "
          f"{TRAIN_STOP}-{TRAIN_STEPS - 1} after the restore)")
    return counts["flash_attention"], summary


# ---------------------------------------------------------------------------
# phase 12: LM training through the mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 5                        # 12a: 11b's first steps, bit for bit
MESH_RANK_STEPS = 3                   # 12b: steps on each mesh
MESH_RANKS = 2                        # 12b: gloo ranks on the one card
# 12b: depth, cut from 28 for time, not memory: at 28 layers both meshes
# fit (18.7 and 28.1 GiB a rank) but gloo stages every collective through
# the host, 52-58 s a TP step and 14-16 s a ZeRO step, 230 s in all (an
# NVIDIA H100 80GB HBM3 at 700 W, torch 2.11)
MESH_LAYERS = 4
# 12b against the one-device run of the same model, relative, each step:
# bf16 compute rounds each matmul output to 8 bits of mantissa (2^-9 =
# 2e-3); a sharded matmul sums its halves in another order, so outputs
# differ by about an ulp here and there, and the loss (a mean of 8192
# tokens) by far less; grad norms (one step's gradients, before any
# averaging over steps) move more
MESH_LOSS_RTOL = 5e-3
MESH_GNORM_RTOL = 5e-2


def mesh_rank(rank, world, cfg, steps):
    """12b on one gloo rank (cuda:0 for both): `launch.train.train` on a
    (1, 2) mesh (tensor parallel), then on a (2, 1) mesh with ZeRO
    moments; each run's losses, grad norms, ms a step and peak GiB."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    out = {}
    for tag, shape, zero in (("tp", (1, 2), False), ("zero", (2, 1), True)):
        mesh = make_host_mesh(shape)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got = []
        t0 = time.perf_counter()
        _, losses = train(TRAIN_ARCH, steps, TRAIN_BATCH, TRAIN_SEQ,
                          cfg=cfg, lr=TRAIN_LR, mesh=mesh, zero=zero,
                          log_every=1000,
                          on_step=lambda st, m, sec: got.append(
                              (m["grad_norm"], sec)))
        out[tag] = dict(losses=losses, gnorms=[g for g, _ in got],
                        ms=[sec * 1e3 for _, sec in got],
                        wall=time.perf_counter() - t0,
                        peak=torch.cuda.max_memory_allocated() / 2**30,
                        launches=read_launches())
        torch.cuda.empty_cache()
    return out


def phase_train_mesh(smi, ref):
    """12a and 12b: `launch.train.train(mesh=...)` on the card. ``ref`` is
    phase 11b's summary (losses, ms a step, tokens/s, peak GiB)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    held = allocated_gib()
    print(f"train mesh: {held:.3f} GiB allocated at the start of the phase")
    t_phase = time.perf_counter()

    # 12a: a 1-rank NCCL group, the default host mesh (1, 1)
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    steps = []
    with tempfile.TemporaryDirectory(dir=base, prefix="mesh_") as tmp:
        dev = torch.device("cuda", 0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_host_mesh()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            model, losses = train(
                TRAIN_ARCH, MESH_STEPS, TRAIN_BATCH, TRAIN_SEQ, smoke=False,
                lr=TRAIN_LR, mesh=mesh, log_every=1000,
                on_step=lambda st, m, sec: steps.append(sec))
            wall = time.perf_counter() - t0
            counts = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            placed = {str(p.placements) for p in model.parameters()}
            del model
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    if any(counts.values()):
        fail(f"12a: kernels launched {json.dumps(counts)}, expected none")
    want = ref["losses"][:MESH_STEPS]
    same = [a == b for a, b in zip(losses, want)]
    if not all(same) or len(losses) != MESH_STEPS:
        fail(f"12a: losses {losses} are not 11b's first {MESH_STEPS}, "
             f"{want}")
    ms = [s * 1e3 for s in steps[1:]]
    med = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"12a [{smi}]: {TRAIN_ARCH} at full width through "
          f"train(mesh=make_host_mesh()) on a 1-rank NCCL group, mesh (1, 1) "
          f"('data', 'model'), parameters DTensors ({sorted(placed)}): "
          f"{MESH_STEPS} steps in {wall:.2f} s, losses bit for bit 11b's "
          f"first {MESH_STEPS} ({[round(x, 4) for x in losses]}); ms a step "
          f"median {med:.2f} over steps 1-{MESH_STEPS - 1} (first "
          f"{steps[0] * 1e3:.1f}) against 11b's {ref['ms']:.2f}: "
          f"{med - ref['ms']:+.2f} ms of DTensor dispatch; "
          f"{tokens / med * 1e3:.0f} tokens/s against "
          f"{ref['tokens_per_s']:.0f}; peak {peak:.2f} GiB against "
          f"{ref['peak']:.2f}; launches {json.dumps(counts)}")

    # 12b: two gloo ranks on the card against the one-device run
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    got1 = []
    t0 = time.perf_counter()
    _, one = train(TRAIN_ARCH, MESH_RANK_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                   cfg=cfg, lr=TRAIN_LR, log_every=1000,
                   on_step=lambda st, m, sec: got1.append(m["grad_norm"]))
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(mesh_rank, MESH_RANKS, backend="gloo",
                      args=(cfg, MESH_RANK_STEPS), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    for tag in ("tp", "zero"):
        runs = [res[r][tag] for r in range(MESH_RANKS)]
        for r, x in enumerate(runs):
            if any(x["launches"].values()):
                fail(f"12b {tag} rank {r}: kernels launched "
                     f"{json.dumps(x['launches'])}")
            loss_gap = max(abs(a - b) / abs(b)
                           for a, b in zip(x["losses"], one))
            gn_gap = max(abs(a - b) / abs(b)
                         for a, b in zip(x["gnorms"], got1))
            if len(x["losses"]) != MESH_RANK_STEPS or \
                    not np.isfinite(x["losses"]).all() or \
                    loss_gap > MESH_LOSS_RTOL or gn_gap > MESH_GNORM_RTOL:
                fail(f"12b {tag} rank {r}: losses {x['losses']}, grad "
                     f"norms {x['gnorms']} against the one-device "
                     f"{one}, {got1}")
        x = runs[0]
        print(f"12b {tag} [{smi}]: {TRAIN_ARCH} at published widths, "
              f"{MESH_LAYERS} layers, mesh "
              f"{'(1, 2) tensor parallel' if tag == 'tp' else '(2, 1), ZeRO moments'}"
              f" on {MESH_RANKS} gloo ranks sharing the card: losses "
              f"{[round(v, 5) for v in x['losses']]} against one device's "
              f"{[round(v, 5) for v in one]} (largest relative gap "
              f"{max(abs(a - b) / abs(b) for a, b in zip(x['losses'], one)):.2e}"
              f", bound {MESH_LOSS_RTOL}), grad norms "
              f"{[round(v, 4) for v in x['gnorms']]} against "
              f"{[round(v, 4) for v in got1]} (bound {MESH_GNORM_RTOL}); ms a "
              f"step by rank {[[round(v, 1) for v in y['ms']] for y in runs]}"
              f" (two processes time-slicing one card over gloo, not "
              f"scaling); peak GiB by rank "
              f"{[round(y['peak'], 2) for y in runs]} (one device "
              f"{one_peak:.2f}); launches {json.dumps(x['launches'])}")
    print(f"12b: one-device reference {one_s:.1f} s, the spawn and both "
          f"meshes {spawn_s:.1f} s; phase 12 {time.perf_counter() - t_phase:.1f}"
          f" s")
    return {"12a": counts["flash_attention"],
            "12b": sum(res[r][t]["launches"]["flash_attention"]
                       for r in range(MESH_RANKS) for t in ("tp", "zero"))}


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
    # ptxas -v: each flash kernel's name, then its spills and registers
    for line in _build.build_log.get("flash_attention", "").splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            print(" ", name[name.rindex("flash_"):], end=":")
        elif "spill" in line or "Used" in line:
            print("", line.split(":", 1)[-1].strip(), end="\n" if "Used" in line else ";")

    from repro_torch.core.params import human_scale
    dev = torch.device("cuda")
    done = lambda phase: print(f"{phase}: done {time.perf_counter() - t0:.1f} "
                               f"s after the build began")
    report, tile = phase_kernels(human_scale(n_hcu=256), dev)
    done("kernels")
    phase_fixtures(dev)
    done("fixtures")
    phase_paths(report, tile)
    done("paths")
    phase_checkpoints(dev)
    done("checkpoints")
    phase_recall(report)
    done("recall")
    flash = phase_flash(dev)
    done("flash")
    by_path = {"qwen2-1.5b f32 prefill": phase_flash_f32(dev, smi)}
    done("flash f32 prefill")
    phase_lm_fixture(dev)
    phase_lm_families_fixture(dev)
    by_path["qwen2-1.5b"] = phase_lm(dev, smi)
    done("lm")
    phase_sharded(report)
    done("sharded")
    print(f"families: {allocated_gib():.3f} GiB allocated at the start of "
          f"the phase")
    by_path.update(phase_families(dev, smi))
    done("families")
    phase_train_fixture(dev)
    by_path[f"{TRAIN_ARCH} train"], train_ref = phase_train(dev, smi)
    done("train")
    mesh_counts = phase_train_mesh(smi, train_ref)
    for tag, n in mesh_counts.items():
        by_path[f"{TRAIN_ARCH} train mesh {tag}"] = n
    for entry in report:
        if entry["name"] in BCPNN_KERNELS:
            entry.setdefault("launches_by_path", {}).update(
                {f"train mesh {tag}": 0 for tag in mesh_counts})
    done("train mesh")
    flash["launches"] = sum(by_path.values())
    flash["launches_by_path"] = by_path
    report.append(flash)
    print("the BCPNN kernels' library_ms is null: no single PyTorch call "
          "computes a cell-math pass; flash_attention's is "
          "scaled_dot_product_attention (enable_gqa) at the qwen2-1.5b bf16 "
          "shape (by_shape: at each shape without softcap or window); its "
          "launches are the LM serving runs' of phases 6b, 7 and 10; "
          "training "
          "(phases 11b and 12) launches none of the six kernels")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
