"""Run a function on the ranks of a process group on this machine: the
launcher of the port's sharded BCPNN runtime for one host.

    results = spawn_ranks(fn, 4, backend="gloo", args=(p,))

starts ``world`` processes (the ``spawn`` method), joins them into one
`torch.distributed` group through a file store in a fresh temporary
directory (so that concurrent launches never share a rendezvous), runs
``fn(rank, world, *args)`` on each, and returns {rank: its result}. A
result travels back pickled: numpy arrays and plain values, not CUDA
tensors. CUDA tensors in ``args`` reach the ranks through CUDA IPC; each
rank frees them when ``fn`` returns, so the parent's copy is freed (after
`torch.cuda.ipc_collect`) once it drops it. An NCCL group takes one rank per GPU, rank r on ``cuda:r``;
several ranks on one card, and ranks on the CPU, take gloo.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world: int, backend: str, store: str,
               results, timeout_s: float, box: list) -> None:
    # The process object keeps its arguments until the interpreter exits,
    # and a CUDA tensor received through CUDA IPC is released to its
    # producer only when freed here: so the arguments come in a list that
    # is emptied, and they go when this returns.
    args = box.pop()
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", rank)
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, device_id=device_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results.put((rank, fn(rank, world, *args)))
    finally:
        del args
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *, backend: str = "gloo", args=(),
                timeout_s: float = 300.0) -> dict:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    ``backend`` group and return {rank: result}. ``fn`` must be importable
    by the children (a module-level function). A rank that raises makes
    this raise its traceback (`torch.multiprocessing.ProcessRaisedException`)
    after the others are stopped; so does a run longer than
    ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _rank_main, args=(fn, world, backend, os.path.join(tmp, "store"),
                              results, timeout_s, [args]),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            # drain before joining: a child blocks on a full pipe until read
            while len(out) < world:
                try:
                    rank, res = results.get(timeout=1.0)
                    out[rank] = res
                except queue.Empty:
                    if procs.join(timeout=0) and len(out) < world:
                        raise RuntimeError(f"ranks exited with results from "
                                           f"{sorted(out)} only")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks ran over {timeout_s} s")
            while not procs.join(timeout=max(deadline - time.monotonic(),
                                             1.0)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks ran over {timeout_s} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
    return out
