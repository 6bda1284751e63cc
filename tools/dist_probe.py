"""What the sharded runtime's transport can rely on, on one CUDA card:

* which gloo collectives take CUDA tensors (2 spawned ranks on the one
  card), the all_to_all's values, and 100 all_to_alls of a (2, 25600)
  int32 buffer as CUDA tensors against a copy to the host and back;
* an NCCL all_to_all on a 1-rank group: eager, then captured in a CUDA
  graph on a side stream and replayed (also under sync-debug "error").

    python3 tools/dist_probe.py     # from the repository root, on a CUDA card
"""
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def gloo_rank(rank, world, path, out):
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {}
    send = torch.arange(world * 4, dtype=torch.int32, device=dev) + 100 * rank
    send = send.reshape(world, 4)
    for name, fn in [
        ("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty_like(send), send)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, dtype=torch.int32, device=dev), send[0])),
        ("all_gather", lambda: dist.all_gather(
            [torch.empty(4, dtype=torch.int32, device=dev) for _ in range(world)],
            send[0])),
        ("broadcast", lambda: dist.broadcast(send.clone(), 0)),
        ("all_reduce", lambda: dist.all_reduce(send.clone())),
    ]:
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # record what gloo refuses, then go on
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    # correctness of all_to_all_single on cuda
    try:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        res["a2a_values"] = recv.cpu().tolist()
    except Exception as e:
        res["a2a_values"] = repr(e)[:100]
    t = time.perf_counter()
    for _ in range(100):
        recv = torch.empty((world, 25600), dtype=torch.int32, device=dev)
        dist.all_to_all_single(recv, torch.zeros_like(recv))
    torch.cuda.synchronize()
    res["a2a_cuda_100KB_us"] = (time.perf_counter() - t) * 1e4
    t = time.perf_counter()
    for _ in range(100):
        s = torch.zeros((world, 25600), dtype=torch.int32, device=dev).cpu()
        r = torch.empty_like(s)
        dist.all_to_all_single(r, s)
        r.to(dev)
    torch.cuda.synchronize()
    res["a2a_host_100KB_us"] = (time.perf_counter() - t) * 1e4
    out.put((rank, res))
    dist.destroy_process_group()


def nccl_graph():
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = "29533"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=0, world_size=1, device_id=dev)
    send = torch.arange(8, dtype=torch.int32, device=dev).reshape(1, 8)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    torch.cuda.synchronize()
    print("nccl eager a2a", recv.tolist())
    side = torch.cuda.Stream(dev)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        g.capture_begin()
        try:
            x = send * 2
            dist.all_to_all_single(recv, x)
            y = recv + 1
            recv.copy_(y)
        except BaseException:
            try:
                g.capture_end()
            except RuntimeError:
                pass
            raise
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    g.instantiate()
    send.fill_(5)
    g.replay()
    torch.cuda.synchronize()
    print("nccl graph a2a replay", recv.tolist(), "(want all 11)")
    send.fill_(7)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    print("nccl graph a2a replay 2", recv.tolist(), "(want all 15)")
    # graph with sync-debug error
    torch.cuda.set_sync_debug_mode("error")
    send.fill_(1)
    g.replay()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("nccl graph under sync-debug", recv.tolist(), "(want all 3)")
    # eager a2a under sync-debug error
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist.all_to_all_single(recv, send)
        print("nccl eager a2a under sync-debug error: ok")
    except Exception as e:
        print("nccl eager a2a under sync-debug error:", repr(e)[:200])
    torch.cuda.set_sync_debug_mode(0)
    dist.destroy_process_group()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.nccl.version())
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(gloo_rank, args=(2, os.path.join(tmp, "store"), out),
                 nprocs=2, join=True)
        print("gloo spawn 2 ranks s", time.perf_counter() - t)
    for _ in range(2):
        print("gloo", out.get())
    try:
        nccl_graph()
    except Exception:
        traceback.print_exc()
        print("NCCL GRAPH FAILED")


if __name__ == "__main__":
    main()
