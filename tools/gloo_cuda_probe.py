"""Which collectives gloo runs on CUDA tensors: 2 gloo ranks sharing
cuda:0, each collective in its own spawn (a crash ends only that spawn).

    python3 tools/gloo_cuda_probe.py

The functional collectives DTensor issues (all-reduce, all-gather into
one tensor, reduce-scatter, all-to-all, broadcast), then DTensor's
redistributions on a 2-rank mesh (Shard -> Replicate, Partial ->
Replicate, Partial -> Shard, Shard(0) -> Shard(1)), first as torch ships
them and then with the port's repair installed (`launch.mesh.
_repair_gloo_cuda_all_gather`, which an LM mesh of gloo ranks on a card
installs). Prints one line a case: ok and rank 0's result, or the failure
(a crash shows as the signal that ended the rank).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

CASES = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
         "dt_S_R", "dt_P_R", "dt_P_S", "dt_S0_S1"]


def probe(rank, world, case, repaired):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, Partial, distribute_tensor
    torch.cuda.set_device(0)
    if repaired:
        from repro_torch.launch.mesh import _repair_gloo_cuda_all_gather
        _repair_gloo_cuda_all_gather()
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    g = dist.group.WORLD
    if case == "all_reduce":
        y = fc.all_reduce(x, "sum", g)
    elif case == "all_gather":
        y = fc.all_gather_tensor(x, 0, g)
    elif case == "reduce_scatter":
        y = fc.reduce_scatter_tensor(x, "sum", 0, g)
    elif case == "all_to_all":
        y = fc.all_to_all_single(x, None, None, g)
    elif case == "broadcast":
        y = fc.broadcast(x, 0, g)
    else:
        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("m",))
        t = torch.arange(16, dtype=torch.float32, device="cuda").reshape(4, 4)
        if case == "dt_S_R":
            y = distribute_tensor(t, mesh, [Shard(0)]).redistribute(mesh, [Replicate()]).to_local()
        elif case == "dt_P_R":
            y = DTensor.from_local(t, mesh, [Partial()]).redistribute(mesh, [Replicate()]).to_local()
        elif case == "dt_P_S":
            y = DTensor.from_local(t, mesh, [Partial()]).redistribute(mesh, [Shard(0)]).to_local()
        else:
            y = distribute_tensor(t, mesh, [Shard(0)]).redistribute(mesh, [Shard(1)]).to_local()
    if hasattr(y, "wait"):
        y = y.wait()
    torch.cuda.synchronize()
    return y.cpu().tolist()


def main():
    import torch
    from repro_torch.launch.ranks import spawn_ranks
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    for repaired in (False, True):
        for c in CASES:
            tag = f"{c}{' (repaired)' if repaired else ''}"
            try:
                r = spawn_ranks(probe, 2, backend="gloo", args=(c, repaired),
                                timeout_s=120)
                print(f"gloo cuda {tag}: ok {r[0]}", flush=True)
            except Exception as e:    # noqa: BLE001 — the probe's finding
                msg = str(e).strip().splitlines()
                print(f"gloo cuda {tag}: FAILED {msg[-1] if msg else e}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
