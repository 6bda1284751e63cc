"""Meshes of the port (the port of `repro.launch.mesh`): the sharded BCPNN
runtime's HCU mesh and the LM substrate's (data, model) meshes.

The JAX package shards whole HCUs over a 1-D ``jax.sharding.Mesh`` with
one axis, "hcu". The port runs one process per rank of a
`torch.distributed` process group, and the mesh is that group: an
`HcuMesh` names the group, this process's rank in it, the group's size
and the device the rank's tensors live on. Several ranks may share one
card (gloo; NCCL refuses two ranks on one GPU).

The LM substrate's meshes (`make_host_mesh`, `make_production_mesh`) are
`torch.distributed.device_mesh.DeviceMesh`es over the default group's
ranks, with the JAX package's axis names; the LM sharding lays tensors on
them as DTensors (`launch.shardings`, `models.sharding`). A mesh of gloo
ranks on CUDA (several ranks on one card) routes DTensor's all-gathers
through gloo's list all-gather (`_repair_gloo_cuda_all_gather`).

Nothing here touches a process group while the module is imported.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


class HcuMesh(NamedTuple):
    """A 1-D HCU mesh: ``group`` (a `torch.distributed` process group),
    this process's ``rank`` in it, its ``size`` and the ``device`` of the
    rank's tensors. Rank r holds HCUs [r * h_local, (r + 1) * h_local)."""
    group: object
    rank: int
    size: int
    device: torch.device


def _mesh_device(group, device) -> torch.device:
    dev = resolve_device(device)
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group exchanges CUDA tensors only, got "
                         f"device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_bcpnn_mesh(n_devices: int | None = None, *, group=None,
                    device=None) -> HcuMesh | None:
    """The HCU mesh over the first ``n_devices`` ranks of ``group`` (the
    default process group unless given; all of its ranks when
    ``n_devices`` is None). ``device`` is where this rank's tensors live
    (`core.device.resolve_device`: CUDA unless the caller asks for the CPU;
    an NCCL group takes CUDA only). Every rank of ``group`` calls it, in
    the same order as its other groups (`_new_group`); a rank outside the
    first ``n_devices`` gets None."""
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    n = size if n_devices is None else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"n_devices must lie in [1, {size}], got {n}")
    if n < size:
        return _prefix_mesh(group, list(range(n)), device)
    return HcuMesh(group, dist.get_rank(group), n, _mesh_device(group, device))


def _new_group(group, ranks):
    """A process group of ``ranks`` (ranks of ``group``). Made with
    torch's default naming (a per-process count of the groups made so
    far), so every rank that takes part in later groups has to make this
    one too, members or not; torch's ``use_local_synchronization`` names a
    group by the count of groups each process knows, which differs between
    members and non-members of earlier groups and then never meets."""
    return dist.new_group([dist.get_global_rank(group, r) for r in ranks],
                          backend=dist.get_backend(group))


def _prefix_mesh(group, ranks, device) -> HcuMesh | None:
    sub = _new_group(group, ranks)
    me = dist.get_rank(group)
    if me not in ranks:
        return None
    return HcuMesh(sub, ranks.index(me), len(ranks), _mesh_device(sub, device))


def elastic_device_count(n_hcu: int, n_available: int) -> int:
    """Degraded-mode mesh size: the largest device count <= the survivors
    that divides the hypercolumn count (`make_dist_run` shards whole HCUs,
    h_local = H // ndev — H % ndev must be 0). Always >= 1: a single
    survivor can host the entire network."""
    n = max(min(int(n_available), int(n_hcu)), 1)
    while n_hcu % n:
        n -= 1
    return n


def make_elastic_mesh(n_hcu: int, ranks=None, *, group=None,
                      device=None) -> HcuMesh | None:
    """1-D HCU mesh over (a whole-HCU-divisible prefix of) the surviving
    ``ranks`` (ranks of ``group``, default: all of them) — the mesh
    `ElasticRunner` re-places onto after a device loss. Every surviving
    rank calls it (`_new_group`); a caller outside the prefix gets None."""
    group = dist.group.WORLD if group is None else group
    ranks = (list(range(dist.get_world_size(group))) if ranks is None
             else list(ranks))
    return _prefix_mesh(group, ranks[:elastic_device_count(n_hcu,
                                                           len(ranks))],
                        device)


_GLOO_CUDA_GATHER: list = []     # the library that holds the repair


def _gloo_cuda_all_gather(input, group_size, group_name):
    """`_c10d_functional.all_gather_into_tensor` for CUDA tensors: through
    gloo's list all-gather where the group is gloo's (its flat
    `_allgather_base` on CUDA tensors ends the process with SIGSEGV in
    torch 2.11: tools/gloo_cuda_probe.py), else the group's own
    all-gather into one tensor."""
    pg = group_name if isinstance(group_name, dist.ProcessGroup) else \
        torch._C._distributed_c10d._resolve_process_group(group_name)
    src = input.contiguous()
    if dist.get_backend(pg) != "gloo":
        out = src.new_empty((group_size * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=pg)
        return out
    parts = [torch.empty_like(src) for _ in range(group_size)]
    dist.all_gather(parts, src, group=pg)
    return torch.cat(parts)


def _repair_gloo_cuda_all_gather():
    """Route DTensor's all-gathers of CUDA tensors around gloo's crashing
    flat all-gather (`_gloo_cuda_all_gather`), once a process: what an LM
    mesh of gloo ranks on a card (several ranks sharing it) needs."""
    if not _GLOO_CUDA_GATHER:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _gloo_cuda_all_gather, "CUDA")
        _GLOO_CUDA_GATHER.append(lib)


def _lm_mesh(shape, axes, device) -> "DeviceMesh":
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        _repair_gloo_cuda_all_gather()
    ranks = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model).
    A DeviceMesh over the first ranks of the default process group (every
    rank calls it); raises, naming the ranks it needs, where the group is
    smaller. The shapes are the JAX package's TPU pods; the spec functions
    read them without ranks through `sharding.MeshAxes`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _lm_mesh(shape, axes, device)


def make_host_mesh(shape=None, axes=("data", "model"), device=None):
    """Small mesh over the ranks of the default process group (tests,
    examples, one host): a DeviceMesh of ``shape`` (default (world, 1))
    named ``axes``, on CUDA unless ``device`` says the CPU. Every rank
    calls it."""
    if shape is None:
        shape = (dist.get_world_size(), 1)
    return _lm_mesh(shape, axes, device)
