"""Meshes of the port's sharded BCPNN runtime (the BCPNN half of
`repro.launch.mesh`).

The JAX package shards whole HCUs over a 1-D ``jax.sharding.Mesh`` with
one axis, "hcu". The port runs one process per rank of a
`torch.distributed` process group, and the mesh is that group: an
`HcuMesh` names the group, this process's rank in it, the group's size
and the device the rank's tensors live on. Several ranks may share one
card (gloo; NCCL refuses two ranks on one GPU).

Nothing here touches a process group while the module is imported.
`make_production_mesh` and `make_host_mesh` build the LM substrate's
(data, model) meshes, which wait for ROADMAP queue A item 8c, and raise.
"""
from __future__ import annotations

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


def make_production_mesh(*, multi_pod: bool = False):
    """The LM substrate's (data, model) mesh: not ported yet (ROADMAP queue
    A item 8c)."""
    raise NotImplementedError("make_production_mesh: the LM sharding is not "
                              "ported to PyTorch yet (ROADMAP queue A item 8c)")


def make_host_mesh(shape=None, axes=("data", "model")):
    """The LM substrate's small test mesh: not ported yet (ROADMAP queue A
    item 8c)."""
    raise NotImplementedError("make_host_mesh: the LM sharding is not "
                              "ported to PyTorch yet (ROADMAP queue A item 8c)")
