"""Logical sharding hints, decoupled from any concrete mesh (the port of
`repro.models.sharding`).

Models annotate activations with LOGICAL axes ("batch", "seq", "model_d",
"heads", "vocab", "expert"); the launch layer maps logical axes onto mesh
axes ("pod", "data", "model") and activates the mapping with `use_rules`.
Outside a mesh context hints are the identity, so the same model code
runs anywhere.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimension
names are the mesh axes, or, for the spec functions alone, any object
with ``axis_names`` and ``shape`` (a mapping of axis sizes), as the JAX
tests' ``FakeMesh``: `mesh_axes` reads either. Under a DeviceMesh the
sharded tensors are DTensors, and `hint` redistributes one to the
placements of its spec (`placements`). A PartitionSpec is `P`: a tuple
whose entries are None, one axis name, or a tuple of axis names.

The JAX package's ``REPRO_HINT_NO_DIVCHECK`` environment switch (a
performance ablation) is not carried: the port selects nothing through
the environment.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

_state = threading.local()


# logical axis -> mesh axes mapping used by the production launchers
DEFAULT_RULES = {
    "batch": ("pod", "data"),     # DP: batch over pod x data
    "seq": None,                  # sequence kept local by default
    "seq_shard": ("data",),       # long-context: sequence over data
    "seq_mp": ("model",),         # SP fallback: sequence over model when the
                                  # head count doesn't divide the TP degree
    "heads": ("model",),          # TP: attention heads
    "model_d": ("model",),        # TP: hidden/ffn dim
    "vocab": ("model",),          # TP: embedding/vocab
    "expert": ("model",),         # EP: experts over model axis
    "layers": None,
}


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, each None, a mesh axis
    name, or a tuple of mesh axis names. ``P()`` replicates; missing
    trailing entries are None. Equality is the tuple's, entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class MeshAxes(NamedTuple):
    """What the spec functions read of a mesh: its axis names, in mesh
    order, and their sizes."""
    axis_names: tuple
    shape: dict


def mesh_axes(mesh) -> MeshAxes:
    """The `MeshAxes` of a DeviceMesh (its dimension names and sizes) or of
    anything with ``axis_names`` and ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshAxes(tuple(names), dict(zip(names, mesh.shape)))
    return MeshAxes(tuple(mesh.axis_names), dict(mesh.shape))


def _ctx():
    return getattr(_state, "ctx", None)


def active_mesh():
    """The DeviceMesh of the active `use_rules`, or None (no context, or a
    context over a mesh that is only axis names and sizes)."""
    ctx = _ctx()
    if ctx is None or not hasattr(ctx[2], "mesh_dim_names"):
        return None
    return ctx[2]


def mapped_size(logical_ax) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 if inactive)."""
    ctx = _ctx()
    if ctx is None:
        return 1
    rules, axes = ctx[0], ctx[1]
    m = rules.get(logical_ax)
    if not m:
        return 1
    n = 1
    for a in m:
        if a in axes.axis_names:
            n *= axes.shape.get(a, 1)
    return n


@contextlib.contextmanager
def use_rules(rules, mesh):
    """Activate a logical->mesh mapping (launchers only)."""
    prev = _ctx()
    axes = mesh_axes(mesh) if mesh is not None else MeshAxes((), {})
    _state.ctx = (rules, axes, mesh)
    try:
        yield
    finally:
        _state.ctx = prev


def spec(*logical_axes, shape=None) -> P:
    """Resolve logical axes to a `P` under the active rules.

    With `shape`, axes that do not evenly divide the corresponding dim are
    dropped (a 2-kv-head tensor is never forced onto a 16-way axis)."""
    ctx = _ctx()
    if ctx is None:
        return P()
    rules, axes = ctx[0], ctx[1]
    out = []
    for i, ax in enumerate(logical_axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        m = tuple(a for a in m if a in axes.axis_names)
        if shape is not None and m:
            n = 1
            for a in m:
                n *= axes.shape.get(a, 1)
            if n == 0 or shape[i] % n != 0:
                m = ()
        out.append(m if len(m) > 1 else (m[0] if m else None))
    return P(*out)


def placements(s: P, mesh) -> tuple:
    """The DTensor placements of spec ``s`` on ``mesh`` (a DeviceMesh): one
    per mesh dim, `Shard(d)` where tensor dim d maps to that mesh axis,
    else `Replicate()`. A dim over several axes (("pod", "data")) is
    `Shard(d)` on each of them, in mesh-dim order: the JAX layout. An
    axis of size 1 holds the whole dim either way and is `Replicate()`:
    torch 2.11's sharding rules mishandle shards over one rank (a bias
    add asked for a Shard -> Partial redistribution on a (1, 4) mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(s):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(a)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def mesh_device(mesh) -> torch.device:
    """The device of a DeviceMesh's tensors on this rank."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_tensor(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """A DTensor of ``place`` on ``mesh`` from ``full``, the same whole
    tensor on every rank (on any device): each rank keeps its own shard,
    moved to the mesh's device (no collective)."""
    from torch.distributed.tensor import DTensor, Shard
    local = full
    coord = mesh.get_coordinate()
    for i, pl in enumerate(place):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    local = local.to(mesh_device(mesh)).contiguous()
    return DTensor.from_local(
        local, mesh, place, run_check=False, shape=full.shape,
        stride=torch.empty(full.shape, device="meta").stride())


def hint(x, *logical_axes, shape=None):
    """Lay ``x`` out as its spec says, if a DeviceMesh is active; identity
    otherwise. ``shape`` (default ``x.shape``) is the shape the spec's
    divisibility is checked against: the shape ``x`` is about to be viewed
    as, where a split dim must be laid out before the view. Under a mesh
    ``x`` must be a DTensor: a plain tensor there means a sharded path left
    DTensor, and that raises."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("hint under a mesh needs a DTensor, got "
                        f"{type(x).__name__} of shape {tuple(x.shape)}")
    want = placements(spec(*logical_axes,
                           shape=x.shape if shape is None else shape), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def is_sharded(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor sharded along tensor dim ``dim``."""
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == dim
               for p in getattr(x, "placements", ()))


# ------------------------- DTensor regions -----------------------------------
#
# DTensor propagates every dense op of the model. Three kinds of op need
# more: plain tensors made inside a block (positions, masks), ops with no
# DTensor rule (MoE's sorted dispatch, the SSM scans, the sLSTM loop), and
# ops whose rule would gather a vocab-sharded tensor (the embedding gather,
# the cross entropy's log-sum-exp). The helpers below cover them.


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication of plain tensors, restored to its
    previous value on exit (the library's context resets it to off)."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def bind(fn):
    """``fn`` bound to the active rules and mesh, if a DeviceMesh is active
    (else ``fn`` itself): it runs under them, with plain tensors taken as
    replicated, in whatever thread calls it. A remat recompute runs in
    autograd's thread, where neither context is set. Plain tensors may
    meet DTensors only in ops whose backward does not keep them: whatever
    a backward keeps is a DTensor (`replicate`)."""
    ctx = _ctx()
    if active_mesh() is None:
        return fn

    def bound(*args, **kw):
        prev = _ctx()
        _state.ctx = ctx
        try:
            with _implicit_replication():
                return fn(*args, **kw)
        finally:
            _state.ctx = prev
    return bound


def replicate(t):
    """A plain tensor made inside the model (positions, a mask), as a
    DTensor replicated over the active mesh; unchanged without one, and a
    DTensor unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = active_mesh()
    if mesh is None or t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


class _SumOverRanks(torch.autograd.Function):
    """Sum a local tensor over a process group; the gradient passes through
    (it reaches the replicated result identically on every rank)."""

    @staticmethod
    def forward(ctx, t, groups):
        out = t.float()
        for g in groups:
            out = out.clone()
            dist.all_reduce(out, group=g)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(t, groups):
    """``t`` summed over the ranks of each process group in ``groups`` (in
    float32, returned in ``t``'s dtype); its gradient passes through
    unchanged, as the result is replicated over those ranks."""
    return _SumOverRanks.apply(t, list(groups))


def _tp_dims(t, dim: int) -> list:
    """The mesh dims along which DTensor ``t`` shards tensor dim ``dim``,
    in mesh order."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def shard_offset(mesh, dims, local_size: int) -> int:
    """Where this rank's shard starts along a dim sharded over mesh dims
    ``dims`` (nested in mesh order, even chunks of ``local_size``)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx * local_size


def _layout_except(t, dims, keep):
    """``t``'s placements with mesh dims ``dims`` replicated and, of the
    others, only what ``keep(placement)`` accepts."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if i in dims or not keep(p) else p
                 for i, p in enumerate(t.placements))


def vocab_gather(table, tokens, dtype):
    """``table[tokens]`` in ``dtype`` for a DTensor ``table`` (V, D) and
    DTensor ``tokens``, on each rank's local tensors (DTensor's own rule
    for the gather's backward fails in some torch releases). Where the
    table is vocab-sharded, each rank gathers the rows it holds, zeros the
    others, and the ranks sum (exact: one nonzero term a row), instead of
    gathering the table. Returns rows (B, S, D) laid out as the tokens,
    replicated over the vocab's axes."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = table.device_mesh
    tp = [i for i in _tp_dims(table, 0) if mesh.size(i) > 1]
    table = table.redistribute(mesh, _layout_except(table, (), lambda p: (
        isinstance(p, Shard) and p.dim == 0)))
    tok_pl = _layout_except(tokens, tp, lambda p: isinstance(p, Shard))
    tokens = tokens.redistribute(mesh, tok_pl)
    grad_pl = tuple(Partial() if isinstance(p, Shard) else q
                    for p, q in zip(tok_pl, table.placements))
    local = table.to_local(grad_placements=grad_pl)
    tok = tokens.to_local()
    if not tp:
        rows = local.to(dtype)[tok]
    else:
        off = shard_offset(mesh, tp, local.shape[0])
        inr = (tok >= off) & (tok < off + local.shape[0])
        rows = local.to(dtype)[torch.where(inr, tok - off, 0)]
        rows = torch.where(inr[..., None], rows,
                           torch.zeros((), dtype=dtype, device=rows.device))
        rows = sum_over_ranks(rows, [mesh.get_group(i) for i in tp])
    return DTensor.from_local(rows, mesh, tok_pl, run_check=False)


def local_region(fn, params, x, *args, **kw):
    """``fn(params, x, *args, **kw)`` on plain local tensors under the
    active mesh, for ops DTensor has no rule for and that treat each batch
    row alone. ``x`` (B, ...) keeps its batch sharding and is gathered
    along its other dims; each parameter in ``params`` (a mapping, nested)
    is gathered whole, and its gradient is summed over the ranks that split
    the batch. ``fn`` runs with no rules active; each tensor it returns
    (batch-major) comes back as a DTensor laid out as ``x``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = active_mesh()
    xp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in x.placements)
    x = x.redistribute(mesh, xp)
    gp = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    rep = (Replicate(),) * mesh.ndim

    def gather(p):
        if hasattr(p, "keys"):
            return {k: gather(p[k]) for k in p.keys()}
        return p.redistribute(mesh, rep).to_local(grad_placements=gp)

    local_params = gather(params)
    prev = _ctx()
    _state.ctx = None
    try:
        out = fn(local_params, x.to_local(), *args, **kw)
    finally:
        _state.ctx = prev

    def wrap(t):
        if isinstance(t, tuple):
            return tuple(wrap(v) for v in t)
        if torch.is_tensor(t):
            return DTensor.from_local(t, mesh, xp, run_check=False)
        return t
    return wrap(out)


def local_attention(fn, q, k, v, mask, *args):
    """``fn(q, k, v, mask, *args)`` (an attention core: q (B, Sq, Kv, G,
    hd), k / v (B, Skv, Kv, hd), mask (B|1, Sq, Skv)) on each rank's block
    where q is a DTensor: attention splits over batch, heads and query
    rows without communication, and DTensor's own rules would merge the
    sharded batch and head dims into one. Along each mesh dim k, v and
    the mask follow q: its batch shard, its head shard, or (q sharded
    over the sequence) whole keys with the mask's rows; k and v's
    gradients are then summed over those ranks. Plain tensors pass
    straight to ``fn``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, k, v, mask, *args)
    mesh = q.device_mesh
    kv_pl, kv_grad, mask_pl = [], [], []
    for p in q.placements:
        d = p.dim if isinstance(p, Shard) else None
        if isinstance(p, Replicate):
            kv, grad, mk = Replicate(), Replicate(), Replicate()
        elif d == 0:
            kv, grad = Shard(0), Shard(0)
            mk = Shard(0) if mask.shape[0] > 1 else Replicate()
        elif d == 2:
            kv, grad, mk = Shard(2), Shard(2), Replicate()
        elif d == 1:
            kv, grad, mk = Replicate(), Partial(), Shard(1)
        else:
            raise ValueError(f"attention over q laid out as {q.placements}")
        kv_pl.append(kv)
        kv_grad.append(grad)
        mask_pl.append(mk)
    kv_pl, kv_grad, mask_pl = tuple(kv_pl), tuple(kv_grad), tuple(mask_pl)
    local = lambda t: t.redistribute(mesh, kv_pl).to_local(
        grad_placements=kv_grad)
    out = fn(q.to_local(), local(k), local(v),
             replicate(mask).redistribute(mesh, mask_pl).to_local(), *args)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
