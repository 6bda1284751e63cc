"""Multi-pod dry run of the port (the port of `repro.launch.dryrun`): build
every (architecture x input shape x mesh) cell on the meta device and
report one rank's memory, operations and collectives for the roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --bcpnn

Each cell writes <out>/<arch>__<shape>__<mesh>.json. Where the JAX package
lowers and compiles the step with XLA on 512 forced host devices, the port
builds it on the meta device: nothing is allocated and no kernel runs.

  * The mesh is (16, 16) or (2, 16, 16) over a process group of 512 fake
    ranks (`torch.testing._internal.distributed.fake_pg`; backend "fake"),
    made by `main` (`fake_world`) and torn down after it. This process is
    rank 0.
  * Parameters, optimizer state, batch and caches are meta tensors of the
    JAX package's trees (`launch.shapes`), laid out by `launch.shardings`,
    whose specs are the JAX package's entry for entry.
    ``memory.argument_bytes`` is the sum of rank 0's shard bytes of them:
    what XLA's ``argument_size_in_bytes`` counts for the same cell.
  * ``cost`` comes from one run of the port's own step on those tensors,
    as DTensors on the mesh: the train step (forward and backward, remat
    recomputing each block, AdamW), `Model.prefill` or `Model.decode_step`.
    ``flops`` are `torch.utils.flop_counter`'s (matmuls and attention;
    elementwise work and reductions are not counted) over the local
    operations rank 0 runs; ``bytes accessed`` the bytes each of those
    operations reads and writes (views none), as the port's unfused ops
    move them. The port runs every layer, so ``scan_factor`` is 1.0 and
    no scan correction applies.
  * ``collectives`` are those the step issues on rank 0 (DTensor's
    functional collectives and the port's own `torch.distributed` calls),
    by kind, with the bytes of the shards they carry (an all-reduce 2x its
    input, as the JAX package counts it), and by where they run: within
    a node of `roofline.NODE_RANKS` cards (NVLink) or across nodes (NIC).
  * ``memory.temp_bytes``: the peak of what the step allocates beyond its
    arguments, by `torch.distributed._tools.mem_tracker.MemTracker` where
    it can track the meta tensors; else the record says why not.

`lower_bcpnn` counts the BCPNN tick's shard: one rank's bytes of state,
connectivity and input under `core.distributed._shard_specs`, and the
exchange the port ships each tick (one ``all_to_all_single`` of (ranks,
cap_route) int32 words under `default_route_config`).

The JAX module's ``XLA_FLAGS`` line (forced host devices) does not carry
over: the fake group stands for the devices.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, applicable, input_specs,
                                       params_specs_abstract)
from repro_torch.models.layers import KVCache
from repro_torch.models.sharding import (DEFAULT_RULES, P, mesh_axes,
                                         placements, shard_tensor, use_rules)
from repro_torch.models.transformer import Model, layer_kinds
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.train_step import make_train_step

SELF_ATTN_KINDS = ("attn", "attn_local", "attn_moe", "shared_attn",
                   "dec_cross")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast")
FLOPS_COUNTED = ("matmuls and attention (torch.utils.flop_counter's "
                 "registry) of the local operations of one rank; "
                 "elementwise work and reductions not counted")
BYTES_COUNTED = ("each local operation's tensor inputs read and outputs "
                 "written once, views none (unfused)")


@contextlib.contextmanager
def fake_world(world: int = 512):
    """A default process group of ``world`` fake ranks, this process rank
    0, torn down on exit. Raises where a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group; one "
                           "is initialized already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------ counting -------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(arg):
    """The global ranks of a collective's group: a group name (functional
    collectives) or a ProcessGroup object (`torch.distributed` calls)."""
    try:
        if isinstance(arg, str):
            pg = torch._C._distributed_c10d._resolve_process_group(arg)
        else:
            pg = dist.ProcessGroup.unbox(arg)
        return dist.get_process_group_ranks(pg)
    except Exception:            # an unknown group: priced across nodes
        return None


_FUNCTIONAL = {"all_gather_into_tensor": ("all-gather", 1, "out"),
               "all_reduce": ("all-reduce", 2, "in"),
               "reduce_scatter_tensor": ("reduce-scatter", 1, "out"),
               "all_to_all_single": ("all-to-all", 1, "out"),
               "broadcast": ("broadcast", 1, "in")}
_C10D = {"allreduce_": ("all-reduce", 2), "allgather_": ("all-gather", 1),
         "_allgather_base_": ("all-gather", 1),
         "reduce_scatter_": ("reduce-scatter", 1),
         "_reduce_scatter_base_": ("reduce-scatter", 1),
         "alltoall_base_": ("all-to-all", 1), "alltoall_": ("all-to-all", 1),
         "broadcast_": ("broadcast", 1)}


class StepCounter(TorchDispatchMode):
    """Counts the local operations one rank runs: flops (the flop
    counter's registry), bytes read and written, and collectives by kind,
    bytes and where they run. DTensor operations are left to DTensor (the
    mode sees the local operations they issue), and DTensor's own shape
    propagation (fake tensors of the global shapes) is not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.where = {"nvlink": 0.0, "nic": 0.0}

    def _collective(self, kind, nbytes, group):
        ranks = _group_ranks(group)
        within = ranks is not None and \
            len({r // RL.NODE_RANKS for r in ranks}) == 1
        self.coll[kind] += nbytes
        self.counts[kind] += 1
        self.where["nvlink" if within else "nic"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                    # DTensor's shape propagation
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, mult, side = _FUNCTIONAL[name]
            t = out if side == "out" else args[0]
            self._collective(kind, mult * _nbytes(t), args[-1])
            return out
        if ns == "c10d" and name in _C10D:
            kind, mult = _C10D[name]
            tensors = [a for a in tree_flatten(args[0])[0]
                       if torch.is_tensor(a)]
            group = next((a for a in args[1:] if isinstance(
                a, torch.ScriptObject)), None)
            self._collective(kind, mult * sum(map(_nbytes, tensors)), group)
            return out
        f = self._registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        rets = func._schema.returns
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets):
            return out                    # a view moves nothing
        ins = [a for a in tree_flatten((args, kwargs))[0] if torch.is_tensor(a)]
        outs = [o for o in tree_flatten(out)[0] if torch.is_tensor(o)]
        if outs:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out

    def collectives(self) -> dict:
        out = dict(self.coll)
        out["total"] = sum(self.coll.values())
        out["counts"] = dict(self.counts)
        out.update(self.where)
        return out


def _local_bytes(tree, specs, mesh) -> int:
    """Rank 0's shard bytes of ``tree`` (meta tensors in the JAX package's
    structure) laid out by the congruent spec tree ``specs``: each leaf's
    bytes over the sizes of the mesh axes its spec cuts it along."""
    sizes = mesh_axes(mesh).shape
    total = [0]

    def one(_, leaf, spec):
        n = _nbytes(leaf)
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                n //= sizes[a]
        total[0] += n
    SH.tree_map_with_path(one, tree, specs)
    return total[0]


def _meta_like(params, place):
    """float32 zero moments as meta DTensors laid out as ``place`` (name
    -> placements): what `AdamW.init` makes, with nothing allocated."""
    return {n: shard_tensor(torch.empty(p.shape, dtype=torch.float32,
                                        device="meta"), p.device_mesh,
                            place[n]) for n, p in params.items()}


def _temp_bytes(run, grad: bool) -> dict:
    """``run()`` again under `MemTracker` (autograd on where ``grad``):
    {"temp_bytes": the peak of what it allocates} where MemTracker tracks
    the meta tensors, else {"temp_bytes_error": why not}. The port's
    operations run unfused, each temporary its own tensor."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        with mt, torch.set_grad_enabled(grad):
            run()
        peak = mt.get_tracker_snapshot("peak")
        total = sum(v.get("Total", 0) for v in peak.values())
        if not total:
            return {"temp_bytes_error": "MemTracker tracked no bytes of the "
                                        "meta tensors"}
        return {"temp_bytes": int(total)}
    except Exception as e:
        return {"temp_bytes_error": f"MemTracker: {type(e).__name__}: {e}"}


# ------------------------------- the cells -----------------------------------

def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
               mesh=None, mesh_name: str | None = None,
               batch: int | None = None, seq: int | None = None,
               measure_temp: bool = True):
    """Build and run one cell on the meta device; returns its record.
    The JAX package's defaults hold: ZeRO moments over "data", a long
    decode's sequence sharded, no FSDP. ``mesh`` (default: the production
    mesh, which needs the fake group of `fake_world`) and ``batch`` /
    ``seq`` (default: the shape's) let a caller size a cell of its own;
    ``measure_temp=False`` skips the second run under MemTracker."""
    cfg = get_config(arch_id)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size()
    sh = dict(SHAPES[shape_name])
    sh["batch"] = batch or sh["batch"]
    sh["seq"] = seq or sh["seq"]
    specs_in = input_specs(cfg, shape_name, sh["batch"], sh["seq"])
    p_abs = params_specs_abstract(cfg)
    p_specs = SH.param_specs(p_abs, cfg, mesh)
    by_input = {"params": _local_bytes(p_abs, p_specs, mesh)}
    B, S = sh["batch"], sh["seq"]
    model = Model(cfg, device="meta")
    counter = StepCounter()
    t0 = time.time()
    with use_rules(DEFAULT_RULES, mesh):
        SH.shard_params(model, cfg, mesh)
        params = dict(model.named_parameters())
        if sh["kind"] == "train":
            o_abs = AdamWState(torch.empty((), dtype=torch.int32,
                                           device="meta"), p_abs, p_abs)
            o_specs = SH.opt_specs(p_specs, zero=True, mesh=mesh,
                                   params=p_abs)
            b_specs = SH.batch_specs(specs_in["batch"], mesh)
            by_input["opt_state"] = _local_bytes(o_abs, o_specs, mesh)
            by_input["batch"] = _local_bytes(specs_in["batch"], b_specs,
                                             mesh)
            place = {n: placements(s, mesh) for n, s in
                     SH.layer_specs(o_specs.mu, cfg, params).items()}
            opt_state = AdamWState(
                torch.zeros((), dtype=torch.int32, device="meta"),
                _meta_like(params, place), _meta_like(params, place))
            batch_in = SH.shard_batch(specs_in["batch"], mesh)
            step = make_train_step(model, AdamW())
            run = lambda: step(params, opt_state, batch_in)
            mfl = RL.model_flops(cfg, shape_name, B * S, train=True)
        elif sh["kind"] == "prefill":
            c_specs = SH.cache_specs(specs_in["caches"], cfg, mesh)
            b_specs = SH.batch_specs(specs_in["batch"], mesh)
            by_input["batch"] = _local_bytes(specs_in["batch"], b_specs,
                                             mesh)
            by_input["caches"] = _local_bytes(specs_in["caches"], c_specs,
                                              mesh)
            batch_in = SH.shard_batch(specs_in["batch"], mesh)
            caches = SH.shard_caches(model.init_cache(B, S), cfg, mesh)
            run = lambda: model.prefill(batch_in, caches)
            mfl = RL.model_flops(cfg, shape_name, B * S, train=False)
        else:  # decode
            seq_shard = sh.get("long", False)
            c_specs = SH.cache_specs(specs_in["caches"], cfg, mesh,
                                     seq_shard=seq_shard)
            by_input["caches"] = _local_bytes(specs_in["caches"], c_specs,
                                              mesh)
            # pos counts where a layer reads positions, as XLA drops an
            # argument the step never reads (xlstm's decode reads none)
            reads_pos = cfg.enc_dec or any(
                k in SELF_ATTN_KINDS for k in layer_kinds(cfg))
            rep = {k: P() for k in ("token", "pos", "mem_pos")
                   if k in specs_in and (k != "pos" or reads_pos)}
            by_input["token_pos"] = _local_bytes(
                {k: specs_in[k] for k in rep}, rep, mesh)
            memory = None
            if "memory" in specs_in:
                m_specs = SH.batch_specs({"m": specs_in["memory"]}, mesh)
                by_input["memory"] = _local_bytes(
                    {"m": specs_in["memory"]}, m_specs, mesh)
                memory = SH.shard_batch({"m": specs_in["memory"]}, mesh)["m"]
            # one new token at the last slot of a full cache
            caches = [KVCache(c.k, c.v, S - 1) if isinstance(c, KVCache)
                      else c for c in model.init_cache(B, S)]
            caches = SH.shard_caches(caches, cfg, mesh, seq_shard=seq_shard)
            token = SH.shard_batch({"t": specs_in["token"]}, mesh)["t"]
            mem_pos = specs_in.get("mem_pos")
            run = lambda: model.decode_step(
                token, S - 1, caches, memory,
                None if mem_pos is None else torch.arange(
                    mem_pos.shape[0], device="meta"))
            mfl = RL.model_flops(cfg, shape_name, B, train=False)
        with counter, torch.no_grad() if sh["kind"] != "train" else \
                contextlib.nullcontext():
            run()
        temp = _temp_bytes(run, sh["kind"] == "train") if measure_temp \
            else {"temp_bytes_error": "not measured (measure_temp=False)"}
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "batch": B, "seq": S,
        "compile_s": round(time.time() - t0, 1),
        "memory": {"argument_bytes": sum(by_input.values()),
                   "argument_bytes_by_input": by_input, **temp},
        "collectives": counter.collectives(),
        "scan_factor": 1.0,
        "model_flops": mfl,
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes),
                 "counts": {"flops": FLOPS_COUNTED, "bytes": BYTES_COUNTED}},
    }
    rec["roofline"] = _roofline_terms(RL.analyze(rec))
    return rec


def _roofline_terms(r: RL.Roofline) -> dict:
    return {"t_compute_s": r.t_compute, "t_memory_s": r.t_memory,
            "t_collective_s": r.t_collective, "t_step_s": r.t_step,
            "bottleneck": r.bottleneck, "peak": r.peak}


def lower_bcpnn(scale: str = "rodent", *, multi_pod: bool,
                n_hcu: int | None = None, ranks: int | None = None):
    """One rank's shard of the BCPNN tick on the production mesh (256 or
    512 ranks, or ``ranks``) at the config's DRYRUN_N_HCU (or ``n_hcu``):
    the bytes of its state, connectivity and input (by leaf), and the
    exchange the port ships a tick (the JAX package's defaults: the
    Poisson-dimensioned `default_route_config`, one packed word a spike).
    Returns the record."""
    from repro_torch.core import distributed as DD
    from repro_torch.core import network as N
    from repro_torch.core import rng

    mod = importlib.import_module(f"repro_torch.configs.bcpnn_{scale}")
    p = mod.CONFIG
    n_hcu = n_hcu or mod.DRYRUN_N_HCU
    ndev = ranks or (512 if multi_pod else 256)
    mesh_name = (("pod2x256" if multi_pod else "pod256") if ranks is None
                 else f"ranks{ranks}") + f"-{scale}"
    h_local = n_hcu // ndev
    rc = DD.default_route_config(p, h_local, n_dev=ndev)
    t0 = time.time()
    key = rng.PRNGKey(0, "meta")
    st = N.init_network(p, key, n_hcu=n_hcu)
    cn = N.make_connectivity(p, rng.PRNGKey(1, "meta"), n_hcu=n_hcu)
    ext = torch.empty((n_hcu, 8), dtype=torch.int32, device="meta")
    s_specs, c_specs = DD._shard_specs()
    by_leaf = {}

    def count(prefix, tree, specs):
        for (name, leaf), (_, spec) in zip(named_leaves(tree, prefix),
                                           DD._spec_pairs(tree, specs)):
            by_leaf[name] = _nbytes(leaf) // (ndev if spec == DD.SHARD
                                              else 1)
    count("state.", st, s_specs)
    count("conn.", cn, c_specs)
    by_leaf["ext"] = _nbytes(ext) // ndev
    words = ndev * rc.cap_route
    span = "nvlink" if ndev <= RL.NODE_RANKS else "nic"
    coll = {k: 0.0 for k in COLLECTIVE_KINDS}
    coll["all-to-all"] = float(words * 4)
    coll["total"] = coll["all-to-all"]
    coll["counts"] = dict.fromkeys(COLLECTIVE_KINDS, 0)
    coll["counts"]["all-to-all"] = 1
    coll["nvlink"], coll["nic"] = 0.0, 0.0
    coll[span] = coll["all-to-all"]
    # synaptic traffic per tick (lazy model): rows touched * row bytes * 2
    cells = (p.in_rate * p.cols + p.out_rate * p.rows) * n_hcu
    lazy_bytes = cells * 20 * 2
    rec = {
        "arch": f"bcpnn-{scale}", "shape": "tick_1ms", "mesh": mesh_name,
        "chips": ndev, "n_hcu": n_hcu, "h_local": h_local,
        "route": {"cap_fire": rc.cap_fire, "cap_route": rc.cap_route},
        "compile_s": round(time.time() - t0, 1),
        "memory": {"argument_bytes": sum(by_leaf.values()),
                   "argument_bytes_by_leaf": by_leaf},
        "collectives": coll,
        "model_flops": cells * 60.0,            # FLOPS_PER_CELL
        "lazy_bytes_per_tick": lazy_bytes,
        "cost": {"flops": cells * 60.0 / ndev,
                 "bytes accessed": lazy_bytes / ndev,
                 "counts": {"flops": "analytic: the lazy tick's touched "
                                     "cells, 60 flops a cell",
                            "bytes": "analytic: 20 bytes a touched cell "
                                     "read and 20 written"}},
    }
    rec["roofline"] = _roofline_terms(RL.analyze(rec))
    return rec


def named_leaves(tree, prefix=""):
    """(dotted field name, leaf) of a NamedTuple tree's non-None leaves,
    in `distributed._spec_pairs`' order: the names of ``lower_bcpnn``'s
    ``argument_bytes_by_leaf`` with ``prefix`` "state." or "conn."."""
    for name, v in zip(tree._fields, tree):
        if isinstance(v, tuple):
            yield from named_leaves(v, f"{prefix}{name}.")
        elif v is not None:
            yield f"{prefix}{name}", v


# ------------------------------- the driver ----------------------------------

def _write(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch_id, shape_name, multi_pod, out_dir, skip_existing=True):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch_id}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip] {tag}")
        return None
    if not applicable(arch_id, shape_name):
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "skipped": "full-attention arch: long_500k inapplicable"}
        _write(path, rec)
        print(f"[n/a ] {tag}")
        return rec
    print(f"[build] {tag} ...", flush=True)
    try:
        rec = lower_cell(arch_id, shape_name, multi_pod=multi_pod)
        _write(path, rec)
        print(f"[ok  ] {tag} {rec['compile_s']}s "
              f"flops/rank={rec['cost']['flops']:.3e} "
              f"coll={rec['collectives']['total']:.3e}B", flush=True)
        return rec
    except Exception as e:
        traceback.print_exc()
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}"}
        _write(path, rec)
        print(f"[FAIL] {tag}: {e}", flush=True)
        return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--bcpnn", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-skip", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.bcpnn:
        for scale in ("rodent", "human"):
            for mp in (False, True):
                tag = f"bcpnn-{scale}__tick__{'pod2x256' if mp else 'pod256'}"
                path = os.path.join(args.out, tag + ".json")
                if not args.no_skip and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                try:
                    rec = lower_bcpnn(scale, multi_pod=mp)
                    _write(path, rec)
                    print(f"[ok  ] {tag}", flush=True)
                except Exception as e:
                    traceback.print_exc()
                    _write(path, {"error": str(e)})
        return

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = []
    if not args.multi_pod:
        pods.append(False)
    if not args.single_pod:
        pods.append(True)
    with fake_world(512):
        for mp in pods:
            for a in archs:
                for s in shapes:
                    run_cell(a, s, mp, args.out,
                             skip_existing=not args.no_skip)


if __name__ == "__main__":
    main()
