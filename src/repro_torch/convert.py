"""Carry network state and connectivity, and LM weights, between the JAX
package and the port as plain numpy arrays.

In BCPNN the synaptic planes ARE the learned weights, so this is how a run
of one package continues in the other, and how the tests start both from
the same state. The array names are those that
`tests/fixtures/capture_head.py:state_arrays` writes (``hcus_<field>``
with ij planes (H*R, C) and i-vectors (H*R,), ``delay_rows``,
``delay_count``, ``t``, ``drops_in``, ``drops_fire``, and ``jring`` for a
merged state), plus ``base_key`` (two uint32 words) and ``drops_route``;
the connectivity arrays are
``conn_dest_hcu``, ``conn_dest_row`` and ``conn_delay``. A stacked state
of the recall server's session lanes (`network.stack_sessions`) travels
the same way with a leading (S,) lane dim on every array, as the JAX
package's stacked leaves have it.

LM parameters travel as the JAX package's parameter tree flattened to
numpy arrays keyed by `jax.tree_util.keystr` paths (``['embed']``,
``['stack'][0][1]['attn']['wq']``, ...), where each pattern position of a
stack segment holds its layers stacked along a leading repeats axis, and
the audio encoder's layers (``['encoder']['stack']...``) are stacked along
``n_enc_layers``; the port keeps one module per layer
(`repro_torch.models.transformer.Model`, state-dict names ``embed``,
``layers.<i>.attn.wq``, ``encoder.stack.<i>.attn.wq``, ...). Unstacked
leaves (``['shared_attn']...``, ``['vision_proj']``, ``['pos_embed']``,
``['encoder']['final_norm']``) map name for name. Each leaf keeps the
dtype the port's model gives it (float32 routers, SSM gates and cross
gates whatever ``param_dtype`` is). `lm_tree` builds the same tree
(nested dicts and lists) of tensors, so that a checkpoint of the port's
``(params, opt_state)`` has the JAX package's leaves in its order.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import network as N
from repro_torch.core import rng
from repro_torch.core.params import BCPNNParams
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import Model, build_stack_spec

_SCALARS = ("t", "drops_in", "drops_fire", "drops_route")


def state_from_numpy(arrays, p: BCPNNParams, device,
                     layout=None) -> N.NetworkState:
    """NetworkState from the JAX package's leaves as numpy arrays (a dict or
    an npz file), in flat order; its ij planes are stored in ``layout``
    (None: flat). ``drops_route`` defaults to 0 when absent, ``jring`` to
    None (a lazy state). The flat shapes are checked against ``p``. Arrays
    with a leading (S,) lane dim (``delay_rows`` of rank 4) give a stacked
    state of S session lanes, each lane converted as a state of its own."""
    if np.asarray(arrays["delay_rows"]).ndim == 4:
        arrays = {k: np.asarray(arrays[k]) for k in arrays}
        S = arrays["delay_rows"].shape[0]
        lanes = [state_from_numpy({k: a[i] for k, a in arrays.items()}, p,
                                  device, layout) for i in range(S)]
        return N.tree_map(lambda *xs: torch.stack(xs), *lanes)
    n = np.asarray(arrays["delay_rows"]).shape[0]
    shapes = {f: (n * p.rows, p.cols) for f in ("zij", "eij", "pij", "wij", "tij")}
    shapes.update({f: (n * p.rows,) for f in ("zi", "ei", "pi", "ti")})
    shapes.update({f: (n, p.cols) for f in ("zj", "ej", "pj", "h")})
    leaves = {}
    for f in H.HCUState._fields:
        a = np.asarray(arrays[f"hcus_{f}"])
        if a.shape != shapes[f]:
            raise ValueError(f"hcus_{f}: shape {a.shape}, expected {shapes[f]}")
        dt = torch.int32 if f in ("tij", "ti") else torch.float32
        leaves[f] = torch.tensor(a, dtype=dt, device=device)
    tens = lambda k, dt: torch.tensor(np.asarray(arrays[k]), dtype=dt,
                                      device=device)
    route = arrays["drops_route"] if "drops_route" in arrays else 0
    return N.NetworkState(
        jring=tens("jring", torch.int32) if "jring" in arrays else None,
        hcus=L.store_hcus(H.HCUState(**leaves), layout),
        delay_rows=tens("delay_rows", torch.int32),
        delay_count=tens("delay_count", torch.int32),
        t=tens("t", torch.int32), drops_in=tens("drops_in", torch.int32),
        drops_fire=tens("drops_fire", torch.int32),
        drops_route=torch.tensor(np.asarray(route), dtype=torch.int32,
                                 device=device),
        base_key=torch.tensor(np.asarray(arrays["base_key"]).astype(np.int64),
                              device=device),
    )


def state_to_numpy(state: N.NetworkState, layout=None) -> dict:
    """The inverse of `state_from_numpy`: every leaf as a numpy array under
    its JAX-side name, in flat order (planes stored in ``layout`` are
    unpacked), ``base_key`` as two uint32 words. A stacked state (``t`` of
    shape (S,)) gives arrays with the leading lane dim."""
    if state.t.dim() == 1:
        lanes = [state_to_numpy(N.take_session(state, i), layout)
                 for i in range(state.t.shape[0])]
        return {k: np.stack([a[k] for a in lanes]) for k in lanes[0]}
    hcus = L.load_hcus(state.hcus, layout)
    out = {f"hcus_{f}": getattr(hcus, f).cpu().numpy()
           for f in H.HCUState._fields}
    out["delay_rows"] = state.delay_rows.cpu().numpy()
    out["delay_count"] = state.delay_count.cpu().numpy()
    for k in _SCALARS:
        out[k] = getattr(state, k).cpu().numpy()
    out["base_key"] = rng.key_data(state.base_key)
    if state.jring is not None:
        out["jring"] = state.jring.cpu().numpy()
    return out


def conn_from_numpy(arrays, device) -> N.Connectivity:
    """Connectivity from ``conn_dest_hcu``, ``conn_dest_row``, ``conn_delay``."""
    t = lambda k: torch.tensor(np.asarray(arrays[k]), dtype=torch.int32,
                               device=device)
    return N.Connectivity(t("conn_dest_hcu"), t("conn_dest_row"),
                          t("conn_delay"))


def conn_to_numpy(conn: N.Connectivity) -> dict:
    return {"conn_dest_hcu": conn.dest_hcu.cpu().numpy(),
            "conn_dest_row": conn.dest_row.cpu().numpy(),
            "conn_delay": conn.delay.cpu().numpy()}


def _layer_slots(cfg: ArchConfig):
    """(segment, repeat, pattern position) of every layer, in stack order."""
    return [(si, r, pi) for si, (pattern, repeats) in
            enumerate(build_stack_spec(cfg)) for r in range(repeats)
            for pi in range(len(pattern))]


def _jax_path(name: str, slots):
    """The JAX keystr path of a port state-dict name, and the index to take
    from its stacked leaf (None for an unstacked leaf)."""
    parts = name.split(".")
    keys = lambda ps: "".join(f"['{p}']" for p in ps)
    if parts[0] == "layers":
        si, r, pi = slots[int(parts[1])]
        return f"['stack'][{si}][{pi}]" + keys(parts[2:]), r
    if parts[:2] == ["encoder", "stack"]:
        return "['encoder']['stack']" + keys(parts[3:]), int(parts[2])
    return keys(parts), None


def lm_params_from_numpy(flat, cfg: ArchConfig, device) -> dict:
    """The port's state dict (name -> tensor on ``device``) from the JAX
    package's flattened LM parameters (keystr path -> numpy array). Every
    leaf must be used and every shape must match."""
    slots = _layer_slots(cfg)
    out, used = {}, set()
    for name, t in Model(cfg, device="meta").state_dict().items():
        key, r = _jax_path(name, slots)
        if key not in flat:
            raise KeyError(f"JAX leaf {key} (for {name}) is missing")
        a = np.asarray(flat[key])
        a = a if r is None else a[r]
        if a.shape != tuple(t.shape):
            raise ValueError(f"{key}: shape {a.shape}, expected {tuple(t.shape)}")
        out[name] = torch.tensor(a, dtype=t.dtype, device=device)
        used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"JAX leaves the port has no place for: {extra}")
    return out


def lm_params_to_numpy(model: Model) -> dict:
    """The inverse of `lm_params_from_numpy`: the JAX package's flattened
    parameters, each pattern position's layers stacked along repeats."""
    slots = _layer_slots(model.cfg)
    stacks: dict[str, dict[int, np.ndarray]] = {}
    for name, t in model.state_dict().items():
        key, r = _jax_path(name, slots)
        stacks.setdefault(key, {})[r] = t.detach().cpu().numpy()
    return {key: by_r[None] if None in by_r else
            np.stack([by_r[r] for r in sorted(by_r)])
            for key, by_r in stacks.items()}


def lm_model_from_numpy(flat, cfg: ArchConfig, device) -> Model:
    """A `Model` on ``device`` holding the JAX package's parameters."""
    model = Model(cfg, device="meta")
    model.load_state_dict(lm_params_from_numpy(flat, cfg, device), assign=True)
    return model


_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _key_parts(key: str) -> tuple:
    """A keystr path's parts: dict keys (str) and list indices (int)."""
    return tuple(int(i) if i else k for k, i in _KEY_PART.findall(key))


def lm_leaf_groups(cfg: ArchConfig, names) -> list:
    """The JAX parameter tree's leaves in `jax.tree.flatten`'s order (dict
    keys sorted, lists in order): (keystr, stacked, the port's names that
    make the leaf, in repeat order) for the port's state-dict ``names``."""
    slots = _layer_slots(cfg)
    groups: dict[str, list] = {}
    for name in names:
        key, r = _jax_path(name, slots)
        groups.setdefault(key, []).append((-1 if r is None else r, name))
    return [(key, groups[key][0][0] >= 0, [n for _, n in sorted(groups[key])])
            for key in sorted(groups, key=_key_parts)]


def _stack_leaf(ts, stacked: bool):
    if not stacked:
        return ts[0]
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def lm_tree(tensors: dict, cfg: ArchConfig, leaf=_stack_leaf):
    """The JAX package's parameter tree of ``tensors`` (port name ->
    tensor: the parameters, or optimizer moments congruent with them):
    nested dicts and lists, each stacked leaf ``leaf(tensors, True)`` (by
    default `torch.stack` over repeats, a view where there is one),
    each other leaf ``leaf([tensor], False)``. A pattern position without
    parameters (zamba2's shared block) is None, as in the JAX tree."""
    tree: dict = {}
    for key, stacked, names in lm_leaf_groups(cfg, tensors):
        *path, last = _key_parts(key)          # a leaf is a dict entry
        node = tree
        for part, nxt in zip(path, path[1:] + [last]):
            node = _child(node, part, list if isinstance(nxt, int) else dict)
        node[last] = leaf([tensors[n] for n in names], stacked)
    return tree


def _child(node, part, make):
    """``node[part]`` (a dict key or a list index), made by ``make()``
    where it is missing; a list grows with None."""
    if isinstance(part, int):
        node.extend([None] * (part + 1 - len(node)))
        if node[part] is None:
            node[part] = make()
        return node[part]
    return node.setdefault(part, make())


def lm_tree_template(tensors: dict, cfg: ArchConfig) -> dict:
    """`lm_tree`'s structure with uninitialised host tensors of each
    leaf's shape and dtype: a restore template that costs no copy."""
    return lm_tree(tensors, cfg, lambda ts, stacked: torch.empty(
        ((len(ts),) if stacked else ()) + tuple(ts[0].shape),
        dtype=ts[0].dtype))


def lm_tree_leaves(tree, cfg: ArchConfig, names) -> dict:
    """The inverse of `lm_tree`: port name -> tensor (a view of its leaf,
    one repeat of a stacked leaf)."""
    out = {}
    for key, stacked, group in lm_leaf_groups(cfg, names):
        node = tree
        for part in _key_parts(key):
            node = node[part]
        for r, n in enumerate(group):
            out[n] = node[r] if stacked else node
    return out
