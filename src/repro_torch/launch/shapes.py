"""Assigned input shapes and meta-device stand-ins for the dry-run (the
port of `repro.launch.shapes`).

Four cells per LM architecture (40 total):
  train_4k     seq 4096,   global batch 256   -> train_step
  prefill_32k  seq 32768,  global batch 32    -> serve prefill
  decode_32k   seq 32768,  global batch 128   -> serve decode (1 new token)
  long_500k    seq 524288, global batch 1     -> long-context decode;
               sub-quadratic archs only (xlstm, zamba2) — full-attention
               archs skip with a note.

Nothing is allocated here: every leaf is a tensor on the ``meta`` device
(the JAX package's ``jax.ShapeDtypeStruct``), in the JAX package's tree
structure, so that `launch.shardings`' spec functions read the same
trees on both sides.
"""
from __future__ import annotations

import torch

from repro_torch.launch.shardings import shape_tree
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import KVCache
from repro_torch.models.transformer import (Model, build_stack_spec,
                                            init_cache_for_kind)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1, long=True),
}

# sub-quadratic archs that run the long_500k cell
LONG_OK = {"xlstm-125m", "zamba2-7b"}


def applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_OK
    return True


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _modality_specs(cfg: ArchConfig, batch: int):
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((batch, cfg.n_patches, cfg.vision_dim),
                                    torch.float32)
    if cfg.enc_dec:
        out["frames"] = _meta((batch, cfg.n_enc_frames, cfg.vision_dim),
                              torch.float32)
    return out


def cache_tree(cfg: ArchConfig, batch: int, max_len: int) -> list:
    """The JAX package's decode-cache tree as meta tensors: one list per
    stack segment, one entry per pattern position, each cache's leaves
    stacked along the segment's repeats (a `KVCache`'s length too, int32)."""
    def stacked(c, n):
        if isinstance(c, KVCache):
            return KVCache(stacked(c.k, n), stacked(c.v, n),
                           _meta((n,), torch.int32))
        if isinstance(c, tuple):
            return tuple(stacked(t, n) for t in c)
        return _meta((n,) + tuple(c.shape), c.dtype)
    return [[stacked(init_cache_for_kind(cfg, kind, batch, max_len, "meta"),
                     repeats) for kind in pattern]
            for pattern, repeats in build_stack_spec(cfg)]


def input_specs(cfg: ArchConfig, shape_name: str):
    """Meta-tensor trees for one (arch x shape) cell: what the
    corresponding step function consumes.
      train  : {batch}
      prefill: {batch, caches}
      decode : {token, pos, caches[, memory, mem_pos]}
    """
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] == "train":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        batch.update(_modality_specs(cfg, B))
        return {"batch": batch}
    if sh["kind"] == "prefill":
        batch = {"tokens": _meta((B, S), torch.int32)}
        batch.update(_modality_specs(cfg, B))
        return {"batch": batch, "caches": cache_tree(cfg, B, S)}
    # decode: one new token against a seq_len-deep cache
    out = {"token": _meta((B, 1), torch.int32),
           "pos": _meta((), torch.int32),
           "caches": cache_tree(cfg, B, S)}
    if cfg.family == "vlm":
        out["memory"] = _meta((B, cfg.n_patches, cfg.d_model), cfg.cdtype)
        out["mem_pos"] = _meta((cfg.n_patches,), torch.int32)
    if cfg.enc_dec:
        out["memory"] = _meta((B, cfg.n_enc_frames, cfg.d_model), cfg.cdtype)
        out["mem_pos"] = _meta((cfg.n_enc_frames,), torch.int32)
    return out


def params_specs_abstract(cfg: ArchConfig):
    """Abstract parameter shapes (no allocation): the JAX package's
    parameter tree of a model built on the meta device."""
    model = Model(cfg, device="meta")
    return shape_tree(dict(model.named_parameters()), cfg)
