"""Serving steps (the port of `repro.train.serve_step`): batched prefill
and incremental decode with sampling."""
from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.models.sharding import bind
from repro_torch.models.transformer import Model


def sample(logits, key, temperature: float = 0.0):
    """logits (B, 1, V) -> (B, 1) int32 token ids. temperature == 0 is
    greedy (the first maximum wins, as in `jnp.argmax`); otherwise one
    Gumbel draw from ``key`` over the (B, V) logits, bit for bit
    `jax.random.categorical` in the logits' dtype (float32 or bfloat16):
    the temperature is rounded to that dtype and divides exactly, as JAX
    divides by a weakly typed scalar, and the noise is drawn in it."""
    last = logits[:, -1, :]
    if temperature == 0.0:
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    # a 0-d tensor on the logits' device: PyTorch's CUDA division by a CPU
    # scalar multiplies by its reciprocal, which is not JAX's division
    temp = torch.full((), temperature, dtype=last.dtype, device=last.device)
    return rng.categorical(key, last / temp)[:, None]


def make_prefill(model: Model):
    def prefill(batch, caches, pad=None):
        return model.prefill(batch, caches, pad=pad)
    return prefill


def make_decode_step(model: Model, temperature: float = 0.0):
    def decode_step(token, pos: int, caches, key, memory=None, mem_pos=None,
                    pad=None):
        logits, caches = model.decode_step(token, pos, caches, memory,
                                           mem_pos, pad=pad)
        return sample(logits, key, temperature), logits, caches
    return decode_step


@torch.no_grad()
def generate(model: Model, batch, max_new: int, max_len: int,
             temperature: float = 0.0, key=None, mesh=None):
    """Host-loop generation driver: (B, max_new) int32 tokens. ``batch``
    holds "tokens" (B, S) and, for the VLM / audio families,
    "patch_embeds" / "frames": their memory is encoded once for the decode
    steps (the prefill encodes its own, as in the JAX package).

    With ``mesh`` (a DeviceMesh whose rules are active, `use_rules`, and
    over which the model's parameters lie, `launch.shardings.shard_params`)
    the batch and the caches are laid out on it (`shard_batch`,
    `shard_caches`) and prefill and decode run sharded; every rank samples
    from the gathered logits and returns the whole tokens."""
    key = key if key is not None else rng.PRNGKey(0, model.device)
    B, S = batch["tokens"].shape
    caches = model.init_cache(B, max_len)
    place = lambda t: t
    whole = lambda t: t
    if mesh is not None:
        from repro_torch.launch import shardings as SH
        batch = SH.shard_batch(batch, mesh)
        caches = SH.shard_caches(caches, model.cfg, mesh)
        place = lambda t: SH.shard_batch({"t": t}, mesh)["t"]
        whole = lambda t: t.full_tensor()
    memory, mem_pos = bind(model._encode_memory)(batch)
    logits, caches = model.prefill(batch, caches)
    tok = sample(whole(logits), key, temperature)
    out = [tok]
    for i in range(max_new - 1):
        key = rng.fold_in(key, i)
        logits, caches = model.decode_step(place(tok), S + i, caches, memory,
                                           mem_pos)
        tok = sample(whole(logits), key, temperature)
        out.append(tok)
    return torch.cat(out, dim=1)
