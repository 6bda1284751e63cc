"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
it runs on CUDA unless the caller asks for the CPU (the BCPNN `Simulator`,
the LM `Model` and `ServingEngine`), its flags select the backends the JAX
package's flags select, the Simulator saves and loads, and every part that
is not ported yet raises instead of running something else."""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import (DenseBackend, Simulator, WorklistBackend,
                              select_backend)
from repro_torch.core.layout import BlockedLayout, FlatLayout
from repro_torch.core.params import human_scale, rodent_scale
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.layers import KVCache
from repro_torch.models.transformer import Model, init_cache_for_kind
from torch_jax_ref import run_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_simulator_defaults_to_cuda():
    p = tiny_scale(4, 64, 16)
    if torch.cuda.is_available():
        assert Simulator(p).state.hcus.zij.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Simulator(p)


@pytest.mark.parametrize("make", ["model", "engine"])
def test_lm_entry_points_default_to_cuda(make):
    cfg = get_smoke_config("qwen2-1.5b")
    build = {"model": lambda: Model(cfg),
             "engine": lambda: ServingEngine(Model(cfg, device="cpu"), 2, 32)}
    if torch.cuda.is_available():
        obj = build[make]()
        model = obj if make == "model" else obj.model
        assert model.embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build[make]()


DENSE = ("internlm2-1.8b", "stablelm-3b", "qwen2-1.5b", "gemma2-9b")


FAMILY_ARCHS = [a for a in ARCH_IDS if a not in DENSE]
# block kind -> the smoke config whose stack has it
KIND_ARCH = {"attn_moe": "qwen3-moe-235b-a22b", "mamba": "zamba2-7b",
             "mlstm": "xlstm-125m", "slstm": "xlstm-125m",
             "shared_attn": "zamba2-7b", "cross": "llama-3.2-vision-11b",
             "enc_attn": "whisper-large-v3", "dec_cross": "whisper-large-v3"}
CACHE_BATCH, CACHE_LEN = 3, 40

COUNTS_BODY = """
from repro.configs import get_config, get_smoke_config
from repro.models.transformer import count_params, init_cache_for_kind

for arch in ARCHS:
    cfg = get_config(arch)
    OUT[f"{arch}/count"] = np.int64(count_params(cfg))
    OUT[f"{arch}/analytic"] = np.int64(cfg._param_count_analytic())
    OUT[f"{arch}/active"] = np.int64(cfg.active_param_count())
for kind, arch in KIND_ARCH.items():
    cache = init_cache_for_kind(get_smoke_config(arch), kind, BATCH, LEN)
    OUT[f"{kind}/leaves"] = np.array(repr(
        [(tuple(l.shape), str(l.dtype), float(l.min()), float(l.max()))
         for l in jax.tree.leaves(cache)]))
"""


@pytest.fixture(scope="module")
def jax_counts():
    head = (f"ARCHS = {FAMILY_ARCHS!r}\nKIND_ARCH = {KIND_ARCH!r}\n"
            f"BATCH, LEN = {CACHE_BATCH}, {CACHE_LEN}\n")
    return run_jax(head + COUNTS_BODY)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_family_param_count_matches_jax(jax_counts, arch):
    """`ArchConfig.param_count` (a model built on the meta device) at full
    width equals the JAX package's `count_params` (an abstract init), and
    the analytic and active counts equal the JAX package's."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert cfg.param_count() == int(jax_counts[f"{arch}/count"])
    assert cfg._param_count_analytic() == int(jax_counts[f"{arch}/analytic"])
    assert cfg.active_param_count() == int(jax_counts[f"{arch}/active"])


@pytest.mark.parametrize("kind", list(KIND_ARCH))
def test_cache_for_kind_matches_jax(jax_counts, kind):
    """Shapes, dtypes and fill values of each kind's empty cache, leaf for
    leaf; a `KVCache`'s length is a Python int 0 where JAX holds a 0-d
    int32."""
    cache = init_cache_for_kind(get_smoke_config(KIND_ARCH[kind]), kind,
                                CACHE_BATCH, CACHE_LEN, "cpu")
    if cache is None:
        leaves = []
    elif isinstance(cache, KVCache):
        assert cache.length == 0 and isinstance(cache.length, int)
        leaves = [cache.k, cache.v, torch.zeros((), dtype=torch.int32)]
    else:
        leaves = list(cache)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""),
            float(t.min()), float(t.max())) for t in leaves]
    assert repr(got) == str(jax_counts[f"{kind}/leaves"])


@pytest.mark.parametrize("arch", DENSE)
def test_dense_param_count_matches_the_analytic_count(arch):
    """`ArchConfig.param_count` (a meta-device model) at full width, against
    the JAX package's analytic formula for the dense family, written out."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    attn = D * H * hd + 2 * D * Kv * hd + H * hd * D
    bias = (H + 2 * Kv) * hd if cfg.qkv_bias else 0
    per_layer = attn + bias + 3 * D * cfg.d_ff + 2 * D
    head = cfg.vocab * D * (1 if cfg.tie_embeddings else 2)
    assert cfg.param_count() == cfg.n_layers * per_layer + head + D


@pytest.mark.parametrize("spec", ["tiled", "blocked_gpu", 4])
def test_unknown_layout_raises(spec):
    """A layout spec that `layout.resolve_layout` does not know raises
    ValueError, as in the JAX package."""
    with pytest.raises(ValueError, match="unknown plane layout"):
        select_backend(tiny_scale(), layout=spec)
    with pytest.raises(ValueError, match="unknown plane layout"):
        Simulator(tiny_scale(), device="cpu", layout=spec)


SMALL = tiny_scale()                   # R*C = 1024: the dense backend
LARGE = rodent_scale(4)                # R*C = 84000: the worklist backend
TILE84 = BlockedLayout(LARGE.rows, LARGE.cols, 8, 4)


@pytest.mark.parametrize("p,kw,want", [
    (SMALL, dict(eager=True), DenseBackend(mode="eager")),
    (LARGE, dict(eager=True), DenseBackend(mode="eager")),
    (LARGE, dict(worklist=False), DenseBackend(mode="lazy")),
    (LARGE, dict(fused=False), WorklistBackend(fused=False, fused_cols=True)),
    (LARGE, dict(fused_cols=False),
     WorklistBackend(fused=True, fused_cols=False)),
    (SMALL, dict(), DenseBackend(mode="lazy")),
    (SMALL, dict(worklist=True), WorklistBackend(fused=True, fused_cols=True)),
    (SMALL, dict(worklist=True, fused=False, fused_cols=False),
     WorklistBackend(fused=False, fused_cols=False)),
    (LARGE, dict(), WorklistBackend(fused=True, fused_cols=True)),
    (human_scale(4), dict(), WorklistBackend(fused=True, fused_cols=True)),
    (LARGE, dict(layout="blocked"), WorklistBackend(layout=TILE84)),
    (LARGE, dict(layout=TILE84, fused=False),
     WorklistBackend(fused=False, layout=TILE84)),
    (LARGE, dict(layout="blocked_tpu"), WorklistBackend(
        layout=BlockedLayout(LARGE.rows, LARGE.cols, 8, 128))),
    (LARGE, dict(layout="flat"), WorklistBackend()),
    (LARGE, dict(layout=FlatLayout()), WorklistBackend()),
    (LARGE, dict(layout="blocked", worklist=False),
     DenseBackend(mode="lazy", layout=TILE84)),
    (SMALL, dict(layout="blocked", eager=True), DenseBackend(
        mode="eager", layout=BlockedLayout(SMALL.rows, SMALL.cols, 8, 4))),
    (SMALL, dict(merged=True), DenseBackend(mode="merged")),
    (LARGE, dict(merged=True), WorklistBackend(mode="merged", fused=True,
                                               fused_cols=True)),
    (SMALL, dict(merged=True, worklist=True), WorklistBackend(mode="merged")),
    (LARGE, dict(merged=True, layout="blocked"),
     WorklistBackend(mode="merged", layout=TILE84)),
], ids=["eager", "eager_large", "worklist", "fused", "fused_cols",
        "small_default", "small_worklist", "small_unfused", "rodent_default",
        "human_default", "layout", "layout_instance", "layout_tpu",
        "layout_flat", "layout_flat_instance", "layout_dense",
        "layout_eager", "merged", "merged_large", "merged_worklist",
        "merged_blocked"])
def test_select_backend(p, kw, want):
    """The JAX package's selection: eager is dense; otherwise the size
    guard R*C > 65536 takes the worklist backend unless `worklist=`
    forces either, in mode "merged" under `merged=True`; `fused` /
    `fused_cols` pick its kernels; the layout spec is resolved once
    (`"blocked"`: the (8, 4) tile) and becomes the backend's field."""
    got = select_backend(p, **kw)
    assert type(got) is type(want) and got == want
    assert Simulator(p, n_hcu=2, device="cpu", **kw).backend == want


@pytest.mark.parametrize("method", ["run_sharded"])
def test_unported_simulator_methods_raise(method):
    """What the port's sharded runtime does not run raises, with the JAX
    package's message: a merged Simulator's `run_sharded` (the sharded
    runtime itself is held in tests/test_torch_distributed.py)."""
    p = tiny_scale(4, 64, 16)
    sim = Simulator(p, device="cpu", merged=True)
    with pytest.raises(NotImplementedError, match="merged mode is not "
                       "supported by the sharded runtime"):
        getattr(sim, method)(torch.full((1, 4, 8), p.rows, dtype=torch.int32))


@pytest.mark.parametrize("merged", [False, True], ids=["lazy", "merged"])
def test_simulator_save_load_round_trip(tmp_path, merged):
    """`save` and `load` work on the CPU: a fresh Simulator restores every
    leaf bit for bit (the rings of a merged state included) and its next
    ticks fire as the saved one's."""
    p = tiny_scale(4, 64, 16)
    ext = torch.full((6, 4, 8), p.rows, dtype=torch.int32)
    ext[:, :, 0] = torch.arange(6)[:, None] * 7 % p.rows
    sim = Simulator(p, device="cpu", merged=merged)
    sim.run(ext[:3])
    sim.save(str(tmp_path / "ckpt"))
    back = Simulator(p, device="cpu", merged=merged).load(
        str(tmp_path / "ckpt"))
    assert (back.state.jring is not None) == merged
    for f, a, b in zip(sim.state._fields, sim.state, back.state):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert (x is None and y is None) or torch.equal(x, y), f
    assert torch.equal(sim.run(ext[3:]), back.run(ext[3:]))


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no_cache"])
def test_flash_path_reads_q_and_the_kv_cache_in_place(monkeypatch, cached):
    """`layers._sdpa_flash` hands the flash kernel q as the projection
    gives it, (B, S, H, hd), and k / v with their Kv heads: with a cache,
    the cache's own storage, so no G-fold copy of k / v is made."""
    import dataclasses
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as TL
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              compute_dtype="float32",
                              attn_impl="pallas_flash")
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    assert H > Kv
    gen = torch.Generator().manual_seed(0)
    params = TL.init_attn(cfg, gen, "cpu")
    B, S, slots = 2, 128, 256
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    cache = TL.KVCache(torch.zeros(B, slots, Kv, hd),
                       torch.zeros(B, slots, Kv, hd), 0) if cached else None
    seen = []
    orig = FA.flash_attention_plain
    monkeypatch.setattr(FA, "flash_attention_plain", lambda q, k, v, **kw:
                        seen.append((q, k, v)) or orig(q, k, v, **kw))
    TL.attend(params, x, cfg, positions=torch.arange(S), cache=cache)
    (q, k, v), = seen
    assert q.shape == (B, S, H, hd) and q.is_contiguous()
    assert k.shape == v.shape == (B, slots if cached else S, Kv, hd)
    if cached:
        assert k.data_ptr() == cache.k.data_ptr()
        assert v.data_ptr() == cache.v.data_ptr()
