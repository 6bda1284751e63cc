"""The port's LM sharding rules (`repro_torch.models.sharding`,
`repro_torch.launch.shardings`, `repro_torch.launch.shapes`) on the CPU.

* The port of tests/test_sharding_rules.py's eight tests, on the port's
  functions. Specs are pure functions of shapes and mesh topology, so a
  mesh here is `sharding.MeshAxes` (axis names and sizes), the JAX tests'
  ``FakeMesh``; no process group is needed.
* The specs themselves against the JAX package's, entry for entry (each
  padded with None to its leaf's rank, since ``P()`` and ``P(None, None)``
  lay a leaf out alike), for all ten LM ids on meshes (1, 1), (2, 2),
  (1, 4), (16, 16) and (2, 16, 16): `param_specs` with and without
  ``fsdp_threshold_bytes``, `opt_specs(zero=True)`, `batch_specs` of the
  train_4k batch and `cache_specs` of the decode_32k caches with and
  without ``seq_shard`` (and of the long_500k caches with it, where the
  arch runs that cell). The JAX package runs in one child process
  (tests/torch_jax_ref.py) over the published configs, on abstract shapes.
* `hint`, `spec` and `placements` outside and inside a rules context.
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch.shapes import (LONG_OK, SHAPES, applicable,
                                       input_specs, params_specs_abstract)
from repro_torch.models.transformer import Model
from repro_torch.models.sharding import (DEFAULT_RULES, P, MeshAxes, hint,
                                         mapped_size, spec, use_rules)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FSDP_BYTES = 1 << 20


def fake(shape, axes) -> MeshAxes:
    return MeshAxes(tuple(axes), dict(zip(axes, shape)))


FAKE16 = fake((16, 16), ("data", "model"))


def _entry(e) -> str:
    if e is None:
        return "-"
    return "+".join(e) if isinstance(e, tuple) else e


def _port_table(spec_tree, shape_tree) -> dict:
    """path -> the spec's entries padded to the leaf's rank, as a string."""
    out = {}

    def one(path, s, leaf):
        entries = list(s) + [None] * (len(leaf.shape) - len(s))
        out["/".join(path)] = ",".join(_entry(e) for e in entries)
    SH.tree_map_with_path(one, spec_tree, shape_tree)
    return out


def _port_specs(arch) -> dict:
    """kind -> port table, for every mesh, of one arch's published config."""
    cfg = get_config(arch)
    p_abs = params_specs_abstract(cfg)
    batch = input_specs(cfg, "train_4k")["batch"]
    caches = input_specs(cfg, "decode_32k")["caches"]
    long = input_specs(cfg, "long_500k")["caches"] if arch in LONG_OK \
        else None
    tables = {}
    for tag, (shape, axes) in MESHES.items():
        m = fake(shape, axes)
        ps = SH.param_specs(p_abs, cfg, m)
        got = {"params": (ps, p_abs),
               "params_fsdp": (SH.param_specs(
                   p_abs, cfg, m, fsdp_threshold_bytes=FSDP_BYTES), p_abs),
               "opt_zero": (SH.opt_specs(ps, zero=True, mesh=m, params=p_abs),
                            SH.AdamWState(torch.empty(()), p_abs, p_abs)),
               "batch": (SH.batch_specs(batch, m), batch),
               "cache": (SH.cache_specs(caches, cfg, m), caches),
               "cache_seq": (SH.cache_specs(caches, cfg, m, seq_shard=True),
                             caches)}
        if long is not None:
            got["cache_long"] = (SH.cache_specs(long, cfg, m, seq_shard=True),
                                 long)
        for kind, (specs, shapes) in got.items():
            tables[f"{tag}/{kind}"] = _port_table(specs, shapes)
    return tables


JAX_BODY = """
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.launch import shardings as SH
from repro.launch.shapes import LONG_OK, input_specs, params_specs_abstract


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def part(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return str(getattr(k, a))


def table(specs, shapes):
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    flat_l = jax.tree.leaves(shapes)
    out = []
    for (path, s), leaf in zip(flat_s, flat_l):
        entries = list(s) + [None] * (len(leaf.shape) - len(s))
        ent = ["-" if e is None else "+".join(e) if isinstance(e, tuple)
               else e for e in entries]
        out.append(("/".join(part(k) for k in path), ",".join(ent)))
    return out


for arch in ARCHS:
    cfg = get_config(arch)
    p_abs = params_specs_abstract(cfg)
    batch = input_specs(cfg, "train_4k")["batch"]
    caches = input_specs(cfg, "decode_32k")["caches"]
    long = input_specs(cfg, "long_500k")["caches"] if arch in LONG_OK \\
        else None
    for tag, (shape, axes) in MESHES.items():
        m = FakeMesh(shape, axes)
        ps = SH.param_specs(p_abs, cfg, m)
        got = {"params": (ps, p_abs),
               "params_fsdp": (SH.param_specs(
                   p_abs, cfg, m, fsdp_threshold_bytes=FSDP_BYTES), p_abs),
               "opt_zero": (SH.opt_specs(ps, zero=True, mesh=m, params=p_abs),
                            (jax.ShapeDtypeStruct((), jnp.int32), p_abs,
                             p_abs)),
               "batch": (SH.batch_specs(batch, m), batch),
               "cache": (SH.cache_specs(caches, cfg, m), caches),
               "cache_seq": (SH.cache_specs(caches, cfg, m, seq_shard=True),
                             caches)}
        if long is not None:
            got["cache_long"] = (SH.cache_specs(long, cfg, m, seq_shard=True),
                                 long)
        for kind, (specs, shapes) in got.items():
            rows = table(specs, shapes)
            OUT[f"{arch}/{tag}/{kind}/path"] = np.array([r[0] for r in rows])
            OUT[f"{arch}/{tag}/{kind}/spec"] = np.array([r[1] for r in rows])
"""


@pytest.fixture(scope="module")
def jax_specs():
    body = (f"ARCHS = {list(ARCH_IDS)!r}\nMESHES = {MESHES!r}\n"
            f"FSDP_BYTES = {FSDP_BYTES}\n" + JAX_BODY)
    out = run_jax(body, timeout=300)
    tables = {}
    for k in out:
        if k.endswith("/path"):
            base = k[:-len("/path")]
            tables[base] = dict(zip(out[k].tolist(),
                                    out[base + "/spec"].tolist()))
    return tables


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(jax_specs, arch):
    port = _port_specs(arch)
    want = {k[len(arch) + 1:]: v for k, v in jax_specs.items()
            if k.startswith(arch + "/")}
    assert sorted(port) == sorted(want)
    for kind, table in want.items():
        assert port[kind] == table, kind


# -- the port of tests/test_sharding_rules.py ---------------------------------

def test_param_specs_congruent():
    cfg = get_config("qwen2-1.5b")
    p_abs = params_specs_abstract(cfg)
    specs = SH.param_specs(p_abs, cfg, fake((1, 1), ("data", "model")))
    paths = lambda t: sorted(_port_table(t, p_abs))
    assert paths(specs) == sorted(_port_table(
        SH.tree_map_with_path(lambda _, x: P(), p_abs), p_abs))
    # every leaf is a spec, no longer than its leaf's rank
    SH.tree_map_with_path(
        lambda _, s, leaf: (isinstance(s, P) and len(s) <= len(leaf.shape))
        or pytest.fail(f"{s} for {tuple(leaf.shape)}"), specs, p_abs)


def test_divisibility_drops_to_replication():
    m = FAKE16
    # kv=2 heads * 128 hd = 256 divides 16 -> sharded
    assert SH._checked(m, 256, ("model",)) == "model"
    # 100 does not divide 16 -> replicate
    assert SH._checked(m, 100, ("model",)) is None
    assert SH._checked(m, 8, ("pod", "data")) is None
    # only axes present in the mesh are used
    assert SH._checked(m, 32, ("pod", "data")) == "data"


def test_moe_expert_dim_sharded():
    cfg = get_config("qwen3-moe-235b-a22b")
    leaf = torch.empty((94, 128, 4096, 1536), device="meta")
    spec_ = SH.param_spec("stack/0/0/ffn/wi", leaf, cfg, FAKE16)
    assert spec_ == P(None, "model", None, None)
    # shared-expert MLP inside an MoE model is NOT expert-sharded
    leaf2 = torch.empty((94, 4096, 1536), device="meta")
    spec2 = SH.param_spec("stack/0/0/ffn/shared/wi", leaf2, cfg, FAKE16)
    assert spec2 == P(None, None, "model")


def _kv_specs(specs, caches):
    table = _port_table(specs, caches)
    return {p: s for p, s in table.items() if p.split("/")[-1] == "k"}


def test_cache_specs_kv_vs_state():
    cfg = get_config("internlm2-1.8b")
    caches = input_specs(cfg, "decode_32k")["caches"]
    k_specs = _kv_specs(SH.cache_specs(caches, cfg, FAKE16), caches)
    assert k_specs, "KV cache specs must exist"
    for s in k_specs.values():
        # batch 128 over data; kv=8 doesn't divide 16 -> head_dim=128 sharded
        assert s == "-,data,-,-,model"


def test_long_500k_seq_sharding():
    cfg = get_config("zamba2-7b")
    caches = input_specs(cfg, "long_500k")["caches"]
    k_specs = _kv_specs(SH.cache_specs(caches, cfg, FAKE16, seq_shard=True),
                        caches)
    assert k_specs
    for s in k_specs.values():
        assert s.split(",")[2] == "data", f"sequence dim must shard: {s}"


def test_applicability_matrix():
    longs = [a for a in
             ("xlstm-125m", "zamba2-7b", "gemma2-9b", "qwen2-1.5b",
              "whisper-large-v3")
             if applicable(a, "long_500k")]
    assert longs == ["xlstm-125m", "zamba2-7b"]
    assert all(applicable(a, s) for a in ("gemma2-9b",)
               for s in ("train_4k", "prefill_32k", "decode_32k"))
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}


def test_input_specs_shapes():
    cfg = get_config("llama-3.2-vision-11b")
    sp = input_specs(cfg, "train_4k")
    assert sp["batch"]["tokens"].shape == (256, 4096)
    assert sp["batch"]["patch_embeds"].shape == (256, 1601, 1280)
    dec = input_specs(cfg, "decode_32k")
    assert dec["token"].shape == (128, 1)
    assert dec["memory"].shape[0] == 128
    # whisper decode carries encoder memory
    cfgw = get_config("whisper-large-v3")
    decw = input_specs(cfgw, "decode_32k")
    assert decw["memory"].shape == (128, 1500, 1280)
    assert all(t.device.type == "meta" for t in
               (sp["batch"]["tokens"], dec["token"], decw["memory"]))


def test_zero_opt_specs_extend_over_data():
    cfg = get_config("internlm2-1.8b")
    p_abs = params_specs_abstract(cfg)
    p_specs = SH.param_specs(p_abs, cfg, FAKE16)
    o_specs = SH.opt_specs(p_specs, zero=True, mesh=FAKE16, params=p_abs)
    # embed (V, D): vocab over model; ZeRO adds data on D (2048 % 16 == 0)
    assert o_specs.mu["embed"] == P("model", "data")
    assert o_specs.step == P()


# -- hints and placements -------------------------------------------------------

def test_hints_are_identity_without_a_mesh():
    x = torch.ones(2, 3)
    assert hint(x, "batch", None) is x
    assert spec("batch", "model_d") == P()
    assert mapped_size("heads") == 1
    with use_rules(DEFAULT_RULES, FAKE16):
        # a context over axis sizes alone resolves specs but lays nothing out
        assert hint(x, "batch", None) is x
        assert mapped_size("heads") == 16
        assert spec("batch", "heads", shape=(32, 12)) == P("data", None)
        assert spec("batch", "heads", shape=(32, 32)) == P("data", "model")


def test_layer_specs_drop_the_repeat_entry():
    cfg = get_config("qwen2-1.5b")
    p_abs = params_specs_abstract(cfg)
    names = dict(Model(cfg, device="meta").named_parameters())
    per = SH.layer_specs(SH.param_specs(p_abs, cfg, FAKE16), cfg, names)
    assert per["layers.3.attn.wq"] == P(None, "model")
    assert per["layers.3.attn.wo"] == P("model", None)
    assert per["layers.3.attn.bk"] == P("model")     # 2 * 128 over 16
    assert per["embed"] == P("model", None)
    assert per["final_norm"] == P()
    assert np.all([len(s) <= names[n].dim() for n, s in per.items()])
