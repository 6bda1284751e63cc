"""The port's LM serving engine (`repro_torch.launch.serve`).

* Against the JAX package on the same requests and parameters, greedy at
  float32 compute with 128-token prompts and a 256-slot cache, so every
  prefill takes the flash path: the committed fixture
  tests/fixtures/lm_serve_smoke.npz (qwen2-1.5b and gemma2-9b, written by
  tests/fixtures/capture_lm.py; the same file chip_smoke.py replays on the
  card), and a live JAX run in a child process (internlm2-1.8b and
  stablelm-3b: two waves, the second of one request; and a ragged wave of
  mixed prompt lengths, which takes the dense path with the pad mask).
  The tokens must be equal; the fixture's prefill logits agree to atol
  5e-6 (|logits| < 0.6; the measured gap is 8e-7).
* `sample` at temperature > 0 against `jax.random.categorical` (one key
  for the batch): equal tokens on (3, 512) float32 logits, and on
  (4, 1, 512) logits in float32 and in bfloat16 for the keys of seeds
  0..39 (160 tokens each; the bf16 draw divides and draws its noise in
  bf16, as JAX does).
* The engine's own contracts, as tests/test_serve.py holds the JAX
  engine: a ragged wave equals solo runs, a queue deeper than the slots
  drains without loss or duplicates, and each slot stops at its own
  ``max_new``; `generate` agrees with the engine, and `main` serves the
  smoke config.
* The other six families against the JAX package, greedy at float32:
  the committed fixture tests/fixtures/lm_families_smoke.npz (written by
  tests/fixtures/capture_lm_families.py, replayed by chip_smoke.py phase
  7b on the card): prefill logits and 8 greedy tokens of two 128-token
  prompts, through the engine for qwen3-moe, llama4, zamba2 and xlstm
  and through `generate` with ``patch_embeds`` / ``frames`` for
  llama-3.2-vision and whisper (its cross layers' tanh gates, 0 at init,
  opened to 0.5 here and in the live run below, so the gated
  cross-attention shows). Logits atol `FAMILY_FIXTURE_ATOL`. And a
  live JAX run: the recurrent stacks (zamba2, xlstm) serve equal-length
  waves (prompts of 128 and 64 tokens interleaved, two slots: the same
  completion order and tokens as the JAX engine's grouping), the MoE
  stacks serve a ragged wave, `generate` with memory for the VLM and
  audio families, and the engine refuses the VLM and audio families,
  whose first prefill fails in the JAX engine.
* A wave of mixed prompt lengths raises ValueError on a recurrent stack.
* On a CUDA device (skipped without one): the fixtures served on the card
  through the flash kernel, with their launch counts.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import rng
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.serve import Request, ServingEngine
from repro_torch.models.transformer import Model, layer_kinds
from repro_torch.train.serve_step import generate, sample

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "lm_serve_smoke.npz"
FIXTURE_ARCHS = ("qwen2-1.5b", "gemma2-9b")
LIVE_ARCHS = ("internlm2-1.8b", "stablelm-3b")
MAX_LEN = 256
LOGIT_ATOL = 5e-6

LIVE_BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.launch.serve import Request, ServingEngine
from repro.models.transformer import Model

for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="pallas_flash")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        OUT[f"{arch}/param{jax.tree_util.keystr(path)}"] = leaf
    for tag, lens in (("waves", (128, 128, 128)), ("ragged", (20, 9, 14))):
        eng = ServingEngine(model, params, 2, MAX_LEN)
        for rid, n in enumerate(lens):
            eng.submit(Request(rid, IN[f"prompt{rid}"][:n], 6))
        done = sorted(eng.run(), key=lambda r: r.rid)
        OUT[f"{arch}/{tag}"] = np.array([r.out for r in done], np.int32)
logits = jnp.asarray(IN["logits"])
OUT["sampled"] = jax.random.categorical(jax.random.PRNGKey(3), logits / 0.7)
for dt in ("float32", "bfloat16"):
    lg = jnp.asarray(IN["logits40"]).astype(dt)[:, -1, :] / 0.7
    OUT[f"sampled40_{dt}"] = np.stack(
        [jax.random.categorical(jax.random.PRNGKey(s), lg) for s in range(40)])
"""


def _prompts():
    rs = np.random.default_rng(11)
    return {f"prompt{i}": rs.integers(0, 512, 128).astype(np.int32)
            for i in range(3)}


def _logits():
    return np.random.default_rng(12).normal(size=(3, 512)).astype(np.float32) * 3


def _logits40():
    """(4, 1, 512) float32 logits, sampled in float32 and in bfloat16."""
    return (np.random.default_rng(13).normal(size=(4, 1, 512)) * 3).astype(
        np.float32)


SAMPLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sample40(dtype, device):
    """sample(temperature=0.7) of `_logits40` in ``dtype`` with the keys of
    seeds 0..39: (40, 4) tokens."""
    lg = torch.from_numpy(_logits40()).to(device, SAMPLE_DTYPES[dtype])
    return np.stack([sample(lg, rng.PRNGKey(s, device), 0.7)[:, 0].cpu().numpy()
                     for s in range(40)])


@pytest.fixture(scope="module")
def live():
    head = f"ARCHS = {LIVE_ARCHS!r}\nMAX_LEN = {MAX_LEN}\n"
    return run_jax(head + LIVE_BODY, {**_prompts(), "logits": _logits(),
                                      "logits40": _logits40()})


def _flat(d, arch, bits=False):
    pre = f"{arch}/param"
    flat = {k[len(pre):]: d[k] for k in d if k.startswith(pre)}
    if bits:   # the fixture stores bfloat16 bit patterns
        flat = {k: (v.astype(np.uint32) << 16).view(np.float32)
                for k, v in flat.items()}
    return flat


def _model(flat, arch, device):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="pallas_flash")
    return convert.lm_model_from_numpy(flat, cfg, device)


def _serve(model, prompts, max_new, slots, device):
    eng = ServingEngine(model, slots, MAX_LEN, device=device)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, max_new))
    return np.array([r.out for r in sorted(eng.run(), key=lambda r: r.rid)])


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def _replay(fixture, arch, device):
    model = _model(_flat(fixture, arch, bits=True), arch, device)
    prompts = fixture["prompts"]
    with torch.no_grad():
        caches = model.init_cache(len(prompts), MAX_LEN)
        logits, _ = model.prefill(
            {"tokens": torch.from_numpy(prompts).long().to(device)}, caches)
    np.testing.assert_allclose(logits.cpu().numpy(), fixture[f"{arch}/logits"],
                               rtol=0, atol=LOGIT_ATOL)
    toks = _serve(model, prompts, 8, len(prompts), device)
    np.testing.assert_array_equal(toks, fixture[f"{arch}/tokens"])


@pytest.mark.parametrize("arch", FIXTURE_ARCHS)
def test_fixture_replays_on_cpu(fixture, arch):
    _replay(fixture, arch, "cpu")


@pytest.mark.parametrize("arch", LIVE_ARCHS)
@pytest.mark.parametrize("tag,lens", [("waves", (128, 128, 128)),
                                      ("ragged", (20, 9, 14))])
def test_engine_matches_jax(live, arch, tag, lens, monkeypatch):
    model = _model(_flat(live, arch), arch, "cpu")
    prompts = [_prompts()[f"prompt{i}"][:n] for i, n in enumerate(lens)]
    before = FA.launches["flash_attention"]
    plain_calls = []
    orig = FA.flash_attention_plain
    monkeypatch.setattr(FA, "flash_attention_plain",
                        lambda *a, **k: plain_calls.append(1) or orig(*a, **k))
    got = _serve(model, prompts, 6, 2, "cpu")
    np.testing.assert_array_equal(got, live[f"{arch}/{tag}"])
    # the CPU takes the plain version; flash runs once per layer per wave
    # of 128-token prompts, never on the ragged (padded) wave
    want = 2 * model.cfg.n_layers if tag == "waves" else 0
    assert len(plain_calls) == want
    assert FA.launches["flash_attention"] == before


def test_sample_matches_jax_categorical(live):
    logits = torch.from_numpy(_logits())[:, None, :]
    got = sample(logits, rng.PRNGKey(3), temperature=0.7)
    assert got.shape == (3, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, 0].numpy(), live["sampled"])
    greedy = sample(logits, rng.PRNGKey(3))
    np.testing.assert_array_equal(greedy[:, 0].numpy(),
                                  _logits().argmax(axis=-1))
    for dtype in SAMPLE_DTYPES:
        got = _sample40(dtype, "cpu")
        assert got.shape == (40, 4)
        np.testing.assert_array_equal(got, live[f"sampled40_{dtype}"],
                                      err_msg=dtype)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("qwen2-1.5b")
    return cfg, Model(cfg, device="cpu", seed=0)


def _short_prompts(lens, seed):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, 512, n).astype(np.int32) for n in lens]


def test_queue_deeper_than_slots_drains_no_loss_no_dup(smoke):
    cfg, model = smoke
    eng = ServingEngine(model, batch_slots=3, max_len=32, device="cpu")
    for rid, p in enumerate(_short_prompts([8] * 7, seed=1)):
        eng.submit(Request(rid, p, max_new=4))
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(7))
    assert not eng.queue
    assert all(r.done and len(r.out) == 4 for r in done)


def test_per_slot_max_new_truncation(smoke):
    cfg, model = smoke
    eng = ServingEngine(model, batch_slots=3, max_len=32, device="cpu")
    budgets = [1, 3, 7]
    for rid, (p, m) in enumerate(zip(_short_prompts([6, 6, 6], seed=2),
                                     budgets)):
        eng.submit(Request(rid, p, max_new=m))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [len(r.out) for r in done] == budgets


def test_ragged_wave_matches_solo_runs(smoke):
    cfg, model = smoke
    lens = [6, 3, 9]
    solo = []
    for rid, p in enumerate(_short_prompts(lens, seed=3)):
        eng = ServingEngine(model, batch_slots=1, max_len=32, device="cpu")
        eng.submit(Request(rid, p, max_new=5))
        solo.append(eng.run()[0].out)
    eng = ServingEngine(model, batch_slots=3, max_len=32, device="cpu")
    for rid, p in enumerate(_short_prompts(lens, seed=3)):
        eng.submit(Request(rid, p, max_new=5))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == 3 and len({r.rid for r in done}) == 3
    for r, want in zip(done, solo):
        assert r.out == want, f"request {r.rid} diverged in the ragged wave"


def test_generate_matches_engine(smoke):
    cfg, model = smoke
    p = _short_prompts([10], seed=4)[0]
    out = generate(model, {"tokens": torch.from_numpy(p).long()[None]},
                   max_new=5, max_len=32)
    eng = ServingEngine(model, batch_slots=1, max_len=32, device="cpu")
    eng.submit(Request(0, p, max_new=5))
    assert out[0].tolist() == eng.run()[0].out


def test_main_serves_the_smoke_config(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--n-requests", "3", "--batch", "2",
          "--prompt-len", "8", "--max-new", "3"])
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FIXTURE_ARCHS)
def test_cuda_fixture_replays_through_the_kernel(fixture, arch):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    before = FA.launches["flash_attention"]
    _replay(fixture, arch, dev)
    n_layers = get_smoke_config(arch).n_layers
    # one prefill for the logits, one for the served wave
    assert FA.launches["flash_attention"] == before + 2 * n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(SAMPLE_DTYPES))
def test_sample_on_cuda_equals_the_cpu(dtype):
    """The card samples the tokens the CPU samples (which the JAX test
    above holds). In bfloat16 it draws the same Gumbel noise bit for bit,
    over all 128 values the 8-bit draw can take; in float32 the two logs
    may differ by an ulp, as torch's and XLA's do (tests/test_torch_rng.py)."""
    dev = _cuda()
    np.testing.assert_array_equal(_sample40(dtype, dev), _sample40(dtype, "cpu"))
    key = rng.PRNGKey(5)
    g_cpu = rng.gumbel(key, (1 << 14,), SAMPLE_DTYPES[dtype])
    g_dev = rng.gumbel(key.to(dev), (1 << 14,), SAMPLE_DTYPES[dtype]).cpu()
    if dtype == "bfloat16":
        assert len(torch.unique(g_cpu)) == 128
        assert torch.equal(g_dev, g_cpu)
    else:
        np.testing.assert_allclose(g_dev.numpy(), g_cpu.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------- the other six families ---------------------------

FAMILY_FIXTURE = FIXTURE.parent / "lm_families_smoke.npz"
FAMILY_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                "zamba2-7b", "xlstm-125m", "llama-3.2-vision-11b",
                "whisper-large-v3")
MEMORY_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3")
RECURRENT_ARCHS = ("zamba2-7b", "xlstm-125m")
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
# float32 prefill logits (|logits| < 4.2) against the fixture's, measured
# on the CPU: up to 4.1e-6 for the attention and MoE stacks, zamba2
# 1.6e-5, xlstm 6.4e-5 (its logits lie 2.3e-4 from float64 in torch and
# XLA alike: tests/test_torch_lm.py); about 5x margin
FAMILY_FIXTURE_ATOL = {"zamba2-7b": 1e-4, "xlstm-125m": 1e-3}
FAMILY_FIXTURE_DEFAULT_ATOL = 2e-5
RECURRENT_LENS = (128, 64, 128, 64, 128)

FAMILY_LIVE_BODY = """
import dataclasses
from repro.configs import get_smoke_config
from repro.launch.serve import Request, ServingEngine
from repro.models.transformer import Model
from repro.train.serve_step import generate

for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="pallas_flash")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # the cross layers' tanh gates start at 0, which hides cross-attention
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 if "gate_" in jax.tree_util.keystr(p) else a,
        params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        OUT[f"{arch}/param{jax.tree_util.keystr(path)}"] = leaf
    if arch in MEMORY_ARCHS:
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        batch = {"tokens": jnp.asarray(IN["prompt0"][None, :128].repeat(2, 0)
                                       + jnp.arange(2)[:, None]) % 512,
                 key: jnp.asarray(IN[f"{arch}/{key}"])}
        OUT[f"{arch}/generate"] = generate(model, params, batch, 6, 256)
        eng = ServingEngine(model, params, 2, 256)
        eng.submit(Request(0, IN["prompt0"][:16], 3))
        try:
            eng.run()
            OUT[f"{arch}/engine_failed"] = np.int32(0)
        except Exception:
            OUT[f"{arch}/engine_failed"] = np.int32(1)
        continue
    lens = RECURRENT_LENS if arch in RECURRENT_ARCHS else (20, 9, 14)
    eng = ServingEngine(model, params, 2, 256)
    for rid, n in enumerate(lens):
        eng.submit(Request(rid, IN[f"prompt{rid % 3}"][:n], 6))
    done = eng.run()
    OUT[f"{arch}/order"] = np.array([r.rid for r in done], np.int32)
    OUT[f"{arch}/tokens"] = np.array(
        [r.out for r in sorted(done, key=lambda r: r.rid)], np.int32)
"""


def _memory_inputs():
    rs = np.random.default_rng(14)
    out = {}
    for arch in MEMORY_ARCHS:
        cfg = get_smoke_config(arch)
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        n = cfg.n_patches if cfg.family == "vlm" else cfg.n_enc_frames
        out[f"{arch}/{key}"] = rs.normal(size=(2, n, cfg.vision_dim)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def live_families():
    head = (f"ARCHS = {FAMILY_ARCHS!r}\nMEMORY_ARCHS = {MEMORY_ARCHS!r}\n"
            f"RECURRENT_ARCHS = {RECURRENT_ARCHS!r}\n"
            f"RECURRENT_LENS = {RECURRENT_LENS!r}\n")
    return run_jax(head + FAMILY_LIVE_BODY, {**_prompts(), **_memory_inputs()},
                   timeout=600)


@pytest.fixture(scope="module")
def family_fixture():
    return dict(np.load(FAMILY_FIXTURE))


def _memory_batch(d, arch, tokens, device):
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)).long().to(device)}
    for k in ("patch_embeds", "frames"):
        if f"{arch}/{k}" in d:
            batch[k] = torch.from_numpy(d[f"{arch}/{k}"]).to(device)
    return batch


def replay_family(d, arch, device):
    """Serve the families fixture's two prompts for ``arch`` on
    ``device``: (prefill logits (2, 1, V) float32 numpy, greedy tokens
    (2, 8))."""
    model = _model(_flat(d, arch, bits=True), arch, device)
    prompts = d["prompts"]
    batch = _memory_batch(d, arch, prompts, device)
    with torch.no_grad():
        logits, _ = model.prefill(batch, model.init_cache(len(prompts),
                                                          MAX_LEN))
    if arch in MEMORY_ARCHS:
        toks = generate(model, batch, 8, MAX_LEN).cpu().numpy()
    else:
        toks = _serve(model, prompts, 8, len(prompts), device)
    return logits.float().cpu().numpy(), toks


def _check_family_replay(d, arch, device):
    logits, toks = replay_family(d, arch, device)
    atol = FAMILY_FIXTURE_ATOL.get(arch, FAMILY_FIXTURE_DEFAULT_ATOL)
    np.testing.assert_allclose(logits, d[f"{arch}/logits"], rtol=0, atol=atol)
    np.testing.assert_array_equal(toks, d[f"{arch}/tokens"])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_fixture_replays_on_cpu(family_fixture, arch):
    _check_family_replay(family_fixture, arch, "cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_engine_groups_equal_lengths_as_jax(live_families, arch):
    model = _model(_flat(live_families, arch), arch, "cpu")
    eng = ServingEngine(model, 2, MAX_LEN, device="cpu")
    assert not eng.ragged
    for rid, n in enumerate(RECURRENT_LENS):
        eng.submit(Request(rid, _prompts()[f"prompt{rid % 3}"][:n], 6))
    done = eng.run()
    order = [r.rid for r in done]
    np.testing.assert_array_equal(order, live_families[f"{arch}/order"])
    assert order == [0, 2, 1, 3, 4]      # grouped by length, FIFO within
    got = np.array([r.out for r in sorted(done, key=lambda r: r.rid)])
    np.testing.assert_array_equal(got, live_families[f"{arch}/tokens"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_serves_a_ragged_wave_as_jax(live_families, arch):
    model = _model(_flat(live_families, arch), arch, "cpu")
    eng = ServingEngine(model, 2, MAX_LEN, device="cpu")
    assert eng.ragged
    for rid, n in enumerate((20, 9, 14)):
        eng.submit(Request(rid, _prompts()[f"prompt{rid}"][:n], 6))
    done = eng.run()
    np.testing.assert_array_equal([r.rid for r in done],
                                  live_families[f"{arch}/order"])
    got = np.array([r.out for r in sorted(done, key=lambda r: r.rid)])
    np.testing.assert_array_equal(got, live_families[f"{arch}/tokens"])


@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_generate_with_memory_matches_jax(live_families, arch):
    model = _model(_flat(live_families, arch), arch, "cpu")
    p0 = _prompts()["prompt0"][:128]
    tokens = (np.stack([p0, p0 + 1]) % 512).astype(np.int64)
    batch = _memory_batch(_memory_inputs(), arch, tokens, "cpu")
    got = generate(model, batch, 6, MAX_LEN)
    assert got.shape == (2, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), live_families[f"{arch}/generate"])


@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_engine_refuses_the_memory_families(live_families, arch):
    """The engine serves token-only batches; the JAX engine fails at the
    first prefill of these families, the port's refuses them up front."""
    assert int(live_families[f"{arch}/engine_failed"]) == 1
    model = Model(get_smoke_config(arch), device="cpu")
    with pytest.raises(ValueError, match="token-only"):
        ServingEngine(model, 2, 32, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_mixed_lengths_in_a_recurrent_wave_raise(arch):
    model = Model(get_smoke_config(arch), device="cpu")
    eng = ServingEngine(model, 2, 32, device="cpu")
    wave = [Request(0, np.arange(8), 2), Request(1, np.arange(12), 2)]
    with pytest.raises(ValueError, match="mixed prompt lengths"):
        eng._run_wave(wave)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_families_fixture_replays_through_the_kernel(family_fixture,
                                                          arch):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = FA.launches["flash_attention"]
    _check_family_replay(family_fixture, arch, dev)
    # causal self-attention prefills of 128 tokens: one for the logits,
    # one for the served tokens
    per = sum(k in ("attn", "attn_local", "attn_moe", "shared_attn",
                    "dec_cross") for k in layer_kinds(get_smoke_config(arch)))
    assert FA.launches["flash_attention"] == before + 2 * per
