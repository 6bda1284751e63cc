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
* On a CUDA device (skipped without one): the fixture served on the card
  through the flash kernel, with its launch count.
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
from repro_torch.models.transformer import Model
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
