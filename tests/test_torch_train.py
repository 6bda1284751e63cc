"""The port's LM training (`repro_torch.train`, `repro_torch.launch.train`)
against the JAX package's, on the CPU.

* The committed fixture tests/fixtures/train_smoke.npz
  (tests/fixtures/capture_train.py): for the smoke config of every LM id
  at float32 compute, from the JAX package's init carried across by
  `convert.lm_params_from_numpy`, the gradient of the first step per leaf
  and 20 steps of `make_train_step(Model(cfg), AdamW(lr=1e-3,
  warmup_steps=5))` on `MarkovLM(vocab, seed=0).batch(step, 4, 16)`
  (llama-3.2-vision and whisper with stub patch_embeds / frames): each
  step's loss, total, aux, grad_norm and lr, and the final parameters
  and moments (every leaf of qwen2-1.5b and qwen3-moe, per-leaf norms and
  samples of the rest).
* In one child process (tests/torch_jax_ref.py): `AdamW.update` on random
  leaves during warm-up, after it and with the clip engaged; and
  ``(params, opt_state)`` checkpoints across the packages both ways
  (internlm2 and zamba2, whose tree has a None at the shared block's
  position), every leaf bit for bit, then one more step each side.
* The port's counterparts of tests/test_train.py (loss decreases on the
  smoke qwen2, checkpoint-resume is exact, the grad clip engages), remat
  against no remat, and the launcher's refusal of a mesh that is not a
  DeviceMesh.
* On the card (``cuda``): the fixture at float32 on CUDA, resume-exact at
  smoke size, and the flash kernel's backward raising.

Tolerances, sized from the measured torch-vs-XLA gaps (torch 2.13 CPU):

* the step metrics, relative per step (`STEP_RTOL`): 5e-5 (largest gap
  6.5e-6, internlm2's grad norm; 1.7e-5 on CUDA); zamba2 2e-3 (measured
  5.4e-4: its float32 forward is 4e-5 from XLA's, tests/test_torch_lm.py,
  and the gap grows with the steps);
* the first step's gradient per leaf, |norm - ref| and the samples' max
  |diff|, each over the leaf's reference norm (`GRAD0_TOL`): 5e-5
  (largest 5.3e-6, llama-3.2-vision's cross gate; zamba2 1.2e-5, on
  CUDA 9.3e-6); xlstm below;
* final parameters, max |diff| in units of lr * steps = 0.02
  (`PARAM_UNITS`): 0.01. The largest gap, 0.004, is qwen2's key bias
  ``bk``, whose gradient is zero in exact arithmetic (a key bias shifts a
  query's logits uniformly) and rounding noise in both frameworks, which
  AdamW normalises to steps of about lr; the rest lie within 3e-4 units;
* the moments, max |diff| over the largest reference value of the
  family's tree, and the sampled families' leaf norms, |diff| over the
  largest reference norm (`MOMENT_TOL`): 1e-3 (largest 1.4e-4,
  internlm2's embedding mu; 1.1e-4 on CUDA); zamba2 3e-3 (6.4e-4).

xlstm's float32 training is chaotic at this size: its grad norms start
near 200 against a clip of 1, and a 1e-7 relative perturbation of the
init moves the PORT's own first-step gradient by up to 4.2e-4 per leaf
and its step-0 grad norm by 2e-4, and its trajectory by up to 4.9% in
loss and a factor of 1.8 in grad norm within 20 steps (three draws):
about as far as it lies from JAX's (CPU: 4.0e-5, 1.7e-5, 3.0%, a factor
of 1.64; CUDA: 3.7e-4, 1.7e-4, a factor of 1.68). So its first-step
gradient is held at 1e-3 and its step 0 at 1e-5 (loss, measured 7e-8)
and 5e-4 (grad norm), each about twice the port's own spread; its later
losses within 0.1 relative and its later grad norms within a factor of
5, its final parameters within 2 units of lr * steps (measured 0.69,
CUDA 0.84), and its moments only finite.

The CUDA gaps are chip_smoke.py phase 11a's, which prints them.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch import convert
from repro_torch.checkpoint import restore, save
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import MarkovLM
from repro_torch.launch import train as LT
from repro_torch.models.transformer import Model
from repro_torch.train import (AdamW, cross_entropy, make_eval_step,
                               make_loss_fn, make_train_step, model_params)

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
INIT_FIXTURES = ("lm_serve_smoke.npz", "lm_families_smoke.npz")
FULL_ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b")
METRICS = ("loss", "total", "aux", "grad_norm", "lr")
STEPS, BATCH, SEQ, LR, WARMUP = 20, 4, 16, 1e-3, 5
UNIT = LR * STEPS
CHAOTIC = "xlstm-125m"
STEP_RTOL = {"default": 5e-5, "zamba2-7b": 2e-3}
GRAD0_TOL = {"default": 5e-5, "xlstm-125m": 1e-3}
PARAM_UNITS = {"default": 0.01, "xlstm-125m": 2.0}
MOMENT_TOL = {"default": 1e-3, "zamba2-7b": 3e-3}


def _tol(table, arch):
    return table.get(arch, table["default"])


def _widen(bits):
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def load_fixture():
    """train_smoke.npz, with every family's init under ``<arch>/init``."""
    with np.load(FIX / "train_smoke.npz") as d:
        ref = {k: d[k] for k in d.files}
    for f in INIT_FIXTURES:
        with np.load(FIX / f) as d:
            ref.update({k.replace("/param[", "/init["): d[k]
                        for k in d.files if "/param[" in k})
    return ref


@pytest.fixture(scope="module")
def fixture():
    return load_fixture()


def _cfg(arch, **over):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **over)


def _model(ref, arch, device="cpu", **over):
    """The smoke model holding the JAX package's init from the fixtures."""
    pre = f"{arch}/init"
    flat = {k[len(pre):]: _widen(v) for k, v in ref.items()
            if k.startswith(pre)}
    return convert.lm_model_from_numpy(flat, _cfg(arch, **over), device)


def _batch(ref, arch, step, device="cpu"):
    cfg = get_smoke_config(arch)
    b = MarkovLM(cfg.vocab, seed=0).batch(step, BATCH, SEQ, device=device)
    for k in ("patch_embeds", "frames"):
        if f"{arch}/{k}" in ref:
            b[k] = torch.from_numpy(ref[f"{arch}/{k}"]).to(device)
    return b


def _leaves(tensors, cfg):
    """keystr -> numpy array of the JAX tree's leaf."""
    host = lambda n: tensors[n].detach().cpu().numpy()
    return {key: np.stack([host(n) for n in names]) if stacked
            else host(names[0])
            for key, stacked, names in convert.lm_leaf_groups(cfg, tensors)}


def run_fixture(ref, arch, device="cpu"):
    """20 steps of the port on the fixture's init; (first-step gradients,
    step metrics, params, opt_state) as numpy, by keystr."""
    model = _model(ref, arch, device)
    cfg = model.cfg
    params = model_params(model)
    total, _ = make_loss_fn(model)(params, _batch(ref, arch, 0, device))
    g = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    grad0 = _leaves(g, cfg)
    opt = AdamW(lr=LR, warmup_steps=WARMUP)
    state = opt.init(params)
    step = make_train_step(model, opt)
    hist = {k: [] for k in METRICS}
    for s in range(STEPS):
        params, state, m = step(params, state, _batch(ref, arch, s, device))
        for k in METRICS:
            hist[k].append(float(m[k]))
    hist = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    final = {"param": _leaves(params, cfg), "mu": _leaves(state.mu, cfg),
             "nu": _leaves(state.nu, cfg)}
    assert int(state.step) == STEPS
    return grad0, hist, final


def _sampled(a):
    a = np.asarray(a, np.float32)
    idx = np.linspace(0, a.size - 1, 16).astype(np.int64)
    return np.sqrt(np.sum(a.astype(np.float64) ** 2)), a.reshape(-1)[idx]


def fixture_gaps(ref, arch, grad0, hist, final):
    """The measured gaps of one family's run against the fixture, each in
    the units its bound is stated in."""
    gaps = {"grad0": 0.0, "step0": {}, "steps": {}, "param_units": 0.0,
            "moments": 0.0, "norms": 0.0, "finite": True}
    for key, a in grad0.items():
        rn = max(float(ref[f"{arch}/norm_grad0{key}"]), 1e-30)
        n, s = _sampled(a)
        gaps["grad0"] = max(gaps["grad0"], abs(n - rn) / rn, float(
            np.max(np.abs(s - ref[f"{arch}/sample_grad0{key}"]))) / rn)
    for k in METRICS:
        got, want = hist[k], ref[f"{arch}/{k}"]
        gaps["finite"] &= bool(np.isfinite(got).all())
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        gaps["step0"][k] = float(rel[0])
        gaps["steps"][k] = (float(np.max(np.abs(np.log(got / want))))
                            if arch == CHAOTIC and k == "grad_norm"
                            else float(rel.max()))
    full = arch in FULL_ARCHS
    for tag, leaves in final.items():
        want = {key: ref[f"{arch}/{'' if full else 'sample_'}{tag}{key}"]
                for key in leaves}
        got = {key: a if full else _sampled(a)[1] for key, a in leaves.items()}
        gaps["finite"] &= all(np.isfinite(a).all() for a in leaves.values())
        err = max(float(np.abs(got[k] - want[k]).max()) for k in leaves)
        if tag == "param":
            gaps["param_units"] = err / UNIT
            continue
        big = max(float(np.abs(w).max()) for w in want.values())
        gaps["moments"] = max(gaps["moments"], err / big)
        if not full:
            norms = {k: float(ref[f"{arch}/norm_{tag}{k}"]) for k in leaves}
            big_n = max(norms.values())
            gaps["norms"] = max(gaps["norms"], max(
                abs(_sampled(a)[0] - norms[k]) / big_n
                for k, a in leaves.items()))
    return gaps


def check_gaps(arch, g):
    """Hold one family's `fixture_gaps` to the stated bounds."""
    assert g["finite"], arch
    assert g["grad0"] <= _tol(GRAD0_TOL, arch), g
    if arch == CHAOTIC:
        assert max(v for k, v in g["step0"].items() if k != "grad_norm") \
            <= 1e-5, g
        assert g["step0"]["grad_norm"] <= 5e-4, g
        assert g["steps"]["grad_norm"] <= np.log(5.0), g
        assert max(v for k, v in g["steps"].items() if k != "grad_norm") \
            <= 0.1, g
        assert g["param_units"] <= PARAM_UNITS[arch], g
        return
    assert max(g["steps"].values()) <= _tol(STEP_RTOL, arch), g
    assert g["param_units"] <= _tol(PARAM_UNITS, arch), g
    assert max(g["moments"], g["norms"]) <= _tol(MOMENT_TOL, arch), g


def check_fixture(ref, arch, grad0, hist, final):
    """Hold one family's run against the fixture at the stated bounds."""
    check_gaps(arch, fixture_gaps(ref, arch, grad0, hist, final))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_steps_match_jax(fixture, arch):
    check_fixture(fixture, arch, *run_fixture(fixture, arch))


# -- AdamW and (params, opt_state) checkpoints against the JAX package --------

# name -> AdamW keyword arguments; each takes OPT_STEPS updates
OPT_CASES = {
    "warmup": dict(lr=1e-2, warmup_steps=10),
    "after_warmup": dict(lr=1e-2, warmup_steps=2, b2=0.999),
    "clipped": dict(lr=1e-2, grad_clip=1e-2, warmup_steps=1,
                    weight_decay=0.3),
}
OPT_STEPS = 4
OPT_SHAPES = {"w": (4, 6), "b": (6,), "emb": (10, 3)}
OPT_RTOL, OPT_ATOL = 2e-6, 1e-8
CKPT_ARCHS = ("internlm2-1.8b", "zamba2-7b")
CKPT_STEP = 3
LOSS_RTOL = 5e-5          # one step on identical states: STEP_RTOL's default

LIVE_BODY = """
import dataclasses
from repro.checkpoint import restore, save
from repro.configs import get_smoke_config
from repro.data import MarkovLM
from repro.models.transformer import Model
from repro.train import AdamW, make_train_step

keystr = jax.tree_util.keystr
for name, kw in OPT_CASES.items():
    opt = AdamW(**kw)
    params = {k: jnp.asarray(IN[f"opt/p/{k}"]) for k in OPT_SHAPES}
    st = opt.init(params)
    for s in range(OPT_STEPS):
        grads = {k: jnp.asarray(IN[f"opt/g{s}/{k}"]) for k in OPT_SHAPES}
        params, st, m = opt.update(grads, st, params)
        OUT[f"{name}/{s}/grad_norm"] = m["grad_norm"]
        OUT[f"{name}/{s}/lr"] = m["lr"]
        for k in OPT_SHAPES:
            OUT[f"{name}/{s}/p/{k}"] = params[k]
            OUT[f"{name}/{s}/mu/{k}"] = st.mu[k]
            OUT[f"{name}/{s}/nu/{k}"] = st.nu[k]

for arch in CKPT_ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = Model(cfg)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    step_fn = jax.jit(make_train_step(model, opt))
    data = MarkovLM(cfg.vocab, seed=0)
    params = model.init(jax.random.PRNGKey(0))
    st = opt.init(params)
    for s in range(CKPT_STEP):
        params, st, _ = step_fn(params, st, data.batch(s, 4, 16))
    save(f"{JAX_DIR}/{arch}", CKPT_STEP, (params, st))
    for tag, tree in (("param", params), ("mu", st.mu), ("nu", st.nu)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            OUT[f"{arch}/jax/{tag}{keystr(path)}"] = leaf
    _, _, m = step_fn(params, st, data.batch(CKPT_STEP, 4, 16))
    OUT[f"{arch}/jax/next_loss"] = m["loss"]
    # the port's checkpoint, into the JAX package's template
    pp, ps = restore(f"{PORT_DIR}/{arch}", CKPT_STEP, (params, st))
    OUT[f"{arch}/port/step"] = ps.step
    for tag, tree in (("param", pp), ("mu", ps.mu), ("nu", ps.nu)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            OUT[f"{arch}/port/{tag}{keystr(path)}"] = leaf
    _, _, m = step_fn(pp, ps, data.batch(CKPT_STEP, 4, 16))
    OUT[f"{arch}/port/next_loss"] = m["loss"]
"""


def _opt_inputs():
    rs = np.random.default_rng(5)
    d = {f"opt/p/{k}": rs.normal(size=s).astype(np.float32)
         for k, s in OPT_SHAPES.items()}
    for step in range(OPT_STEPS):
        for k, s in OPT_SHAPES.items():
            # one tiny-gradient leaf, so AdamW's normalisation shows
            scale = 1e-4 if k == "b" else 3.0
            d[f"opt/g{step}/{k}"] = (rs.normal(size=s) * scale).astype(
                np.float32)
    return d


def _port_run(arch, steps, device="cpu"):
    """The port's own smoke model after ``steps`` steps (seed 0)."""
    cfg = _cfg(arch)
    model = Model(cfg, device=device, seed=0)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    params = model_params(model)
    state = opt.init(params)
    step = make_train_step(model, opt)
    data = MarkovLM(cfg.vocab, seed=0)
    for s in range(steps):
        params, state, _ = step(params, state,
                                data.batch(s, 4, 16, device=device))
    return model, opt, params, state, step, data


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """One JAX child: the AdamW cases, the JAX package's checkpoints
    written, and the port's (written here first) restored."""
    tmp = tmp_path_factory.mktemp("train_ckpt")
    port = {}
    for arch in CKPT_ARCHS:
        model, opt, params, state, step, data = _port_run(arch, CKPT_STEP)
        save(str(tmp / "port" / arch), CKPT_STEP,
             LT.state_tree(params, state, model.cfg))
        port[arch] = (model, opt, params, state, step, data)
    ins = _opt_inputs()
    head = (f"OPT_CASES = {OPT_CASES!r}\nOPT_STEPS = {OPT_STEPS}\n"
            f"OPT_SHAPES = {OPT_SHAPES!r}\nCKPT_ARCHS = {CKPT_ARCHS!r}\n"
            f"CKPT_STEP = {CKPT_STEP}\nJAX_DIR = {str(tmp / 'jax')!r}\n"
            f"PORT_DIR = {str(tmp / 'port')!r}\n")
    out = run_jax(head + LIVE_BODY, ins, timeout=300)
    return ins, out, port, tmp


@pytest.mark.parametrize("case", OPT_CASES)
def test_adamw_matches_jax(live, case):
    ins, ref, _, _ = live
    opt = AdamW(**OPT_CASES[case])
    params = {k: torch.from_numpy(ins[f"opt/p/{k}"]).clone()
              for k in OPT_SHAPES}
    state = opt.init(params)
    for s in range(OPT_STEPS):
        grads = {k: torch.from_numpy(ins[f"opt/g{s}/{k}"])
                 for k in OPT_SHAPES}
        new, state, m = opt.update(grads, state, params)
        assert new is params                 # updated in place
        assert state.step.dtype == torch.int32 and int(state.step) == s + 1
        for k, got in (("grad_norm", m["grad_norm"]), ("lr", m["lr"])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), ref[f"{case}/{s}/{k}"],
                                       rtol=OPT_RTOL)
        for tag, tree in (("p", params), ("mu", state.mu), ("nu", state.nu)):
            for k in OPT_SHAPES:
                np.testing.assert_allclose(
                    tree[k].numpy(), ref[f"{case}/{s}/{tag}/{k}"],
                    rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=f"{tag}/{k}")
    if case == "clipped":
        assert float(m["grad_norm"]) > 1.0 > OPT_CASES[case]["grad_clip"]


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_from_jax_loads_in_port(live, arch):
    """A JAX (params, opt_state) checkpoint restores into the port bit
    for bit and continues as the JAX run does."""
    _, ref, _, tmp = live
    cfg = _cfg(arch)
    model = Model(cfg, device="cpu", seed=1)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    params = model_params(model)
    state = opt.init(params)
    tree, _ = LT.restore_latest(str(tmp / "jax" / arch),
                                LT.state_template(params, cfg))
    state = LT.load_state(tree, params, state, cfg)
    assert state.step.dtype == torch.int32 and int(state.step) == CKPT_STEP
    for tag, d in (("param", params), ("mu", state.mu), ("nu", state.nu)):
        for key, a in _leaves(d, cfg).items():
            np.testing.assert_array_equal(a, ref[f"{arch}/jax/{tag}{key}"])
    step = make_train_step(model, opt)
    b = MarkovLM(cfg.vocab, seed=0).batch(CKPT_STEP, 4, 16, device="cpu")
    _, _, m = step(params, state, b)
    np.testing.assert_allclose(float(m["loss"]), ref[f"{arch}/jax/next_loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_from_port_loads_in_jax(live, arch):
    """The port's (params, opt_state) checkpoint restores into the JAX
    package's template bit for bit and continues as the port does."""
    _, ref, port, _ = live
    model, opt, params, state, step, data = port[arch]
    assert ref[f"{arch}/port/step"].dtype == np.int32
    assert int(ref[f"{arch}/port/step"]) == CKPT_STEP
    for tag, d in (("param", params), ("mu", state.mu), ("nu", state.nu)):
        for key, a in _leaves(d, model.cfg).items():
            np.testing.assert_array_equal(ref[f"{arch}/port/{tag}{key}"], a)
    _, _, m = step(params, state, data.batch(CKPT_STEP, 4, 16, device="cpu"))
    np.testing.assert_allclose(float(m["loss"]), ref[f"{arch}/port/next_loss"],
                               rtol=LOSS_RTOL)


# -- the port's counterparts of tests/test_train.py ---------------------------

def test_loss_decreases_markov_lm():
    _, losses = LT.train("qwen2-1.5b", steps=100, batch=16, seq=64,
                         smoke=True, lr=1e-2, log_every=1000, device="cpu")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    # the stream's entropy is log(branch) = log 4 ~ 1.39; random init
    # starts near log(vocab) = log 512 ~ 6.2 (measured: 6.24 -> 1.98)
    assert last < first - 2.0, f"no learning: {first:.3f} -> {last:.3f}"
    assert np.isfinite(losses).all()


def test_checkpoint_resume_exact(tmp_path):
    """Stop at 20 steps, resume to 30 == train straight to 30 (same data),
    through the launcher: `AsyncCheckpointer` at the end of the first run,
    `restore_latest` at the start of the second."""
    kw = dict(batch=4, seq=16, smoke=True, lr=1e-3, log_every=1000,
              device="cpu")
    _, straight = LT.train("internlm2-1.8b", steps=30, **kw)
    d = str(tmp_path / "ckpt")
    _, first = LT.train("internlm2-1.8b", steps=20, ckpt_dir=d, **kw)
    _, resumed = LT.train("internlm2-1.8b", steps=30, ckpt_dir=d, **kw)
    assert len(resumed) == 10
    np.testing.assert_allclose(first + resumed, straight, rtol=1e-5,
                               atol=1e-6)


def test_checkpoint_resume_exact_explicit(tmp_path):
    """The JAX test's explicit form: save at 20, restore, 10 more steps ==
    10 more steps of the uninterrupted state."""
    model, opt, params, state, step, data = _port_run("internlm2-1.8b", 20)
    cfg = model.cfg
    save(str(tmp_path), 20, LT.state_tree(params, state, cfg))
    model2 = Model(cfg, device="cpu", seed=7)
    params2 = model_params(model2)
    state2 = LT.load_state(
        restore(str(tmp_path), 20, LT.state_template(params2, cfg)),
        params2, opt.init(params2), cfg)
    step2 = make_train_step(model2, opt)
    resumed, cont = [], []
    for s in range(20, 30):
        b = data.batch(s, 4, 16, device="cpu")
        params2, state2, m = step2(params2, state2, b)
        resumed.append(float(m["loss"]))
        params, state, m = step(params, state, b)
        cont.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, cont, rtol=1e-5, atol=1e-6)


def test_grad_clip_engages():
    opt = AdamW(lr=1.0, grad_clip=1e-3, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.ones((4,))}
    st = opt.init(params)
    big = {"w": torch.full((4,), 1e6)}
    p2, st2, m = opt.update(big, st, {"w": params["w"].clone()})
    assert float(m["grad_norm"]) > 1e5
    # clipped update magnitude ~ lr * unit vector
    assert float(torch.max(torch.abs(p2["w"] - params["w"]))) < 1.1


# -- the port's own contracts ---------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-large-v3"])
def test_remat_matches_no_remat(fixture, arch):
    """Recomputing each block in the backward (cfg.remat, the default)
    gives the gradients of the plain backward bit for bit."""
    grads = []
    for remat in (True, False):
        model = _model(fixture, arch, remat=remat)
        params = model_params(model)
        total, _ = make_loss_fn(model)(params, _batch(fixture, arch, 0))
        grads.append(torch.autograd.grad(total, list(params.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_remat_recomputes_each_block(fixture, monkeypatch):
    """Under remat, each block runs twice per training step (forward and
    recompute); without autograd, or with remat off, once."""
    from repro_torch.models import transformer as TT
    calls = []
    orig = TT.apply_block
    monkeypatch.setattr(TT, "apply_block",
                        lambda *a, **kw: calls.append(a[3]) or orig(*a, **kw))
    model = _model(fixture, "qwen2-1.5b")
    params = model_params(model)
    b = _batch(fixture, "qwen2-1.5b", 0)
    total, _ = make_loss_fn(model)(params, b)
    n = len(model.layers)
    assert len(calls) == n
    torch.autograd.grad(total, list(params.values()))
    assert len(calls) == 2 * n
    make_eval_step(model)(params, b)
    assert len(calls) == 3 * n


def test_eval_step_matches_the_train_steps_loss(fixture):
    model = _model(fixture, "gemma2-9b")
    params = model_params(model)
    b = _batch(fixture, "gemma2-9b", 0)
    ev = make_eval_step(model)(params, b)
    opt = AdamW(lr=LR, warmup_steps=WARMUP)
    _, _, m = make_train_step(model, opt)(params, opt.init(params), b)
    assert float(ev["loss"]) == float(m["loss"])
    np.testing.assert_allclose(float(m["loss"]), fixture["gemma2-9b/loss"][0],
                               rtol=_tol(STEP_RTOL, "gemma2-9b"))


def test_cross_entropy_z_loss():
    rs = np.random.default_rng(0)
    logits = torch.from_numpy(rs.normal(size=(2, 3, 7)).astype(np.float32))
    labels = torch.from_numpy(rs.integers(0, 7, (2, 3)).astype(np.int32))
    total, ce = cross_entropy(logits.bfloat16(), labels)
    lse = torch.logsumexp(logits.bfloat16().float(), -1)
    want = (lse - logits.bfloat16().float().gather(
        -1, labels[..., None].long())[..., 0]).mean()
    assert total.dtype == ce.dtype == torch.float32
    torch.testing.assert_close(ce, want)
    torch.testing.assert_close(total, want + 1e-4 * (lse ** 2).mean())


def test_train_step_refuses_foreign_params(fixture):
    model = _model(fixture, "qwen2-1.5b")
    params = {k: v.detach().clone() for k, v in model_params(model).items()}
    opt = AdamW()
    with pytest.raises(ValueError, match="model's own parameters"):
        make_train_step(model, opt)(params, opt.init(params),
                                    _batch(fixture, "qwen2-1.5b", 0))


def test_train_refuses_a_mesh():
    """A mesh that is not a DeviceMesh is refused (the sharded runs are
    tests/test_torch_lm_sharded.py's)."""
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        LT.train("qwen2-1.5b", steps=1, batch=2, seq=8, mesh=object(),
                 device="cpu")


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        model, _ = LT.train("qwen2-1.5b", steps=1, batch=2, seq=8,
                            log_every=1000)
        assert model.embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LT.train("qwen2-1.5b", steps=1, batch=2, seq=8)


def test_launcher_main_runs_on_the_cpu(capsys):
    LT.main(["--steps", "3", "--batch", "2", "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "loss first10=" in out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_memory_families_need_their_stub_inputs(arch):
    """The launcher's batches carry no patch_embeds / frames: these
    families' forward fails, as the JAX launcher's does."""
    with pytest.raises(KeyError):
        LT.train(arch, steps=1, batch=2, seq=8, device="cpu")


# -- on the card -----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cuda_train_steps_match_jax(fixture, arch):
    dev = _cuda()
    check_fixture(fixture, arch, *run_fixture(fixture, arch, dev))


@pytest.mark.cuda
def test_cuda_checkpoint_resume_exact(tmp_path):
    _cuda()
    kw = dict(batch=4, seq=16, smoke=True, lr=1e-3, log_every=1000)
    _, straight = LT.train("internlm2-1.8b", steps=30, **kw)
    d = str(tmp_path / "ckpt")
    _, first = LT.train("internlm2-1.8b", steps=20, ckpt_dir=d, **kw)
    _, resumed = LT.train("internlm2-1.8b", steps=30, ckpt_dir=d, **kw)
    np.testing.assert_allclose(first + resumed, straight, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_flash_backward_raises():
    """The flash kernel has no backward: a backward through the CUDA op
    raises; without autograd it launches as before."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = FA.launches["flash_attention"]
    with torch.no_grad():
        ops.flash_attention(q, k, v, scale=0.125)
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, scale=0.125)
    assert FA.launches["flash_attention"] == before + 2
    with pytest.raises(NotImplementedError, match="no backward"):
        out.float().sum().backward()
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              attn_impl="pallas_flash")
    model = Model(cfg, device=dev)
    toks = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    logits, _ = model.forward({"tokens": toks})
    with pytest.raises(NotImplementedError, match="no backward"):
        logits.float().sum().backward()
