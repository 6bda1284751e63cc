"""The port's LM training under a mesh (`launch.train.train(mesh=...)`,
`launch.train.shard_state`, DTensor parameters, `models.sharding`) on
gloo ranks of the CPU, against the one-device port.

One spawn of 4 ranks serves the module (`ranks`, module-scoped,
`launch.ranks.spawn_ranks`). Held here:

* every smoke id (float32 compute, the port's seed-0 init, `AdamW(lr
  =1e-3, warmup_steps=5)`, `MarkovLM(vocab, seed=0).batch(step, 4, 16)`),
  3 steps on meshes (4, 1), (1, 4) and (2, 2), against the same 3 steps
  on one device: each step's loss and grad norm, and the final
  parameters;
* qwen2 at (2, 2) with ZeRO moments for the 20 steps of
  tests/fixtures/train_smoke.npz, from its init, under the bounds
  tests/test_torch_train.py holds the one-device port to;
* `launch.train.train(mesh=...)` at (2, 2): its losses and its checkpoint
  against the one-device run's (the files hold the JAX tree either way);
  the ZeRO run's state saved and restored onto the mesh bit for bit;
* `runtime.elastic.remesh` onto an LM mesh: the port of
  tests/test_checkpoint.py's `test_remesh_roundtrip` on
  `make_host_mesh(shape=(1, 1))`, and a sharded tree moved between
  meshes.

Bounds, sized from the JAX package's own sharded-vs-one-device gap
(tests/jax_sharded_gaps.py: its smoke models at float32, 3 steps on host
meshes (2, 2), (4, 1) and (1, 4) of 4 forced CPU devices against one
device; the largest over meshes and the nine non-chaotic ids): loss
3.5e-7 relative, grad norm 7.2e-7 relative, parameters 2.2e-5 absolute.
`LOSS_RTOL` and `STEP_RTOL` (grad norms) are 2e-6 and `PARAM_ATOL` 1e-4,
about three and five times those. xlstm's float32 training is chaotic:
JAX's own gap is 9.6e-5 in loss, 5.4e-3 in grad norm and 9.2e-4 in
parameters, and it is held to about ten times that. The port's gaps
(torch 2.13 CPU, 4 gloo ranks), the largest over the three meshes: loss
1.4e-7, grad norm 6.7e-7, parameters 1.5e-5 (xlstm 2.8e-7, 1.8e-5,
5.0e-6); `_gaps` reports them on failure.
"""
import contextlib
import dataclasses
import pathlib
import tempfile

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

from repro_torch import convert
from repro_torch.checkpoint import restore, save
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import MarkovLM
from repro_torch.launch import mesh as M
from repro_torch.launch import train as LT
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.sharding import DEFAULT_RULES, P, use_rules
from repro_torch.models.transformer import Model
from repro_torch.runtime.elastic import remesh
from repro_torch.train import AdamW, make_loss_fn, make_train_step

WORLD = 4
MESHES = ((4, 1), (1, 4), (2, 2))
STEPS, BATCH, SEQ = 3, 4, 16
STEP_RTOL = {"default": 2e-6, "xlstm-125m": 5e-2}
LOSS_RTOL = {"default": 2e-6, "xlstm-125m": 1e-3}
PARAM_ATOL = {"default": 1e-4, "xlstm-125m": 1e-2}
FIXTURE_ARCH = "qwen2-1.5b"
CKPT_ARCH = "internlm2-1.8b"


def _tol(table, arch):
    return table.get(arch, table["default"])


def f32(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def batch(cfg, step):
    """The step's batch, with stub patch embeddings / frames for the VLM
    and audio families (the same on every rank)."""
    b = MarkovLM(cfg.vocab, seed=0).batch(step, BATCH, SEQ, device="cpu")
    rs = np.random.default_rng(step)
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(rs.normal(size=(
            BATCH, cfg.n_patches, cfg.vision_dim)).astype(np.float32))
    if cfg.enc_dec:
        b["frames"] = torch.from_numpy(rs.normal(size=(
            BATCH, cfg.n_enc_frames, cfg.vision_dim)).astype(np.float32))
    return b


def full(t):
    """A DTensor's full value (a collective), or the tensor, as numpy."""
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().numpy()


def run_steps(arch, mesh=None, steps=STEPS):
    """``steps`` steps of the smoke model on ``mesh`` (None: one device);
    (losses, grad norms, final parameters by name)."""
    cfg = f32(arch)
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    place = lambda b: b
    with use_rules(DEFAULT_RULES, mesh) if mesh is not None else \
            contextlib.nullcontext():
        if mesh is None:
            params = dict(model.named_parameters())
            state = opt.init(params)
        else:
            params, state, place = LT.shard_state(model, opt, mesh)
        step = make_train_step(model, opt)
        hist = []
        for s in range(steps):
            params, state, m = step(params, state, place(batch(cfg, s)))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        final = {n: full(p) for n, p in params.items()}
    return np.asarray(hist), final


def _fixture_run(mesh, flat):
    """The ZeRO run of train_smoke.npz's qwen2 at (2, 2): (first-step
    gradients, step metrics, final leaves), as tests/test_torch_train.py's
    `run_fixture` returns them, and the live state for the checkpoint."""
    from test_torch_train import LR, METRICS, STEPS as FSTEPS, WARMUP, \
        _leaves
    cfg = f32(FIXTURE_ARCH)
    model = convert.lm_model_from_numpy(flat, cfg, "cpu")
    opt = AdamW(lr=LR, warmup_steps=WARMUP)
    with use_rules(DEFAULT_RULES, mesh):
        params, state, place = LT.shard_state(model, opt, mesh, zero=True)
        total, _ = make_loss_fn(model)(params, place(batch(cfg, 0)))
        g = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
        grad0 = _leaves({n: torch.from_numpy(full(t)) for n, t in g.items()},
                        cfg)
        step = make_train_step(model, opt)
        hist = {k: [] for k in METRICS}
        for s in range(FSTEPS):
            params, state, m = step(params, state, place(batch(cfg, s)))
            for k in METRICS:
                hist[k].append(float(m[k]))
    host = lambda d: {n: torch.from_numpy(full(t)) for n, t in d.items()}
    final = {"param": _leaves(host(params), cfg),
             "mu": _leaves(host(state.mu), cfg),
             "nu": _leaves(host(state.nu), cfg)}
    zero_sharded = sum(p != state.mu[n].placements
                       for n, p in ((n, t.placements)
                                    for n, t in params.items()))
    hist = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    return (grad0, hist, final, int(state.step), zero_sharded), \
        (params, state, cfg)


def _roundtrip(state_tree, ckpt_dir):
    """Save ``state_tree`` (DTensor leaves) and restore it onto the same
    placements: whether every rank's shard came back bit for bit."""
    import torch.distributed as dist
    save(ckpt_dir, 1, state_tree)
    dist.barrier()
    back, want = _tensors(restore(ckpt_dir, 1, state_tree)), \
        _tensors(state_tree)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    same = all(torch.equal(local(a), local(b)) for a, b in zip(back, want))
    placed = all(getattr(a, "placements", None) ==
                 getattr(b, "placements", None) for a, b in zip(back, want))
    return len(back) == len(want) and same and placed


def _tensors(tree):
    from repro_torch.checkpoint.checkpointer import _flatten
    return [t for t in _flatten(tree)[0] if torch.is_tensor(t)]


def _remesh_cases(meshes):
    """test_remesh_roundtrip on a (1, 1) mesh (rank 0 alone is in it), and
    a (2, 2)-sharded tree moved onto (4, 1) and back, bitwise."""
    out = {}
    tree = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
            "v": (torch.ones(8), torch.arange(4))}
    m11 = M.make_host_mesh(shape=(1, 1), device="cpu")
    if m11.get_coordinate() is not None:
        placed = remesh(tree, m11, P())
        out["one"] = ([full(t) for t in _tensors(placed)],
                      all(p == Replicate() for t in _tensors(placed)
                          for p in t.placements))
    specs = {"w": P("data", "model"), "v": (P("model"), P(None))}
    on22 = remesh(tree, meshes[(2, 2)], specs)
    on41 = remesh(on22, meshes[(4, 1)], P("data"))
    back = remesh(on41, meshes[(2, 2)], specs)
    out["moved"] = all(torch.equal(a.to_local(), b.to_local()) for a, b in
                       zip(_tensors(back), _tensors(on22)))
    out["moved_full"] = [full(t) for t in _tensors(on41)]
    out["local_w"] = tuple(on22["w"].to_local().shape)
    return out


def steps_main(rank, world, archs, flat=None, ckpt=None):
    """Every sharded case of a test module on one rank; rank 0's results
    (the others return theirs too)."""
    torch.set_num_threads(1)
    torch.exp(torch.zeros(4))      # warm the first exp on a small tensor
    meshes = {s: M.make_host_mesh(s, device="cpu") for s in MESHES}
    out = {"steps": {(a, s): run_steps(a, meshes[s])
                     for a in archs for s in MESHES}}
    if flat is None:
        return out
    res, (params, state, cfg) = _fixture_run(meshes[(2, 2)], flat)
    out["fixture"] = res
    out["roundtrip"] = _roundtrip(LT.state_tree(params, state, cfg),
                                  f"{ckpt}/zero")
    _, losses = LT.train(CKPT_ARCH, STEPS, BATCH, SEQ, cfg=f32(CKPT_ARCH),
                         mesh=meshes[(2, 2)], ckpt_dir=f"{ckpt}/mesh",
                         lr=1e-3, log_every=1000)
    out["train"] = losses
    out["remesh"] = _remesh_cases(meshes)
    return out


def one_device(archs):
    """The one-device runs of ``archs``, in this process."""
    return {a: run_steps(a) for a in archs}


def check_steps(got, ref, arch, mesh):
    hist, final = got
    want_hist, want_final = ref
    assert sorted(final) == sorted(want_final)
    gaps = _gaps(hist, final, want_hist, want_final)
    assert gaps["loss"] <= _tol(LOSS_RTOL, arch), (arch, mesh, gaps)
    assert gaps["grad_norm"] <= _tol(STEP_RTOL, arch), (arch, mesh, gaps)
    assert gaps["param"] <= _tol(PARAM_ATOL, arch), (arch, mesh, gaps)


def _gaps(hist, final, want_hist, want_final):
    rel = np.abs(hist - want_hist) / np.abs(want_hist)
    return {"loss": float(rel[:, 0].max()),
            "grad_norm": float(rel[:, 1].max()),
            "param": max(float(np.abs(final[n] - want_final[n]).max())
                         for n in final)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_train import _model, load_fixture
    model = _model(load_fixture(), FIXTURE_ARCH)
    flat = convert.lm_params_to_numpy(model)
    ckpt = tmp_path_factory.mktemp("lm_sharded")
    got = spawn_ranks(steps_main, WORLD, args=(ARCH_IDS, flat, str(ckpt)),
                      timeout_s=600)
    return got, ckpt


@pytest.fixture(scope="module")
def reference():
    return one_device(ARCH_IDS)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_steps_match_one_device(ranks, reference, arch, mesh):
    got, _ = ranks
    check_steps(got[0]["steps"][(arch, mesh)], reference[arch], arch, mesh)
    # every rank reads the same metrics
    np.testing.assert_array_equal(got[0]["steps"][(arch, mesh)][0],
                                  got[WORLD - 1]["steps"][(arch, mesh)][0])


def test_zero_run_matches_train_fixture(ranks):
    from test_torch_train import check_fixture, load_fixture
    got, _ = ranks
    grad0, hist, final, n_steps, zero_sharded = got[0]["fixture"]
    assert n_steps == 20
    assert zero_sharded > 0          # the moments are sharded over "data"
    check_fixture(load_fixture(), FIXTURE_ARCH, grad0, hist, final)


def test_sharded_checkpoint_restores_bit_for_bit(ranks):
    got, _ = ranks
    assert all(got[r]["roundtrip"] for r in range(WORLD))


def test_sharded_checkpoint_holds_one_device_leaves(ranks):
    got, ckpt = ranks
    with tempfile.TemporaryDirectory() as d:
        _, losses = LT.train(CKPT_ARCH, STEPS, BATCH, SEQ,
                             cfg=f32(CKPT_ARCH), device="cpu", ckpt_dir=d,
                             lr=1e-3, log_every=1000)
        np.testing.assert_allclose(got[0]["train"], losses,
                                   rtol=STEP_RTOL["default"])
        mesh_dir = pathlib.Path(ckpt) / "mesh" / f"step_{STEPS}"
        one_dir = pathlib.Path(d) / f"step_{STEPS}"
        names = sorted(p.name for p in one_dir.glob("leaf_*.npy"))
        assert names == sorted(p.name for p in mesh_dir.glob("leaf_*.npy"))
        for n in names:
            a, b = np.load(mesh_dir / n), np.load(one_dir / n)
            assert a.shape == b.shape and a.dtype == b.dtype, n
            # each leaf to PARAM_ATOL of its own largest value (moments
            # are many orders below the parameters; the step is exact)
            np.testing.assert_allclose(
                a, b, rtol=0, err_msg=n,
                atol=PARAM_ATOL["default"] * float(np.abs(b).max()))


def test_remesh_roundtrip(ranks):
    got, _ = ranks
    tree = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "v": (np.ones(8, np.float32), np.arange(4))}
    leaves = [tree["v"][0], tree["v"][1], tree["w"]]
    vals, replicated = got[0]["remesh"]["one"]
    for a, b in zip(leaves, vals):
        np.testing.assert_array_equal(a, b)
    # values bitwise AND actually re-placed on the target mesh
    assert replicated and "one" not in got[1]["remesh"]
    for r in range(WORLD):
        rm = got[r]["remesh"]
        assert rm["moved"] and rm["local_w"] == (2, 3)
        for a, b in zip(leaves, rm["moved_full"]):
            np.testing.assert_array_equal(a, b)


# -- on the card ----------------------------------------------------------------

def _nccl_mesh_rank(rank, world):
    """3 smoke steps through `train(mesh=make_host_mesh())` on one NCCL
    rank (cuda:0)."""
    _, losses = LT.train(FIXTURE_ARCH, STEPS, BATCH, SEQ, lr=1e-3,
                         mesh=M.make_host_mesh(), log_every=1000)
    return losses


def _gloo_mesh_rank(rank, world):
    """3 smoke steps on a (1, 2) and a (2, 1) ZeRO mesh of gloo ranks
    sharing cuda:0."""
    torch.cuda.set_device(0)
    return [LT.train(FIXTURE_ARCH, STEPS, BATCH, SEQ, lr=1e-3,
                     cfg=f32(FIXTURE_ARCH), mesh=M.make_host_mesh(shape),
                     zero=shape[0] > 1, log_every=1000)[1]
            for shape in ((1, 2), (2, 1))]


@pytest.mark.cuda
def test_one_nccl_rank_mesh_equals_one_device_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = spawn_ranks(_nccl_mesh_rank, 1, backend="nccl", timeout_s=240)[0]
    _, want = LT.train(FIXTURE_ARCH, STEPS, BATCH, SEQ, lr=1e-3,
                       log_every=1000)
    assert got == want          # a 1-rank mesh runs the same local ops


@pytest.mark.cuda
def test_gloo_ranks_sharing_a_card_match_one_device_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = spawn_ranks(_gloo_mesh_rank, 2, backend="gloo", timeout_s=240)
    _, want = LT.train(FIXTURE_ARCH, STEPS, BATCH, SEQ, lr=1e-3,
                       cfg=f32(FIXTURE_ARCH), log_every=1000)
    for r in range(2):
        for losses in got[r]:
            np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL["default"])
