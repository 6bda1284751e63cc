"""The port's BCPNN cell-update kernels against the JAX package.

* On the CPU, the five `repro_torch.kernels.ops` entries (their plain
  PyTorch versions) against the JAX Pallas kernels in interpret mode at a
  4x64x16 size (`ops.fused_row_update`, `ops.fused_col_update`,
  `ops.worklist_row_update`, and `ops.row_update` / `ops.col_update`
  vmapped over HCUs / fired entries as `repro.core.hcu.row_updates` and
  `repro.core.engine.column_updates_batched` call them), and against the
  JAX cell oracle (`bcpnn_ref.row_update_ref` / `col_update_ref`) at
  rodent width (R=1200, C=70). The JAX side runs in a child process. The
  port's fused kernels read the (H, C) j-vectors and the raw i-vectors
  themselves; the JAX side gathers them per slot / entry and applies the
  column prologue's i-vector decay (`hcu.ivec_decay`) before its kernel.
  The three worklist entries also run on planes stored column-blocked
  ((8, 4) and (7, 5) tiles), compared after unpacking. The unfused entry
  takes the slot-ordered worklist, its compaction ``order`` and ``nv``
  and the (H, C) j-vectors; the JAX side gets the per-entry rows and
  operands its engine gathers from them. `engine.worklist_lazy_rows`
  unfused equals fused bit for bit.
* On a CUDA device (skipped without one), each CUDA kernel against its
  plain version on the same inputs, flat and blocked.
* The device decides the path: a non-CPU tensor never reaches the plain
  version.

Tolerance: integers exactly; floats rtol=1e-5, atol=1e-6, the weight
plane and weight rows atol=1e-5 (w = log(...) passes through zero, where
an ulp of the argument is a large relative error). XLA:CPU and torch
evaluate exp/log with different float32 approximations; the measured gaps
are far inside these bounds (z, e, p within a few ulp).
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.core import hcu as TH
from repro_torch.core.params import BCPNNParams
from repro_torch.kernels import bcpnn_update as BU
from repro_torch.kernels import ops

NOW = 50
SMALL = dict(n=4, R=64, C=16, A=8)
RODENT = dict(n=4, R=1200, C=70, A=24)
ROW_PLANES = ("zij", "eij", "pij", "wij", "tij", "zi", "ei", "pi", "ti")
COL_PLANES = ("zij", "eij", "pij", "wij", "tij")


def _planes(rs, n, R, C):
    HR = n * R
    return dict(
        zij=rs.uniform(0, 2, (HR, C)).astype(np.float32),
        eij=rs.uniform(0, 0.5, (HR, C)).astype(np.float32),
        pij=rs.uniform(1e-5, 0.05, (HR, C)).astype(np.float32),
        wij=rs.normal(size=(HR, C)).astype(np.float32),
        tij=rs.integers(0, NOW + 1, (HR, C)).astype(np.int32),
        zi=rs.uniform(0, 2, HR).astype(np.float32),
        ei=rs.uniform(0, 0.5, HR).astype(np.float32),
        pi=rs.uniform(1e-4, 0.1, HR).astype(np.float32),
        ti=rs.integers(0, NOW + 1, HR).astype(np.int32))


def row_inputs(seed, n, R, C, A):
    """Slot-ordered worklist: per HCU a few unique rows (HCU n-1 holds the
    plane's last row), the rest sentinel slots (H*R); zj / pj are the
    (n, C) j-vectors, slot s reading HCU s // A's."""
    rs = np.random.default_rng(seed)
    HR, W = n * R, n * A
    rows = np.full(W, HR, np.int32)
    for h in range(n):
        k = rs.integers(1, A)
        r = np.sort(rs.choice(R, size=k, replace=False))
        if h == n - 1:
            r[-1] = R - 1
        rows[h * A:h * A + k] = h * R + r
    valid = rows < HR
    d = _planes(rs, n, R, C)
    d.update(
        rows=rows,
        counts=np.where(valid, rs.integers(1, 4, W), 0).astype(np.float32),
        zj=rs.uniform(0, 2, (n, C)).astype(np.float32),
        p_i=rs.uniform(1e-4, 0.1, W).astype(np.float32),
        pj=rs.uniform(1e-4, 0.1, (n, C)).astype(np.float32),
        zi_new=rs.uniform(0, 3, W).astype(np.float32),
        ei_new=rs.uniform(0, 0.5, W).astype(np.float32),
        pi_new=rs.uniform(1e-4, 0.1, W).astype(np.float32))
    return d


def col_inputs(seed, n, R, C, K=4):
    """Fired batch: HCU n-1 at the last column, HCU 0 at column 3, then
    padding entries (h == n); the i-vectors of the planes (ti up to NOW)
    and an (n, C) pj."""
    rs = np.random.default_rng(seed)
    d = _planes(rs, n, R, C)
    d.update(h_idx=np.array([n - 1, 0] + [n] * (K - 2), np.int32),
             j_idx=np.array([C - 1, 3] + [0] * (K - 2), np.int32),
             pj=rs.uniform(1e-4, 0.1, (n, C)).astype(np.float32))
    return d


def worklist_inputs(seed, n, R, C, A):
    """Unfused worklist, read through the compaction: the slot-ordered
    rows of `row_inputs` (g_row, the H*R sentinel on padding slots) and an
    ``order`` whose first nv entries are the valid slots shuffled (not the
    stable order) plus one padding slot, which must write nothing; the
    entries past nv name random slots, live ones among them, which must
    not be written again. counts / p_i per slot, zj / pj the (n, C)
    j-vectors."""
    rs = np.random.default_rng(seed)
    HR, W = n * R, n * A
    g_row = row_inputs(seed, n, R, C, A)["rows"]
    valid = np.nonzero(g_row < HR)[0]
    pad = np.nonzero(g_row >= HR)[0][:1]
    live = rs.permutation(np.concatenate([valid, pad]))
    nv = live.size
    order = rs.integers(0, W, W).astype(np.int32)
    order[:nv] = live
    d = _planes(rs, n, R, C)
    d.update(g_row=g_row, order=order, nv=np.array([nv], np.int32),
             counts=rs.integers(1, 4, W).astype(np.float32),
             zj=rs.uniform(0, 2, (n, C)).astype(np.float32),
             p_i=rs.uniform(1e-4, 0.1, W).astype(np.float32),
             pj=rs.uniform(1e-4, 0.1, (n, C)).astype(np.float32))
    return d


def worklist_gathered(d):
    """What the JAX engine hands its worklist kernel for the same entries:
    the planes, and per entry i its row g_row[order[i]] (past nv clipped
    into range: in-range junk the kernel must ignore), nv, and the slot's
    counts, p_i and its HCU's zj / pj rows gathered."""
    HR = d["zij"].shape[0]
    W, n = d["order"].shape[0], d["zj"].shape[0]
    order, nv = d["order"], int(d["nv"][0])
    rows = d["g_row"][order]
    rows[nv:] = np.minimum(rows[nv:], HR - 1)
    h_of = order // (W // n)
    out = {f: d[f] for f in COL_PLANES}
    out.update(rows=rows.astype(np.int32), nv=d["nv"],
               counts=d["counts"][order], zj=d["zj"][h_of],
               p_i=d["p_i"][order], pj=d["pj"][h_of])
    return out


def block_inputs(seed, lead, C):
    """Gathered blocks: z, e, p, t of shape (*lead, C)."""
    rs = np.random.default_rng(seed)
    shape = (*lead, C)
    return dict(zij=rs.uniform(0, 2, shape).astype(np.float32),
                eij=rs.uniform(0, 0.5, shape).astype(np.float32),
                pij=rs.uniform(1e-5, 0.05, shape).astype(np.float32),
                tij=rs.integers(0, NOW + 1, shape).astype(np.int32))


def rowblock_inputs(seed, n, R, C, A):
    """Dense row blocks (n, A, C); the last HCU's slots past the first are
    padding (count 0), as dedup_rows leaves them."""
    rs = np.random.default_rng(seed + 100)
    d = block_inputs(seed, (n, A), C)
    counts = rs.integers(1, 4, (n, A)).astype(np.float32)
    counts[-1, 1:] = 0.0
    d.update(counts=counts, zj=rs.uniform(0, 2, (n, C)).astype(np.float32),
             p_i=rs.uniform(1e-4, 0.1, (n, A)).astype(np.float32),
             pj=rs.uniform(1e-4, 0.1, (n, C)).astype(np.float32))
    return d


def colblock_inputs(seed, R, K=4):
    """Gathered columns (K, R) of a fired batch."""
    rs = np.random.default_rng(seed + 100)
    d = block_inputs(seed, (K,), R)
    d.update(zi_t=rs.uniform(0, 3, (K, R)).astype(np.float32),
             p_i=rs.uniform(1e-4, 0.1, (K, R)).astype(np.float32),
             pj_sc=rs.uniform(1e-4, 0.1, K).astype(np.float32))
    return d


def prefixed(d, pre):
    return {f"{pre}_{k}": v for k, v in d.items()}


_JAX_BODY = """
from repro.core.hcu import coeffs_ij, ivec_decay
from repro.core.params import BCPNNParams
from repro.kernels import ops, bcpnn_ref
P = BCPNNParams()
k, eps = coeffs_ij(P), P.eps
NOW = jnp.int32(IN["now"])
ROW = ("zij", "eij", "pij", "wij", "tij", "zi", "ei", "pi", "ti")
COL = ("zij", "eij", "pij", "wij", "tij")

def arg(pre):
    return {n[len(pre) + 1:]: jnp.asarray(v) for n, v in IN.items()
            if n.startswith(pre + "_")}

def per_slot(a):
    # the (n, C) j-vectors gathered per slot, slot s of HCU s // A
    h_of = np.arange(a["rows"].shape[0]) // (a["rows"].shape[0] // a["zj"].shape[0])
    return a["zj"][h_of], a["pj"][h_of]

def prologue(a, n_hcu, R):
    # the column prologue: the entries' i-vectors decayed to NOW, pj by entry
    safe_h = jnp.minimum(a["h_idx"], n_hcu - 1)
    ivr = lambda v: jnp.asarray(v).reshape(n_hcu, R)[safe_h]
    zep = ivec_decay(ivr(a["zi"]), ivr(a["ei"]), ivr(a["pi"]), ivr(a["ti"]),
                     NOW, P)
    return zep.z, zep.p, jnp.asarray(a["pj"])[safe_h, a["j_idx"]]

# Pallas kernels in interpret mode at the small size
a = arg("srow")
zj_s, pj_s = per_slot(a)
flats, ivecs, wrow = ops.fused_row_update(
    *(a[f] for f in ROW), rows=a["rows"], now=NOW, counts=a["counts"],
    zj=zj_s, p_i=a["p_i"], pj=pj_s, zi_new=a["zi_new"],
    ei_new=a["ei_new"], pi_new=a["pi_new"], coeffs=k, eps=eps,
    backend="pallas_interpret")
for f, v in zip(ROW, (*flats, *ivecs)):
    OUT[f"srow_{f}"] = v
OUT["srow_wrow"] = wrow
a = arg("scol")
zi_t, p_i, pj_sc = prologue(a, int(IN["small_n"]), int(IN["small_R"]))
flats = ops.fused_col_update(
    *(a[f] for f in COL), h_idx=a["h_idx"], j_idx=a["j_idx"], now=NOW,
    zi_t=zi_t, p_i=p_i, pj_sc=pj_sc, coeffs=k, eps=eps,
    n_hcu=int(IN["small_n"]), rows=int(IN["small_R"]),
    backend="pallas_interpret")
for f, v in zip(COL, flats):
    OUT[f"scol_{f}"] = v

# the cell oracle at rodent width, one (1, C) row / (R,) column per entry
a = {n: np.array(v) for n, v in arg("rrow").items()}
a["zj"], a["pj"] = per_slot(a)
HR, C = a["zij"].shape
sel = np.nonzero(a["rows"] < HR)[0]
r = a["rows"][sel]
z1, e1, p1, w1, t1 = jax.vmap(
    lambda z, e, p, t, c, zj, pi, pj: bcpnn_ref.row_update_ref(
        z[None], e[None], p[None], t[None], NOW, c[None], zj, pi[None], pj,
        k, eps))(*(jnp.asarray(a[f][r]) for f in ("zij", "eij", "pij", "tij")),
                 *(jnp.asarray(a[f][sel]) for f in ("counts", "zj", "p_i", "pj")))
for f, v in zip(("zij", "eij", "pij", "wij", "tij"), (z1, e1, p1, w1, t1)):
    a[f][r] = np.asarray(v)[:, 0]
a["zi"][r], a["ei"][r], a["pi"][r] = a["zi_new"][sel], a["ei_new"][sel], a["pi_new"][sel]
a["ti"][r] = int(IN["now"])
wrow = np.zeros((a["rows"].shape[0], C), np.float32)
wrow[sel] = np.asarray(w1)[:, 0]
for f in ROW:
    OUT[f"rrow_{f}"] = a[f]
OUT["rrow_wrow"] = wrow

a = {n: np.array(v) for n, v in arg("rcol").items()}
n_hcu, R = int(IN["rodent_n"]), int(IN["rodent_R"])
a["zi_t"], a["p_i"], a["pj_sc"] = (np.asarray(v) for v in
                                   prologue(a, n_hcu, R))
sel = np.nonzero(a["h_idx"] < n_hcu)[0]
ri = a["h_idx"][sel, None] * R + np.arange(R)[None, :]
ci = np.broadcast_to(a["j_idx"][sel, None], ri.shape)
outs = jax.vmap(
    lambda z, e, p, t, zi, pi, pj: bcpnn_ref.col_update_ref(
        z, e, p, t, NOW, zi, pi, pj, k, eps))(
    *(jnp.asarray(a[f][ri, ci]) for f in ("zij", "eij", "pij", "tij")),
    *(jnp.asarray(a[f][sel]) for f in ("zi_t", "p_i", "pj_sc")))
for f, v in zip(COL, outs):
    a[f][ri, ci] = np.asarray(v)
for f in COL:
    OUT[f"rcol_{f}"] = a[f]

# unfused worklist: the Pallas kernel (small) and the cell oracle (rodent),
# on the per-entry arrays the JAX engine gathers
a = arg("swlj")
flats = ops.worklist_row_update(
    *(a[f] for f in COL), rows=a["rows"], nv=a["nv"][0], now=NOW,
    counts=a["counts"], zj=a["zj"], p_i=a["p_i"], pj=a["pj"], coeffs=k,
    eps=eps, backend="pallas_interpret")
for f, v in zip(COL, flats):
    OUT[f"swl_{f}"] = v
a = {n: np.array(v) for n, v in arg("rwlj").items()}
live = (np.arange(a["rows"].shape[0]) < a["nv"][0]) & (
    a["rows"] < a["zij"].shape[0])
r = a["rows"][live]
z1, e1, p1, w1, t1 = jax.vmap(
    lambda z, e, p, t, c, zj, pi, pj: bcpnn_ref.row_update_ref(
        z[None], e[None], p[None], t[None], NOW, c[None], zj, pi[None], pj,
        k, eps))(*(jnp.asarray(a[f][r]) for f in ("zij", "eij", "pij", "tij")),
                 *(jnp.asarray(a[f][live]) for f in ("counts", "zj", "p_i", "pj")))
for f, v in zip(COL, (z1, e1, p1, w1, t1)):
    a[f][r] = np.asarray(v)[:, 0]
    OUT[f"rwl_{f}"] = a[f]

# dense row blocks and gathered columns: the Pallas kernels vmapped as the
# engine vmaps them (small), the cell oracle (rodent)
BLK = ("zij", "eij", "pij", "wij", "tij")
for pre, backend in (("srb", "pallas_interpret"), ("rrb", "ref")):
    a = arg(pre)
    outs = jax.vmap(lambda z, e, p, t, c, zj, pi, pj: ops.row_update(
        z, e, p, t, NOW, c, zj, pi, pj, k, eps, backend=backend,
        wij=jnp.zeros_like(z)))(
        *(a[f] for f in ("zij", "eij", "pij", "tij", "counts", "zj", "p_i",
                         "pj")))
    for f, v in zip(BLK, outs):
        OUT[f"{pre}_{f}"] = v
for pre, backend in (("scb", "pallas_interpret"), ("rcb", "ref")):
    a = arg(pre)
    outs = jax.vmap(lambda z, e, p, t, zi, pi, pj: ops.col_update(
        z, e, p, t, NOW, zi, pi, pj, k, eps, backend=backend,
        w_col=jnp.zeros_like(z)))(
        *(a[f] for f in ("zij", "eij", "pij", "tij", "zi_t", "p_i", "pj_sc")))
    for f, v in zip(BLK, outs):
        OUT[f"{pre}_{f}"] = v
"""


@pytest.fixture(scope="module")
def cases():
    ins = {"srow": row_inputs(1, **SMALL),
           "scol": col_inputs(2, SMALL["n"], SMALL["R"], SMALL["C"]),
           "rrow": row_inputs(3, **RODENT),
           "rcol": col_inputs(4, RODENT["n"], RODENT["R"], RODENT["C"], K=3),
           "swl": worklist_inputs(11, **SMALL),
           "rwl": worklist_inputs(12, **RODENT),
           "srb": rowblock_inputs(13, **SMALL),
           "rrb": rowblock_inputs(14, **RODENT),
           "scb": colblock_inputs(15, SMALL["R"]),
           "rcb": colblock_inputs(16, RODENT["R"], K=3)}
    flat = {"now": np.int32(NOW), "small_n": SMALL["n"], "small_R": SMALL["R"],
            "rodent_n": RODENT["n"], "rodent_R": RODENT["R"]}
    for pre in ("swl", "rwl"):
        ins[pre + "j"] = worklist_gathered(ins[pre])
    for pre, d in ins.items():
        flat.update(prefixed(d, pre))
    return ins, run_jax(_JAX_BODY, flat)


def _t(d, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def _stored(d, device, lay):
    """The inputs as tensors, the planes stored in ``lay`` (None: flat)."""
    a = _t(d, device)
    if lay is not None:
        a.update({f: lay.store(a[f]) for f in COL_PLANES})
    return a


def _loaded(a, lay, names):
    """The outputs in flat order (planes unpacked from ``lay``)."""
    return {f: lay.load(a[f]) if lay is not None and f in COL_PLANES
            else a[f] for f in names}


def _shifted(t, floats):
    """A copy of t whose data starts ``floats`` 4-byte words past an
    allocation's (aligned) start."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    out = buf[floats:].view(t.shape)
    out.copy_(t)
    return out


def run_row(d, device="cpu", fn=None, lay=None, shift=()):
    """The fused row phase on ``d``; the operands named in ``shift`` start
    8 bytes past an aligned address."""
    a = _stored(d, device, lay)
    a.update({f: _shifted(a[f], 2) for f in shift})
    p = BCPNNParams()
    wrow = (fn or ops.fused_row_update)(
        *(a[f] for f in ROW_PLANES), a["rows"], torch.tensor(NOW, dtype=torch.int32, device=device),
        a["counts"], a["zj"], a["p_i"], a["pj"], a["zi_new"], a["ei_new"],
        a["pi_new"], TH.coeffs_ij(p), p.eps, layout=lay)
    out = _loaded(a, lay, ROW_PLANES)
    out["wrow"] = wrow
    return out


def run_col(d, n, R, device="cpu", fn=None, lay=None):
    a = _stored(d, device, lay)
    p = BCPNNParams()
    (fn or ops.fused_col_update)(
        *(a[f] for f in ROW_PLANES), a["pj"], a["h_idx"], a["j_idx"],
        torch.tensor(NOW, dtype=torch.int32, device=device),
        TH.coeffs_ij(p), TH.coeffs_i(p), p.eps, n, R, layout=lay)
    return _loaded(a, lay, ROW_PLANES)


def run_worklist(d, device="cpu", fn=None, lay=None):
    a = _stored(d, device, lay)
    p = BCPNNParams()
    now = torch.tensor(NOW, dtype=torch.int32, device=device)
    if fn is None:
        ops.worklist_row_update(*(a[f] for f in COL_PLANES), a["g_row"],
                                a["order"], a["nv"], now, a["counts"],
                                a["zj"], a["p_i"], a["pj"], TH.coeffs_ij(p),
                                p.eps, layout=lay)
    else:
        fn(*(a[f] for f in COL_PLANES), a["g_row"], a["order"], a["nv"],
           now.reshape(1), a["counts"], a["zj"], a["p_i"], a["pj"],
           TH.coeffs_ij(p), p.eps, layout=lay)
    return _loaded(a, lay, COL_PLANES)


def run_rowblock(d, device="cpu", fn=None):
    a = _t(d, device)
    p = BCPNNParams()
    now = torch.tensor([NOW], dtype=torch.int32, device=device)
    outs = (fn or ops.row_update)(
        a["zij"], a["eij"], a["pij"], a["tij"], now, a["counts"], a["zj"],
        a["p_i"], a["pj"], TH.coeffs_ij(p), p.eps)
    return dict(zip(COL_PLANES, outs))


def run_colblock(d, device="cpu", fn=None):
    a = _t(d, device)
    p = BCPNNParams()
    now = torch.tensor([NOW], dtype=torch.int32, device=device)
    outs = (fn or ops.col_update)(
        a["zij"], a["eij"], a["pij"], a["tij"], now, a["zi_t"], a["p_i"],
        a["pj_sc"], TH.coeffs_ij(p), p.eps)
    return dict(zip(COL_PLANES, outs))


RUNS = {"wl": run_worklist, "rb": run_rowblock, "cb": run_colblock}


def assert_outputs(got, want, names):
    for f in names:
        g = got[f].cpu().numpy() if torch.is_tensor(got[f]) else got[f]
        w = want[f]
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            atol = 1e-5 if f in ("wij", "wrow") else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=f)


@pytest.fixture(autouse=True)
def _flush_denormal():
    # XLA flushes denormals to zero; torch on the CPU keeps them unless told.
    # The mode is per process and off by default: switch it back off so the
    # tests that share this worker see the default.
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("case", ["srow", "rrow"])
def test_fused_row_update_matches_jax(cases, case):
    ins, ref = cases
    got = run_row(ins[case])
    want = {f: ref[f"{case}_{f}"] for f in (*ROW_PLANES, "wrow")}
    assert_outputs(got, want, (*ROW_PLANES, "wrow"))
    # sentinel slots emit zero weight rows and leave every plane row alone
    assert not got["wrow"][ins[case]["rows"] >= ins[case]["zij"].shape[0]].any()


@pytest.mark.parametrize("case", ["scol", "rcol"])
def test_fused_col_update_matches_jax(cases, case):
    ins, ref = cases
    dims = SMALL if case == "scol" else RODENT
    got = run_col(ins[case], dims["n"], dims["R"])
    assert_outputs(got, {f: ref[f"{case}_{f}"] for f in COL_PLANES}, COL_PLANES)
    # only the valid entries' columns changed, and no i-vector
    changed = (got["tij"].numpy() != ins[case]["tij"]).any(axis=0)
    assert changed.sum() <= 2
    for f in ("zi", "ei", "pi", "ti"):
        np.testing.assert_array_equal(got[f].numpy(), ins[case][f], err_msg=f)


TILES = [(8, 4), (7, 5)]
tile_id = lambda t: f"{t[0]}x{t[1]}"


def _blocked(dims, tile):
    from repro_torch.core.layout import BlockedLayout
    return BlockedLayout(dims["R"], dims["C"], *tile)


@pytest.mark.parametrize("tile", TILES, ids=tile_id)
@pytest.mark.parametrize("case", ["srow", "rrow", "scol", "rcol", "swl",
                                  "rwl"])
def test_worklist_updates_on_blocked_planes_match_jax(cases, case, tile):
    """The three worklist entries on planes stored column-blocked, against
    the same JAX results as their flat runs: the layout is storage order,
    not math. Pad cells stay as `store` left them (zero)."""
    ins, ref = cases
    dims = SMALL if case[0] == "s" else RODENT
    lay = _blocked(dims, tile)
    if case[1:] == "row":
        got = run_row(ins[case], lay=lay)
        names = (*ROW_PLANES, "wrow")
    elif case[1:] == "col":
        got = run_col(ins[case], dims["n"], dims["R"], lay=lay)
        names = COL_PLANES
    else:
        got = run_worklist(ins[case], lay=lay)
        names = COL_PLANES
    assert_outputs(got, {f: ref[f"{case}_{f}"] for f in names}, names)


@pytest.mark.parametrize("case", ["swl", "rwl", "srb", "rrb", "scb", "rcb"])
def test_unfused_and_block_updates_match_jax(cases, case):
    """`ops.worklist_row_update`, `ops.row_update` and `ops.col_update`
    on the CPU against the Pallas kernels (s*) and the cell oracle (r*)."""
    ins, ref = cases
    got = RUNS[case[1:]](ins[case])
    assert_outputs(got, {f: ref[f"{case}_{f}"] for f in COL_PLANES},
                   COL_PLANES)


def test_worklist_entries_past_nv_write_nothing(cases):
    d = cases[0]["rwl"]
    got = run_worklist(d)
    nv = int(d["nv"][0])
    touched = (got["tij"].numpy() != d["tij"]).any(axis=1)
    untouched = np.setdiff1d(np.arange(d["zij"].shape[0]),
                             d["g_row"][d["order"][:nv]])
    assert not touched[untouched].any()
    for f in COL_PLANES:
        np.testing.assert_array_equal(got[f].numpy()[untouched],
                                      d[f][untouched], err_msg=f)


@pytest.mark.parametrize("tile", [None] + TILES,
                         ids=lambda t: "flat" if t is None else tile_id(t))
def test_unfused_rows_equal_fused_rows_bit_for_bit(tile):
    """`engine.worklist_lazy_rows(fused=False)` (the unfused entry, read
    through the compaction) against fused=True on one random state of a
    small network and a spike batch with duplicates and padding, flat and
    blocked: every HCU leaf and the weight rows bit for bit, as the JAX
    engine's docstring promises ("both give the same bits")."""
    from repro_torch.core import engine as E
    from repro_torch.core.layout import store_hcus
    from repro_torch.core.params import test_scale
    p = test_scale(4, 64, 16)
    rs = np.random.default_rng(30)
    rand = lambda t: torch.from_numpy(
        rs.integers(0, NOW, t.shape).astype(np.int32)
        if t.dtype == torch.int32
        else rs.uniform(1e-4, 0.5, t.shape).astype(np.float32))
    base = TH.HCUState(*(rand(t) for t in TH.init_hcu_batch(p, p.n_hcu,
                                                            "cpu")))
    lay = None if tile is None else _blocked(dict(R=p.rows, C=p.cols), tile)
    base = store_hcus(base, lay)
    rows = torch.from_numpy(rs.integers(0, p.rows + 1, (p.n_hcu, 12))
                            .astype(np.int32))
    rows[0, :4] = 5                          # duplicates merge into one slot
    rows[-1] = p.rows                        # an HCU with no spike at all
    now = torch.tensor(NOW, dtype=torch.int32)
    out = {}
    for fused in (True, False):
        hc = TH.HCUState(*(t.clone() for t in base))
        hc, w_rows, _ = E.worklist_lazy_rows(hc, rows, now, p, fused=fused,
                                             layout=lay)
        out[fused] = (*hc, w_rows)
    for f, a, b in zip((*TH.HCUState._fields, "w_rows"), out[True],
                       out[False]):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert not torch.equal(out[False][4], base.tij)   # rows were written


# (layout: ("flat", C) or an (xr, xc) tile at R=64, C=16; the operands
# moved off an aligned address ("zj": a j-vector, "eij": one plane,
# "planes": all five) and by how many bytes; the segment the walk takes)
SEGMENTS = [(("flat", 70), "zj", 0, 8), (("flat", 100), "zj", 0, 16),
            (("flat", 71), "zj", 0, 4), (("flat", 16), "zj", 0, 16),
            (("flat", 200), "zj", 0, 16), ((8, 4), "zj", 0, 16),
            ((7, 5), "zj", 0, 4), ((8, 2), "zj", 0, 4),
            (("flat", 70), "zj", 4, 4), (("flat", 100), "zj", 4, 4),
            (("flat", 100), "zj", 8, 8), ((8, 4), "zj", 8, 4),
            (("flat", 100), "eij", 8, 4), (("flat", 70), "planes", 8, 8),
            (("flat", 126), "zj", 0, 8), (("flat", 198), "zj", 0, 4)]


@pytest.mark.parametrize(
    "lay, moved, offset, want", SEGMENTS,
    ids=lambda v: (f"{v[0]}{v[1]}" if isinstance(v, tuple) else str(v)))
def test_row_segment_bytes_follows_geometry_and_alignment(lay, moved, offset,
                                                          want):
    """The row kernels' segment width: 16 bytes where tiles and rows split
    into 4-cell segments and every operand is 16-byte aligned; 8 where a
    row is one contiguous run of an even C <= 126, every operand is 8-byte
    aligned and the planes are alike modulo 16 bytes (an (8, 2) tile, C =
    198 or one plane 8 bytes off the others take 4); else 4. One
    misaligned operand narrows the walk of the whole launch."""
    from repro_torch.core.layout import BlockedLayout, FlatLayout
    geom = (FlatLayout(64, lay[1]) if lay[0] == "flat"
            else BlockedLayout(64, 16, *lay))
    n = 64 * geom.cols

    def operand(off):
        t = torch.zeros(n + 4)
        assert t.data_ptr() % 16 == 0
        return t[off // 4:off // 4 + n]
    planes = [operand(offset if moved == "planes" or (moved == "eij"
                                                      and i == 1) else 0)
              for i in range(5)]
    vecs = [operand(offset if moved == "zj" else 0), operand(0)]
    assert BU._row_segment_bytes(geom, planes, vecs) == want


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [SMALL, RODENT], ids=["small", "rodent"])
def test_cuda_row_kernel_matches_plain(dims):
    dev = _cuda()
    d = row_inputs(5, **dims)
    before = BU.launches["fused_row_update"]
    got = run_row(d, dev, BU.fused_row_update_kernel)
    torch.cuda.synchronize()
    assert BU.launches["fused_row_update"] == before + 1
    want = run_row(d, dev, BU.fused_row_update_plain)
    assert_outputs(got, {k: v.cpu().numpy() for k, v in want.items()},
                   (*ROW_PLANES, "wrow"))


def _sentinel_hcu(d, h, A, HR):
    """HCU h's slots all sentinel: no row, count or weight row."""
    d["rows"][h * A:(h + 1) * A] = HR
    d["counts"][h * A:(h + 1) * A] = 0.0
    return d


def _both_phases(d, n, R, A):
    """HCU 0's live slots on rows 0, 1, 2, 5 and HCU 1's on rows R - 2,
    R - 1 (the plane's last row when n == 2): rows that start on a 16-byte
    boundary and rows that start 8 bytes past one, where C * 4 is 8 modulo
    16."""
    for h, rs in ((0, (0, 1, 2, 5)), (1, (R - 2, R - 1))):
        d["rows"][h * A:(h + 1) * A] = n * R
        d["rows"][h * A:h * A + len(rs)] = [h * R + r for r in rs]
        d["counts"][h * A:(h + 1) * A] = 0.0
        d["counts"][h * A:h * A + len(rs)] = 2.0
    return d


# (dims, tile, how the worklist is edited, the operands shifted by 8 bytes,
# the segment bytes the walk takes)
ROW_WALKS = {
    "c70-phases": (dict(n=2, R=40, C=70, A=8), None, _both_phases, (), 8),
    "c70-sentinel-hcu": (dict(n=3, R=40, C=70, A=8), None,
                         lambda d, n, R, A: _sentinel_hcu(d, 1, A, n * R),
                         (), 8),
    "c66": (dict(n=3, R=40, C=66, A=8), None, None, (), 8),
    "c198": (dict(n=2, R=40, C=198, A=8), None, _both_phases, (), 4),
    "c71": (dict(n=3, R=40, C=71, A=8), None, None, (), 4),
    "tile8x2": (dict(n=3, R=40, C=16, A=8), (8, 2), None, (), 4),
    "c100-zj-shifted": (dict(n=3, R=40, C=100, A=8), None, _both_phases,
                        ("zj",), 8),
    "c100-plane-shifted": (dict(n=3, R=40, C=100, A=8), None, _both_phases,
                           ("eij",), 4),
    "c70-planes-shifted": (dict(n=2, R=40, C=70, A=8), None, _both_phases,
                           ROW_PLANES[:5], 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROW_WALKS))
def test_cuda_row_kernel_walks_match_plain(case):
    """The fused row kernel bit for bit its plain version on rows that take
    the 8-byte walk (C = 70 with live rows in both 16-byte phases and the
    plane's last row, then with every plane 8 bytes off; an HCU of sentinel
    slots only; C = 66; C = 100 with Zj 8 bytes off the 16-byte alignment
    of the others) and the single-cell walk (C = 71; C = 198, over 126
    cells; an (8, 2) tile; C = 100 with one plane 8 bytes off the others),
    with `row_walks` counting the launch under its width."""
    dev = _cuda()
    dims, tile, edit, shift, seg = ROW_WALKS[case]
    n, R, C, A = (dims[k] for k in ("n", "R", "C", "A"))
    d = row_inputs(24, n, R, C, A)
    if edit is not None:
        d = edit(d, n, R, A)
    lay = None if tile is None else _blocked(dims, tile)
    before = dict(BU.row_walks)
    got = run_row(d, dev, BU.fused_row_update_kernel, lay=lay, shift=shift)
    torch.cuda.synchronize()
    assert BU.row_walks == {k: v + (k == seg) for k, v in before.items()}
    want = run_row(d, dev, BU.fused_row_update_plain, lay=lay)
    for f in (*ROW_PLANES, "wrow"):
        assert torch.equal(got[f], want[f]), f


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [SMALL, RODENT], ids=["small", "rodent"])
def test_cuda_col_kernel_matches_plain(dims):
    dev = _cuda()
    d = col_inputs(6, dims["n"], dims["R"], dims["C"])
    got = run_col(d, dims["n"], dims["R"], dev, BU.fused_col_update_kernel)
    torch.cuda.synchronize()
    want = run_col(d, dims["n"], dims["R"], dev, BU.fused_col_update_plain)
    assert_outputs(got, {k: v.cpu().numpy() for k, v in want.items()},
                   COL_PLANES)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES + [(8, 128), (32, 4)], ids=tile_id)
@pytest.mark.parametrize("dims", [SMALL, RODENT], ids=["small", "rodent"])
@pytest.mark.parametrize("kind", ["fused_row_update", "fused_col_update",
                                  "worklist_row_update"])
def test_cuda_worklist_kernels_on_blocked_planes_match_plain(kind, dims,
                                                             tile):
    """Each worklist kernel against its plain version on planes stored
    column-blocked (compared after unpacking), on tiles of whole 4-cell
    segments ((8, 4), (32, 4), (8, 128) at C=16) and a scalar one (7, 5)."""
    dev = _cuda()
    n, R, C, A = (dims[k] for k in ("n", "R", "C", "A"))
    lay = _blocked(dims, tile)
    d, run, names = {
        "fused_row_update": (row_inputs(20, n, R, C, A), run_row,
                             (*ROW_PLANES, "wrow")),
        "fused_col_update": (col_inputs(21, n, R, C), lambda *a, **k:
                             run_col(a[0], n, R, *a[1:], **k), ROW_PLANES),
        "worklist_row_update": (worklist_inputs(22, n, R, C, A),
                                run_worklist, COL_PLANES)}[kind]
    before = BU.launches[kind]
    got = run(d, dev, getattr(BU, f"{kind}_kernel"), lay=lay)
    torch.cuda.synchronize()
    assert BU.launches[kind] == before + 1
    want = run(d, dev, getattr(BU, f"{kind}_plain"), lay=lay)
    assert_outputs(got, {k: v.cpu().numpy() for k, v in want.items()}, names)


# phase 3's tiles of chip_smoke.py, and rows of more than 128 cells
WL_TILES = [None, (2, 4), (4, 4), (8, 4), (16, 4), (32, 4), (7, 5), (8, 128)]
WIDE = dict(n=2, R=48, C=200, A=8)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", WL_TILES,
                         ids=lambda t: "flat" if t is None else tile_id(t))
@pytest.mark.parametrize("dims", [SMALL, RODENT, WIDE],
                         ids=["small", "rodent", "wide"])
def test_cuda_worklist_row_kernel_on_every_tile_matches_plain(dims, tile):
    """The unfused row kernel, read through the compaction, bit for bit its
    plain version on every tile phase 3 times (16-byte segments where a
    row splits into whole 4-cell groups, single cells elsewhere), and on
    rows of 200 cells (two rounds of 128 columns)."""
    dev = _cuda()
    n, R, C, A = (dims[k] for k in ("n", "R", "C", "A"))
    lay = None if tile is None else _blocked(dims, tile)
    d = worklist_inputs(23, n, R, C, A)
    before = BU.launches["worklist_row_update"]
    got = run_worklist(d, dev, BU.worklist_row_update_kernel, lay=lay)
    torch.cuda.synchronize()
    assert BU.launches["worklist_row_update"] == before + 1
    want = run_worklist(d, dev, BU.worklist_row_update_plain, lay=lay)
    for f in COL_PLANES:
        assert torch.equal(got[f], want[f]), f


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [SMALL, RODENT], ids=["small", "rodent"])
@pytest.mark.parametrize("kind", ["worklist_row_update", "row_update",
                                  "col_update"])
def test_cuda_unfused_and_block_kernels_match_plain(kind, dims):
    dev = _cuda()
    n, R, C, A = (dims[k] for k in ("n", "R", "C", "A"))
    d, run = {"worklist_row_update": (worklist_inputs(17, n, R, C, A),
                                      run_worklist),
              "row_update": (rowblock_inputs(18, n, R, C, A), run_rowblock),
              "col_update": (colblock_inputs(19, R), run_colblock)}[kind]
    before = BU.launches[kind]
    got = run(d, dev, getattr(BU, f"{kind}_kernel"))
    torch.cuda.synchronize()
    assert BU.launches[kind] == before + 1
    want = run(d, dev, getattr(BU, f"{kind}_plain"))
    assert_outputs(got, {k: v.cpu().numpy() for k, v in want.items()},
                   COL_PLANES)


def _no_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")
    for kind in BU.launches:
        monkeypatch.setattr(BU, f"{kind}_plain", plain)


NEW_RUNS = ((run_worklist, worklist_inputs), (run_rowblock, rowblock_inputs))


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """Tensors on the meta device go to the kernel wrapper, which refuses
    them; the plain version is never called."""
    _no_plain(monkeypatch)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_row(row_inputs(7, **SMALL), "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_col(col_inputs(8, SMALL["n"], SMALL["R"], SMALL["C"]),
                SMALL["n"], SMALL["R"], "meta")
    for run, inputs in NEW_RUNS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            run(inputs(9, **SMALL), "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_colblock(colblock_inputs(10, SMALL["R"]), "meta")


@pytest.mark.cuda
def test_cuda_launch_failure_propagates(monkeypatch):
    """On CUDA tensors ops launches the kernel or raises: a failing
    launcher's error reaches the caller, with no retry on the plain path."""
    dev = _cuda()
    _no_plain(monkeypatch)

    def broken():
        raise RuntimeError("launcher unavailable")
    monkeypatch.setattr(BU, "_lib", broken)
    with pytest.raises(RuntimeError, match="launcher unavailable"):
        run_row(row_inputs(9, **SMALL), dev)
    with pytest.raises(RuntimeError, match="launcher unavailable"):
        run_col(col_inputs(10, SMALL["n"], SMALL["R"], SMALL["C"]),
                SMALL["n"], SMALL["R"], dev)
    for run, inputs in NEW_RUNS:
        with pytest.raises(RuntimeError, match="launcher unavailable"):
            run(inputs(11, **SMALL), dev)
    with pytest.raises(RuntimeError, match="launcher unavailable"):
        run_colblock(colblock_inputs(12, SMALL["R"]), dev)
