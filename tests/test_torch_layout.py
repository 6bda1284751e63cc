"""The port's plane layouts (`repro_torch.core.layout`) against the JAX
package's `repro.core.layout`, which runs in a child process.

* `BlockedLayout.store` / `load` give the JAX package's arrays bit for bit
  (tiles (8, 4), (7, 5), (8, 128) and the flat point (1, C), at a size
  where rows and columns need padding), and per HCU they equal
  `RowMergeLayout.pack` of both packages.
* Every accessor: the port's index maps (`cell_index`, `row_index`,
  `col_index`) read what JAX's `read_row` / `read_col` read, and the
  port's writes (`write_row`, `stamp_row`, `write_col`, `stamp_col`,
  `add_cell`) leave the logical cells JAX's leave, and no pad cell
  written (JAX's row and column writes fill the pad cells they cross).
* The degenerate point's row-padded view (`flat_view`, `pad_row_index`,
  `pad_ivec`, `unpad_ivec`).
* The cost models (`dram_row_misses_per_s`, `paper_fig10_table`,
  `tile_bytes_touched_per_s`, `best_tile`, `cache_lines_touched_per_s`,
  the last also at the H100's 32-byte sectors) equal the JAX package's.
* `layout_tag` / `layout_from_tag`, `resolve_layout`, `store_hcus` /
  `load_hcus` / `convert_hcus`.

Everything is data movement or integer arithmetic, so every comparison is
exact.
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.core import layout as L
from repro_torch.core.hcu import init_hcu_batch
from repro_torch.core.params import test_scale as tiny_scale

H, R, C = 3, 60, 18
TILES = {"8x4": (8, 4), "7x5": (7, 5), "8x128": (8, 128), "flat": (1, C)}
ROWS_G = [0, 7, R - 1, R, 2 * R + 33, H * R - 1]          # global rows
COLS_HJ = [(0, 0), (1, 5), (2, C - 1), (1, 16)]            # (hcu, column)
CELL = (2, 45, 13)
COST_GRID = [(xr, xc, line) for xr in (1, 2, 8, 16, 32) for xc in
             (1, 2, 4, 8, 100) for line in (32, 64)]

_BODY = """
from repro.core import layout as JL
f = jnp.asarray(IN["plane"])
H, R, C = (int(IN[k]) for k in ("H", "R", "C"))
val_row, val_col = jnp.asarray(IN["val_row"]), jnp.asarray(IN["val_col"])
h0, r0, j0 = (int(v) for v in IN["cell"])
for name, (xr, xc) in zip(IN["tile_names"], IN["tiles"]):
    lay = JL.BlockedLayout(R, C, int(xr), int(xc))
    s = lay.store(f)
    OUT[f"{name}_store"] = s
    OUT[f"{name}_load"] = lay.load(s)
    rm = JL.RowMergeLayout(R, C, int(xr), int(xc))
    OUT[f"{name}_pack"] = jnp.concatenate([rm.pack(f[h * R:(h + 1) * R])
                                           for h in range(H)])
    for g in IN["rows_g"]:
        OUT[f"{name}_row_{g}"] = lay.read_row(s, int(g))
    for h, j in IN["cols_hj"]:
        OUT[f"{name}_col_{h}_{j}"] = lay.read_col(s, int(h), int(j))
    w = lay.write_row(s, int(IN["rows_g"][2]), val_row)
    w = lay.stamp_row(w, int(IN["rows_g"][4]), 7.0)
    w = lay.write_col(w, 1, 5, val_col)
    w = lay.stamp_col(w, 2, C - 1, -3.0)
    OUT[f"{name}_writes"] = lay.add_cell(w, h0, r0, j0, 0.5)
flat = JL.FlatLayout(rows=R)
w = flat.write_row(f, int(IN["rows_g"][2]), val_row)
w = flat.stamp_row(w, int(IN["rows_g"][4]), 7.0)
w = flat.write_col(w, 1, 5, val_col)
w = flat.stamp_col(w, 2, C - 1, -3.0)
OUT["flatlayout_writes"] = flat.add_cell(w, h0, r0, j0, 0.5)
for h, j in IN["cols_hj"]:
    OUT[f"flatlayout_col_{h}_{j}"] = flat.read_col(f, int(h), int(j))
deg = JL.BlockedLayout(R, C, 8, 128)
OUT["deg_view"] = deg.flat_view(deg.store(f))
OUT["deg_pad_rows"] = deg.pad_row_index(jnp.asarray(IN["g_all"]), H)
OUT["deg_pad_ivec"] = deg.pad_ivec(jnp.asarray(IN["ivec"]), H)
OUT["deg_unpad_ivec"] = deg.unpad_ivec(OUT["deg_pad_ivec"], H)
OUT["fig10"] = np.array(list(JL.paper_fig10_table().items()))
OUT["dram"] = np.array([JL.dram_row_misses_per_s(x, 1000, 40, 300.0, 7.0)
                        for x in (1, 2, 4, 5, 8, 10, 20, 40)])
best, scored = JL.best_tile(10_000, 100, 10_000.0, 100.0)
OUT["best"] = np.array(best)
OUT["scored"] = np.array([[*c, v] for c, v in scored.items()])
best, scored = JL.best_tile(10_000, 100, 3584.0, 26.0,
                           candidates=tuple(map(tuple, IN["cands"])))
OUT["best_h100"] = np.array(best)
OUT["tile_bytes"] = np.array([JL.tile_bytes_touched_per_s(
    int(a), int(b), 10_000, 100, 3584.0, 26.0) for a, b, _ in IN["grid"]])
OUT["lines"] = np.array([JL.cache_lines_touched_per_s(
    int(a), int(b), 10_000, 100, 3584.0, 26.0, line_bytes=int(l))
    for a, b, l in IN["grid"]])
OUT["tags"] = np.array([JL.layout_tag(None), JL.layout_tag(JL.FlatLayout()),
                        JL.layout_tag(JL.BlockedLayout(R, C, 8, 4)),
                        JL.layout_tag(JL.BlockedLayout(R, C, 7, 5))])
"""


def _inputs():
    rs = np.random.default_rng(0)
    return dict(
        plane=rs.normal(size=(H * R, C)).astype(np.float32),
        val_row=rs.normal(size=(1, C)).astype(np.float32),
        val_col=rs.normal(size=(1, R)).astype(np.float32),
        ivec=rs.normal(size=H * R).astype(np.float32),
        H=np.int64(H), R=np.int64(R), C=np.int64(C), cell=np.array(CELL),
        tile_names=np.array(list(TILES)), tiles=np.array(list(TILES.values())),
        rows_g=np.array(ROWS_G), cols_hj=np.array(COLS_HJ),
        g_all=np.array([0, R - 1, R, 2 * R + 5, H * R], np.int32),
        cands=np.array([(1, 100), (8, 4), (16, 4), (32, 4), (8, 2), (8, 8)]),
        grid=np.array(COST_GRID))


@pytest.fixture(scope="module")
def ref():
    return _inputs(), run_jax(_BODY, _inputs())


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _layout(name):
    return L.BlockedLayout(R, C, *TILES[name])


@pytest.mark.parametrize("name", list(TILES))
def test_store_and_load_match_jax(ref, name):
    ins, out = ref
    lay = _layout(name)
    f = torch.from_numpy(ins["plane"])
    s = lay.store(f)
    assert tuple(s.shape) == lay.plane_shape(H)
    _eq(s, out[f"{name}_store"], "store")
    _eq(lay.load(s), out[f"{name}_load"], "load")
    _eq(lay.load(s), ins["plane"], "round trip")
    rm = L.RowMergeLayout(R, C, *TILES[name])
    packed = torch.cat([rm.pack(f[h * R:(h + 1) * R]) for h in range(H)])
    _eq(packed, out[f"{name}_pack"], "RowMergeLayout.pack")
    _eq(s, packed, "per-HCU pack")
    _eq(torch.cat([rm.unpack(packed[h * lay.row_tiles_n:
                                    (h + 1) * lay.row_tiles_n])
                   for h in range(H)]), ins["plane"], "unpack")
    tr, tcs = rm.row_tiles(R - 1)
    assert tr == (R - 1) // rm.xr
    _eq(tcs, torch.arange(lay.col_tiles_n), "row_tiles")
    trs, tc = rm.col_tiles(C - 1)
    assert tc == (C - 1) // rm.xc
    _eq(trs, torch.arange(lay.row_tiles_n), "col_tiles")


@pytest.mark.parametrize("name", list(TILES))
def test_index_maps_read_what_jax_reads(ref, name):
    ins, out = ref
    lay = _layout(name)
    s = lay.store(torch.from_numpy(ins["plane"]))
    for g in ROWS_G:
        _eq(lay.read_row(s, g), out[f"{name}_row_{g}"], f"row {g}")
        _eq(L.FlatLayout(R, C).read_row(torch.from_numpy(ins["plane"]), g),
            out[f"{name}_row_{g}"], f"flat row {g}")
    _eq(lay.read_row(s, torch.tensor(ROWS_G)),
        np.concatenate([out[f"{name}_row_{g}"] for g in ROWS_G]), "rows")
    for h, j in COLS_HJ:
        _eq(lay.read_col(s, h, j), out[f"{name}_col_{h}_{j}"], f"col {h} {j}")
    # the index maps address every logical cell once, and no pad cell
    h, r, j = np.meshgrid(np.arange(H), np.arange(R), np.arange(C),
                          indexing="ij")
    idx = lay.cell_index(torch.from_numpy(h), torch.from_numpy(r),
                         torch.from_numpy(j)).reshape(-1)
    assert idx.unique().numel() == H * R * C
    _eq(s.reshape(-1)[idx].reshape(H * R, C), ins["plane"], "cell_index")
    g = torch.arange(H * R)
    _eq(lay.row_index(g), idx.reshape(H * R, C), "row_index")


@pytest.mark.parametrize("name", [*TILES, "flatlayout"])
def test_writes_leave_what_jax_leaves(ref, name):
    ins, out = ref
    lay = L.FlatLayout(R, C) if name == "flatlayout" else _layout(name)
    s = lay.store(torch.from_numpy(ins["plane"]).clone())
    lay.write_row(s, ROWS_G[2], torch.from_numpy(ins["val_row"]))
    lay.stamp_row(s, ROWS_G[4], 7.0)
    lay.write_col(s, 1, 5, torch.from_numpy(ins["val_col"]))
    lay.stamp_col(s, 2, C - 1, -3.0)
    lay.add_cell(s, *CELL, 0.5)
    want = torch.from_numpy(out[f"{name}_writes"])
    _eq(lay.load(s), lay.load(want), "logical cells")
    # JAX's row and column writes also fill the pad cells they cross; the
    # port's write logical cells only, so its pad cells keep store's zeros
    if name != "flatlayout":
        pad = torch.ones(s.numel(), dtype=torch.bool)
        pad[lay.row_index(torch.arange(H * R)).reshape(-1)] = False
        assert not s.reshape(-1)[pad].any()
    else:
        for h, j in COLS_HJ:
            _eq(lay.read_col(torch.from_numpy(ins["plane"]), h, j),
                out[f"flatlayout_col_{h}_{j}"], f"col {h} {j}")


def test_degenerate_row_padded_view_matches_jax(ref):
    ins, out = ref
    lay = _layout("8x128")
    assert lay.tpu_degenerate and not _layout("8x4").tpu_degenerate
    view = lay.flat_view(lay.store(torch.from_numpy(ins["plane"])))
    _eq(view, out["deg_view"], "flat_view")
    _eq(lay.from_flat_view(view), out["8x128_store"], "from_flat_view")
    _eq(lay.pad_row_index(torch.from_numpy(ins["g_all"]), H),
        out["deg_pad_rows"], "pad_row_index")
    padded = lay.pad_ivec(torch.from_numpy(ins["ivec"]), H)
    _eq(padded, out["deg_pad_ivec"], "pad_ivec")
    _eq(lay.unpad_ivec(padded, H), out["deg_unpad_ivec"], "unpad_ivec")
    with pytest.raises(ValueError):
        _layout("8x4").flat_view(torch.zeros(_layout("8x4").plane_shape(1)))


@pytest.mark.parametrize("model", ["fig10", "dram", "best_tile", "tile_bytes",
                                   "lines"])
def test_cost_models_match_jax(ref, model):
    ins, out = ref
    if model == "fig10":
        table = L.paper_fig10_table()
        _eq(np.array(list(table.items())), out["fig10"])
        assert min(table, key=table.get) == 10
    elif model == "dram":
        _eq([L.dram_row_misses_per_s(x, 1000, 40, 300.0, 7.0)
             for x in (1, 2, 4, 5, 8, 10, 20, 40)], out["dram"])
    elif model == "best_tile":
        best, scored = L.best_tile(10_000, 100, 10_000.0, 100.0)
        _eq(best, out["best"])
        _eq([[*c, v] for c, v in scored.items()], out["scored"])
        best, _ = L.best_tile(10_000, 100, 3584.0, 26.0,
                              candidates=tuple(map(tuple, ins["cands"])))
        _eq(best, out["best_h100"])
    elif model == "tile_bytes":
        _eq([L.tile_bytes_touched_per_s(a, b, 10_000, 100, 3584.0, 26.0)
             for a, b, _ in COST_GRID], out["tile_bytes"])
    else:
        _eq([L.cache_lines_touched_per_s(a, b, 10_000, 100, 3584.0, 26.0,
                                         line_bytes=line)
             for a, b, line in COST_GRID], out["lines"])


def test_sector_model_at_the_h100_traffic():
    """At the traffic of the human-width fused path (3584 rows and 26
    columns a tick over 256 HCUs), 32-byte sectors per HCU and tick: the
    flat layout 2395, an (xr, 4) tile 1716 (1717 at xr = 32, whose last
    tile is padded), (xr, 2) 1908, (8, 8) as many as flat: xc = 4 is the
    model's optimum."""
    per_hcu = lambda xr, xc: L.cache_lines_touched_per_s(
        xr, xc, 10_000, 100, 3584 / 256, 26 / 256, line_bytes=32)
    assert round(per_hcu(1, 100)) == 2395
    assert [round(per_hcu(xr, 4)) for xr in (8, 16, 32)] == [1716, 1716, 1717]
    assert round(per_hcu(8, 2)) == 1908
    assert per_hcu(8, 8) == per_hcu(1, 100)


@pytest.mark.parametrize("lay", [None, L.FlatLayout(), L.BlockedLayout(R, C),
                                 L.BlockedLayout(R, C, 7, 5)],
                         ids=["none", "flatlayout", "8x4", "7x5"])
def test_layout_tag_round_trip(ref, lay):
    _, out = ref
    p = tiny_scale(4, R, C)
    tag = L.layout_tag(lay)
    assert tag in [str(t) for t in out["tags"]]
    assert L.layout_from_tag(tag, p) == L.as_blocked(lay)
    assert L.resolve_layout(lay, p) == L.as_blocked(lay)


def test_resolve_layout_specs():
    p = tiny_scale(4, R, C)
    assert L.resolve_layout(None, p) is None
    assert L.resolve_layout("flat", p) is None
    assert L.resolve_layout("blocked", p) == L.BlockedLayout(R, C, 8, 4)
    assert L.resolve_layout("blocked_tpu", p) == L.BlockedLayout(R, C, 8, 128)
    for bad in ("tiled", "blocked:xr=8,xc=4", 3):
        with pytest.raises(ValueError, match="unknown plane layout"):
            L.resolve_layout(bad, p)
    with pytest.raises(ValueError, match="unknown layout tag"):
        L.layout_from_tag("rowmerge", p)


@pytest.mark.parametrize("src,dst", [(None, "8x4"), ("8x4", "7x5"),
                                     ("7x5", None), ("8x4", "8x4")])
def test_convert_hcus_preserves_values(src, dst):
    p = tiny_scale(2, R, C)
    hcus = init_hcu_batch(p, 2, "cpu")
    hcus = hcus._replace(zij=torch.randn(2 * R, C), tij=torch.randint(
        0, 9, (2 * R, C), dtype=torch.int32))
    lay = lambda n: None if n is None else _layout(n)
    stored = L.store_hcus(hcus, lay(src))
    moved = L.convert_hcus(stored, lay(src), lay(dst))
    back = L.load_hcus(moved, lay(dst))
    for f in hcus._fields:
        _eq(getattr(back, f), getattr(hcus, f), f)
    if dst is not None:
        assert tuple(moved.zij.shape) == lay(dst).plane_shape(2)
