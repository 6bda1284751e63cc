"""Synaptic data organization: the Row-Merge cost models, the flat layout
and the column-blocked plane layout (the port of `repro.core.layout`).

1. Row-Merge (paper Fig 9-10). The (R=10000, C=100) synaptic matrix is
   accessed as rows (per input spike) and columns (per output spike). A
   row-major mapping makes a column access cost one DRAM row miss per cell;
   Row-Merge block-interleaves X x X blocks so a column access hits X cells
   per DRAM row. `dram_row_misses_per_s` is the paper's objective (minimum
   at X = 10), `tile_bytes_touched_per_s` / `best_tile` its re-derivation
   for (xr, xc) tiles and `cache_lines_touched_per_s` for cache lines; at
   ``line_bytes=32`` the latter counts the 32-byte sectors of an H100's L2
   and DRAM.

2. The flat layout: ij planes (H*R, C), i-vectors (H*R,), j-vectors (H, C).
   HCU h's synaptic row r is the plane row with global index

       g = h * R + r          (`global_row`),

   and HCU h's column j is the (R, 1) block at (h*R, j) (`col_offset`).
   The batched (H, R, C) view is a reshape of the same storage
   (`batched_state`), so both views share memory.

3. The pluggable plane layout: the STORED order of the five ij planes.
   `FlatLayout` is the flat (H*R, C) order (the default; ``None`` means it
   everywhere). `BlockedLayout` stores each HCU's (R, C) plane as
   (R'/xr, C'/xc, xr, xc) tiles (network-wide (H*Tr, Tc, xr, xc)),
   zero-padded to tile multiples, so a fired column touches Tr runs of xr
   cells instead of R isolated ones. i-vectors and j-vectors are the same
   under every layout. Layout is storage order, not math: a trajectory is
   the same under every layout.

   Where the JAX package writes the row / column / cell accessors as
   dynamic slices, the port writes them as index maps: `cell_index(h, r, j)`
   is the flat offset of logical cell (h, r, j) in the stored plane
   (`plane.reshape(-1)`), in int64, and `row_index` / `col_index` map a
   whole row or column. The CUDA kernels compute the same offset, with
   the flat layout as the tile (1, C) (`FlatLayout.xr` etc.), so one
   formula serves both:

       ((h*Tr + r/xr)*Tc + j/xc)*xr*xc + (r%xr)*xc + j%xc

   Pad cells (r >= R or j >= C) are never read or written by an accessor
   or a kernel; `store` fills them with zeros and `load` cuts them off.
"""
from __future__ import annotations

import dataclasses

import torch


# ----------------------------- paper's DRAM model ---------------------------

def dram_row_misses_per_s(x: int, rows: int = 10_000, cols: int = 100,
                          row_rate: float = 10_000.0, col_rate: float = 100.0):
    """Paper Fig 10 objective (X divides `cols`): a row access touches X
    DRAM rows, a column access rows/X:

        rowmiss(X) = (row_rate * X + col_rate * rows/X) * 2   (read+write)

    At the paper's rates this is 10000 * (X + 100/X) * 2, minimal at X = 10.
    """
    return (row_rate * x + col_rate * (rows / x)) * 2.0


def paper_fig10_table(rows=10_000, cols=100):
    xs = [x for x in range(1, cols + 1) if cols % x == 0]
    return {x: dram_row_misses_per_s(x, rows, cols) for x in xs}


# ----------------------------- tile model -----------------------------------

def tile_bytes_touched_per_s(xr: int, xc: int, rows: int, cols: int,
                             row_rate: float, col_rate: float,
                             bytes_per_cell: int = 20):
    """Bytes moved per second under (xr, xc) tiling (read+write): a row
    crosses ceil(C/xc) tiles, a column ceil(R/xr)."""
    tile_b = xr * xc * bytes_per_cell
    tiles_per_row = -(-cols // xc)
    tiles_per_col = -(-rows // xr)
    return 2.0 * tile_b * (row_rate * tiles_per_row + col_rate * tiles_per_col)


def best_tile(rows: int, cols: int, row_rate: float, col_rate: float,
              candidates=((8, 128), (8, 256), (16, 128), (32, 128), (8, 512),
                          (64, 128), (128, 128), (256, 128))):
    scored = {c: tile_bytes_touched_per_s(c[0], min(c[1], cols), rows, cols,
                                          row_rate, col_rate)
              for c in candidates}
    best = min(scored, key=scored.get)
    return best, scored


def cache_lines_touched_per_s(xr: int, xc: int, rows: int, cols: int,
                              row_rate: float, col_rate: float,
                              line_bytes: int = 64, cell_bytes: int = 4):
    """Lines of ``line_bytes`` touched per second under (xr, xc) blocking
    (read+write). A logical row touches ceil(C/xc) tile-row segments of xc
    contiguous cells each; a logical column touches ceil(R/xr) tiles,
    min(xr, ceil(xr*xc*cell/line)) lines each. The flat layout is the
    (1, cols) point."""
    seg = max(1, -(-(xc * cell_bytes) // line_bytes))
    lines_row = -(-cols // xc) * seg
    per_tile = min(xr, -(-(xr * xc * cell_bytes) // line_bytes))
    lines_col = -(-rows // xr) * per_tile
    return 2.0 * (row_rate * lines_row + col_rate * lines_col)


@dataclasses.dataclass(frozen=True)
class RowMergeLayout:
    """Bijective (R, C) <-> (R/xr, C/xc, xr, xc) tiled layout of one plane."""
    rows: int
    cols: int
    xr: int = 8
    xc: int = 128

    @property
    def padded_rows(self) -> int:
        return -(-self.rows // self.xr) * self.xr

    @property
    def padded_cols(self) -> int:
        return -(-self.cols // self.xc) * self.xc

    def pack(self, plane: torch.Tensor) -> torch.Tensor:
        """(R, C) -> (R'/xr, C'/xc, xr, xc), zero-padded."""
        R, C = plane.shape
        if (R, C) != (self.rows, self.cols):
            raise ValueError(f"plane {(R, C)}, expected {(self.rows, self.cols)}")
        p = torch.nn.functional.pad(plane, (0, self.padded_cols - C,
                                            0, self.padded_rows - R))
        t = p.reshape(self.padded_rows // self.xr, self.xr,
                      self.padded_cols // self.xc, self.xc)
        return t.permute(0, 2, 1, 3).contiguous()

    def unpack(self, tiled: torch.Tensor) -> torch.Tensor:
        t = tiled.permute(0, 2, 1, 3).reshape(self.padded_rows,
                                              self.padded_cols)
        return t[: self.rows, : self.cols].contiguous()

    def row_tiles(self, r: int):
        """Tile coordinates a logical row touches: (tile_r, all tile_cs)."""
        return r // self.xr, torch.arange(self.padded_cols // self.xc)

    def col_tiles(self, c: int):
        return torch.arange(self.padded_rows // self.xr), c // self.xc


# ----------------------------- flat layout ----------------------------------

# HCUState fields stored as planes (leading axis H*R) and as i-vectors; the
# j-vector and support fields keep their (H, C) shape under every layout
_FLAT_PLANE_FIELDS = ("zij", "eij", "pij", "wij", "tij")
_FLAT_VEC_FIELDS = ("zi", "ei", "pi", "ti")


def flat_state(hcus):
    """Batched (H, R, C)/(H, R) HCUState -> the flat layout (views)."""
    upd = {f: flatten_plane(getattr(hcus, f)) for f in _FLAT_PLANE_FIELDS}
    upd.update({f: flatten_vec(getattr(hcus, f)) for f in _FLAT_VEC_FIELDS})
    return hcus._replace(**upd)


def batched_state(hcus, n_hcu: int):
    """Flat HCUState -> the per-HCU batched (H, R, C)/(H, R) view (views of
    the same storage)."""
    upd = {f: unflatten_plane(getattr(hcus, f), n_hcu)
           for f in _FLAT_PLANE_FIELDS}
    upd.update({f: unflatten_vec(getattr(hcus, f), n_hcu)
                for f in _FLAT_VEC_FIELDS})
    return hcus._replace(**upd)


def flatten_plane(plane: torch.Tensor) -> torch.Tensor:
    """(H, R, C) -> (H*R, C) (a view)."""
    return plane.reshape(-1, plane.shape[-1])


def unflatten_plane(flat: torch.Tensor, n_hcu: int) -> torch.Tensor:
    """(H*R, C) -> (H, R, C) (a view)."""
    return flat.reshape(n_hcu, -1, flat.shape[-1])


def flatten_vec(vec: torch.Tensor) -> torch.Tensor:
    """(H, R) i-vector -> (H*R,) (a view)."""
    return vec.reshape(-1)


def unflatten_vec(flat: torch.Tensor, n_hcu: int) -> torch.Tensor:
    return flat.reshape(n_hcu, -1)


def global_row(h, r, rows: int):
    """(hcu, row) -> global flat row index; broadcastable."""
    return h * rows + r


def col_offset(h, j, rows: int):
    """Flat-plane offset of HCU ``h``'s column ``j``: the (R, 1) block at
    (h*R, j)."""
    return h * rows, j


# ----------------------------- pluggable plane layout -----------------------

def _long(x, device):
    return torch.as_tensor(x, device=device).long()


def _rows(g):
    """Row indices as a tensor of at least one dimension (a scalar g reads
    the (1, C) row, as the JAX accessors do)."""
    g = torch.as_tensor(g)
    return g.reshape(1) if g.dim() == 0 else g


class _Accessors:
    """Row, column and cell accessors on a stored plane through the index
    maps of `cell_index` (shared by both layouts). The writes are in place;
    every accessor takes logical coordinates only."""

    def row_index(self, g):
        """Global flat row indices g (...,) -> the (..., C) stored offsets
        of their cells."""
        rows = self.rows
        g = torch.as_tensor(g).long()
        j = torch.arange(self.cols, device=g.device)
        return self.cell_index((g // rows)[..., None], (g % rows)[..., None], j)

    def col_index(self, h, j):
        """HCU h's column j ((...,) each) -> the (..., R) stored offsets."""
        h = torch.as_tensor(h).long()
        r = torch.arange(self.rows, device=h.device)
        return self.cell_index(h[..., None], r, _long(j, h.device)[..., None])

    def read_row(self, f, g):
        """The logical row g as (1, C), or rows g (...,) as (..., C)."""
        return f.reshape(-1)[self.row_index(_rows(g))]

    def write_row(self, f, g, val):
        f.view(-1)[self.row_index(_rows(g))] = \
            val.reshape(1, self.cols).to(f.dtype)
        return f

    def stamp_row(self, f, g, now):
        f.view(-1)[self.row_index(_rows(g))] = \
            torch.as_tensor(now, dtype=f.dtype)
        return f

    def read_col(self, f, h, j):
        """HCU h's logical column j -> (R,)."""
        return f.reshape(-1)[self.col_index(h, j)]

    def write_col(self, f, h, j, val):
        f.view(-1)[self.col_index(h, j)] = val.reshape(self.rows).to(f.dtype)
        return f

    def stamp_col(self, f, h, j, now):
        f.view(-1)[self.col_index(h, j)] = torch.as_tensor(now, dtype=f.dtype)
        return f

    def add_cell(self, f, h, r, j, delta):
        i = self.cell_index(h, r, j)
        f.view(-1)[i] = f.view(-1)[i] + delta
        return f


@dataclasses.dataclass(frozen=True)
class FlatLayout(_Accessors):
    """The row-major (H*R, C) storage, the default layout (``None``
    everywhere means this one). The row and column accessors need ``rows``
    and ``cols``; `store` and `load` need neither. To the kernels it is the
    tile (1, cols): `xr`, `xc`, `row_tiles_n`, `col_tiles_n`."""
    rows: int | None = None
    cols: int | None = None
    xr = 1

    @property
    def xc(self) -> int:
        return self.cols

    @property
    def row_tiles_n(self) -> int:
        return self.rows

    @property
    def col_tiles_n(self) -> int:
        return 1

    def store(self, flat: torch.Tensor) -> torch.Tensor:
        return flat

    def load(self, stored: torch.Tensor) -> torch.Tensor:
        return stored

    def read_row(self, f, g):
        """The plane rows themselves (one gather, no index map)."""
        return f.reshape(-1, self.cols)[_rows(g)]

    def cell_index(self, h, r, j):
        """Flat offset of logical cell (h, r, j): (h*R + r)*C + j, int64,
        broadcast."""
        dev = torch.as_tensor(h).device
        return ((_long(h, dev) * self.rows + _long(r, dev)) * self.cols
                + _long(j, dev))


@dataclasses.dataclass(frozen=True)
class BlockedLayout(_Accessors):
    """Row-Merge / column-blocked plane storage: (H*Tr, Tc, xr, xc) tiles.

    Per HCU this is `RowMergeLayout(rows, cols, xr, xc).pack`; network-wide
    the H per-HCU tile grids are stacked along the leading axis, so HCU h's
    tiles are the Tr tile-rows from h*Tr on. Pad cells never feed compute
    and are never written after `store`.
    """
    rows: int
    cols: int
    xr: int = 8
    xc: int = 4

    @property
    def padded_rows(self) -> int:
        return -(-self.rows // self.xr) * self.xr

    @property
    def padded_cols(self) -> int:
        return -(-self.cols // self.xc) * self.xc

    @property
    def row_tiles_n(self) -> int:        # Tr
        return self.padded_rows // self.xr

    @property
    def col_tiles_n(self) -> int:        # Tc
        return self.padded_cols // self.xc

    @property
    def tpu_degenerate(self) -> bool:
        """One column tile (xc >= C): the stored form is the row-padded flat
        view (`flat_view`)."""
        return self.col_tiles_n == 1

    def plane_shape(self, n_hcu: int):
        return (n_hcu * self.row_tiles_n, self.col_tiles_n, self.xr, self.xc)

    # -- whole-plane conversion (pure data movement) ------------------------
    def store(self, flat: torch.Tensor) -> torch.Tensor:
        """(H*R, C) flat -> (H*Tr, Tc, xr, xc), zero-padded (a new tensor)."""
        HR, C = flat.shape
        H = HR // self.rows
        p = flat.reshape(H, self.rows, C)
        if (self.padded_rows, self.padded_cols) != (self.rows, C):
            p = torch.nn.functional.pad(p, (0, self.padded_cols - C,
                                            0, self.padded_rows - self.rows))
        t = p.reshape(H, self.row_tiles_n, self.xr, self.col_tiles_n,
                      self.xc).permute(0, 1, 3, 2, 4)
        return t.reshape(self.plane_shape(H)).contiguous()

    def load(self, stored: torch.Tensor) -> torch.Tensor:
        """Inverse of `store`: padding cut off (a new tensor)."""
        H = stored.shape[0] // self.row_tiles_n
        t = stored.reshape(H, self.row_tiles_n, self.col_tiles_n,
                           self.xr, self.xc).permute(0, 1, 3, 2, 4)
        p = t.reshape(H, self.padded_rows,
                      self.padded_cols)[:, : self.rows, : self.cols]
        return p.reshape(H * self.rows, self.cols).contiguous()

    def cell_index(self, h, r, j):
        """Stored offset of logical cell (h, r, j), int64, broadcast:
        ((h*Tr + r//xr)*Tc + j//xc)*xr*xc + (r%xr)*xc + j%xc."""
        dev = torch.as_tensor(h).device
        h, r, j = _long(h, dev), _long(r, dev), _long(j, dev)
        tile = (h * self.row_tiles_n + r // self.xr) * self.col_tiles_n \
            + j // self.xc
        return tile * (self.xr * self.xc) + (r % self.xr) * self.xc \
            + j % self.xc

    # -- the row-padded flat view of the degenerate point -------------------
    def flat_view(self, stored: torch.Tensor) -> torch.Tensor:
        """Degenerate (Tc == 1) stored plane as the row-padded flat
        (H*R', C') view (a reshape)."""
        if not self.tpu_degenerate:
            raise ValueError("flat_view needs one column tile (xc >= C)")
        return stored.reshape(stored.shape[0] * self.xr, self.xc)

    def from_flat_view(self, view: torch.Tensor) -> torch.Tensor:
        return view.reshape(view.shape[0] // self.xr, 1, self.xr, self.xc)

    def pad_row_index(self, g, n_hcu: int):
        """Flat row index (sentinel n_hcu*R) -> row-padded view index
        (sentinel n_hcu*R')."""
        rp = self.padded_rows
        return torch.where(g < n_hcu * self.rows,
                           (g // self.rows) * rp + g % self.rows, n_hcu * rp)

    def pad_ivec(self, v, n_hcu: int):
        """(H*R,) i-vector -> (H*R',) zero-padded."""
        if self.padded_rows == self.rows:
            return v
        return torch.nn.functional.pad(
            v.reshape(n_hcu, self.rows),
            (0, self.padded_rows - self.rows)).reshape(-1)

    def unpad_ivec(self, v, n_hcu: int):
        if self.padded_rows == self.rows:
            return v
        return v.reshape(n_hcu, self.padded_rows)[:, : self.rows].reshape(-1)


def as_blocked(layout) -> BlockedLayout | None:
    """None for the flat default (None or FlatLayout), else the
    BlockedLayout."""
    if layout is None or isinstance(layout, FlatLayout):
        return None
    return layout


def resolve_layout(layout, p) -> BlockedLayout | None:
    """User-facing layout spec -> None (flat) or a BlockedLayout.

    Accepts None / "flat" / a FlatLayout / "blocked" (`cpu_blocked`, the
    (8, 4) tile) / "blocked_tpu" (`tpu_blocked`, the (8, 128) tile) / a
    BlockedLayout (any other tile). Anything else raises ValueError."""
    if layout is None or isinstance(layout, FlatLayout) or (
            isinstance(layout, str) and layout == "flat"):
        return None
    if isinstance(layout, BlockedLayout):
        return layout
    if isinstance(layout, str) and layout == "blocked":
        return cpu_blocked(p)
    if isinstance(layout, str) and layout == "blocked_tpu":
        return tpu_blocked(p)
    raise ValueError(f"unknown plane layout {layout!r}")


def as_layout(layout, rows: int, cols: int):
    """The layout object whose index maps address planes stored in
    ``layout``: the BlockedLayout itself, or FlatLayout(rows, cols) for
    the flat default."""
    lay = as_blocked(layout)
    return lay if lay is not None else FlatLayout(rows, cols)


# The JAX package's column-blocked tile for the CPU (`layout="blocked"`):
# xc*4 B is a quarter of a 64 B cache line, so a fired column touches
# ~R/4 lines instead of R, and a row ceil(C/xc) segments
CPU_BLOCK_XR = 8
CPU_BLOCK_XC = 4


def cpu_blocked(p) -> BlockedLayout:
    return BlockedLayout(rows=p.rows, cols=p.cols,
                         xr=CPU_BLOCK_XR, xc=CPU_BLOCK_XC)


def tpu_blocked(p) -> BlockedLayout:
    return BlockedLayout(rows=p.rows, cols=p.cols, xr=8, xc=128)


def layout_tag(layout) -> str:
    """Checkpoint-manifest tag for a layout (parse: `layout_from_tag`)."""
    lay = as_blocked(layout)
    if lay is None:
        return "flat"
    return f"blocked:xr={lay.xr},xc={lay.xc}"


def layout_from_tag(tag: str, p) -> BlockedLayout | None:
    if tag in (None, "", "flat"):
        return None
    if tag.startswith("blocked:"):
        kv = dict(kv.split("=") for kv in tag[len("blocked:"):].split(","))
        return BlockedLayout(rows=p.rows, cols=p.cols,
                             xr=int(kv["xr"]), xc=int(kv["xc"]))
    raise ValueError(f"unknown layout tag {tag!r}")


def store_hcus(hcus, layout):
    """Flat HCUState -> the layout's stored form (ij planes only). No-op
    for flat."""
    lay = as_blocked(layout)
    if lay is None:
        return hcus
    return hcus._replace(**{f: lay.store(getattr(hcus, f))
                            for f in _FLAT_PLANE_FIELDS})


def load_hcus(hcus, layout):
    """Inverse of `store_hcus` (stored form -> flat; a copy under a blocked
    layout, the same tensors under flat)."""
    lay = as_blocked(layout)
    if lay is None:
        return hcus
    return hcus._replace(**{f: lay.load(getattr(hcus, f))
                            for f in _FLAT_PLANE_FIELDS})


def convert_hcus(hcus, src, dst):
    """Re-store an HCUState from layout `src` to layout `dst` (either may be
    None == flat), through the flat form; logical values are preserved."""
    s, d = as_blocked(src), as_blocked(dst)
    if s == d:
        return hcus
    return store_hcus(load_hcus(hcus, s), d)
