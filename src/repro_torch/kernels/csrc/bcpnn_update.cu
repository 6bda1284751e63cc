// Hopper (sm_90a) kernels for the BCPNN lazy cell update.
//
//   bcpnn_fused_row_update     replaces repro/kernels/bcpnn_update.py
//                              fused_row_update_kernel_call (_fused_row_kernel)
//   bcpnn_fused_col_update     replaces fused_col_update_kernel_call
//                              (_fused_col_kernel) and the column prologue
//                              of repro/core/engine.py (_col_worklist_prologue)
//   bcpnn_worklist_row_update  replaces worklist_update_kernel_call
//                              (_worklist_kernel)
//   bcpnn_row_update           replaces row_update_kernel_call (_row_kernel)
//   bcpnn_col_update           replaces col_update_kernel_call (_col_kernel)
//
// The first three rewrite the five ij planes (z, e, p, w float32 and t int32)
// in place through raw pointers, in the plane layout they are stored in
// (repro_torch/core/layout.py): column-blocked (H*Tr, Tc, xr, xc) tiles, with
// the flat (H*R, C) planes as the tile (1, C). Logical cell (h, r, j) lies at
//
//   ((h*Tr + r/xr)*Tc + j/xc)*xr*xc + (r%xr)*xc + j%xc      (64-bit)
//
// and pad cells (r >= R or j >= C) are never read or written. The fused row
// kernel also rewrites the four (H*R,) i-vectors and emits the per-slot
// weight rows. The last two are elementwise passes over blocks the caller
// gathered from the planes: they read z, e, p, t and write five fresh output
// blocks. The per-cell arithmetic is cell_math of
// repro_torch/kernels/bcpnn_ref.py, and the i-vector decay decay_zep of
// repro_torch/core/traces.py, in the same operation order (expf/logf in
// float32); the library is built with -fmad=false so no multiply-add is
// contracted that the plain version does not contract either.
//
// What bounds them on the H100 is bytes: ~33 float32 operations a cell
// against 36-52 bytes of plane and vector traffic, and every cell is touched
// once a call. There is no reuse to stage, so neither shared memory nor TMA
// has work to do here: the designs below are about how the bytes are
// fetched. A row is C contiguous cells (flat) or C/xc segments of xc cells
// (blocked); the row kernels give one lane a 16-byte segment of 4 cells
// and one warp a row (the unfused one two rows, whose loads it issues
// before either row's math), so a row's loads are issued at once. A
// column is R cells C*4 bytes apart (flat: one 32-byte sector a cell) or
// R/xr runs of xr cells xc*4 bytes apart (blocked (xr, 4): one sector per
// two cells, in contiguous xr*16-byte runs); the column kernel puts a warp's lanes on
// neighbouring rows, one row a thread: on the H100 that beat several rows a
// thread with all their loads issued first, and streaming cache hints
// (ld/st.global.cs) made neither kernel faster. DRAM moves 64-byte bursts,
// so a 16-byte row segment of an (xr, 4) tile costs four times its bytes:
// the blocked layout trades slower rows for much faster columns.
//
// The current time (and the worklist's valid count) arrive as device
// pointers, so a launch needs no value from the host and the tick never
// synchronises.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

struct Coeffs {
  float inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2;
};

// The stored plane's tile geometry: R x C logical cells per HCU in
// Tr x Tc tiles of xr x xc cells (flat: xr = 1, xc = C, Tr = R, Tc = 1).
struct Tiling {
  int R, C, xr, xc, Tr, Tc;
};

// Offset of HCU h's logical row r, cell 0 (add col_off for column j).
__device__ __forceinline__ long long row_off(const Tiling& g, long long h,
                                             int r) {
  return ((h * g.Tr + r / g.xr) * g.Tc) * (long long)(g.xr * g.xc) +
         (long long)((r % g.xr) * g.xc);
}

// Offset of column j within a row (relative to row_off).
__device__ __forceinline__ long long col_off(const Tiling& g, int j) {
  return (long long)(j / g.xc) * (g.xr * g.xc) + j % g.xc;
}

__device__ __forceinline__ void cell_math(float z, float e, float p, float dt,
                                          float dz, float p_pre, float p_post,
                                          const Coeffs& k, float& z1,
                                          float& e1, float& p1, float& w1) {
  const float ez = expf(-dt * k.inv_tau_z);
  const float ee = expf(-dt * k.inv_tau_e);
  const float ep = expf(-dt * k.inv_tau_p);
  e1 = e * ee + z * (ez - ee) * k.c_ze;
  p1 = (p * ep + (e - z * k.c_ze) * (ee - ep) * k.c_ep) +
       z * k.c_ze * (ez - ep) * k.c_zp;
  z1 = z * ez + dz;
  w1 = logf((p1 + k.eps2) / ((p_pre + k.eps) * (p_post + k.eps)));
}

// decay_zep of an i-vector trace over dt: the Z and P it has at `now`.
__device__ __forceinline__ void zp_decay(float z, float e, float p, float dt,
                                         const Coeffs& k, float& z1,
                                         float& p1) {
  const float ez = expf(-dt * k.inv_tau_z);
  const float ee = expf(-dt * k.inv_tau_e);
  const float ep = expf(-dt * k.inv_tau_p);
  p1 = (p * ep + (e - z * k.c_ze) * (ee - ep) * k.c_ep) +
       z * k.c_ze * (ez - ep) * k.c_zp;
  z1 = z * ez;
}

constexpr int kRowWarps = 8;        // worklist slots per block (one warp each)
constexpr int kColThreads = 256;    // column rows per block
constexpr int kBlockThreads = 256;  // cells per block of the block kernels

// One warp rewrites HCU h's logical row r in place: dz = cnt * zj_row[c],
// p_pre, p_post = pj_row[c]; Tij = now. The weight row also goes to wrow_out
// where that is not null. kVec (xc % 4 == 0, C % xc == 0, 16-byte aligned
// pointers): lane l takes the 4-cell segment at column 4l, whose cells are
// contiguous in the plane, as float4 / int4 loads and stores; C <= 128 is one
// step of loads with no dependent iteration. Otherwise (a tile such as
// (7, 5)) the lanes stride over single cells.
template <bool kVec>
__device__ __forceinline__ void row_walk(
    float* __restrict__ zij, float* __restrict__ eij, float* __restrict__ pij,
    float* __restrict__ wij, int* __restrict__ tij, const Tiling& g,
    long long base, const float* __restrict__ zj_row,
    const float* __restrict__ pj_row, float cnt, float p_pre, int now,
    int lane, const Coeffs& k, float* __restrict__ wrow_out) {
  if constexpr (kVec) {
    for (int c = 4 * lane; c < g.C; c += 128) {
      const long long i = base + col_off(g, c);
      const float4 z = *reinterpret_cast<const float4*>(zij + i);
      const float4 e = *reinterpret_cast<const float4*>(eij + i);
      const float4 p = *reinterpret_cast<const float4*>(pij + i);
      const int4 t = *reinterpret_cast<const int4*>(tij + i);
      const float4 zj = *reinterpret_cast<const float4*>(zj_row + c);
      const float4 pj = *reinterpret_cast<const float4*>(pj_row + c);
      float4 z1, e1, p1, w1;
      cell_math(z.x, e.x, p.x, (float)(now - t.x), cnt * zj.x, p_pre, pj.x, k,
                z1.x, e1.x, p1.x, w1.x);
      cell_math(z.y, e.y, p.y, (float)(now - t.y), cnt * zj.y, p_pre, pj.y, k,
                z1.y, e1.y, p1.y, w1.y);
      cell_math(z.z, e.z, p.z, (float)(now - t.z), cnt * zj.z, p_pre, pj.z, k,
                z1.z, e1.z, p1.z, w1.z);
      cell_math(z.w, e.w, p.w, (float)(now - t.w), cnt * zj.w, p_pre, pj.w, k,
                z1.w, e1.w, p1.w, w1.w);
      *reinterpret_cast<float4*>(zij + i) = z1;
      *reinterpret_cast<float4*>(eij + i) = e1;
      *reinterpret_cast<float4*>(pij + i) = p1;
      *reinterpret_cast<float4*>(wij + i) = w1;
      *reinterpret_cast<int4*>(tij + i) = make_int4(now, now, now, now);
      if (wrow_out != nullptr) *reinterpret_cast<float4*>(wrow_out + c) = w1;
    }
  } else {
    for (int c = lane; c < g.C; c += 32) {
      const long long i = base + col_off(g, c);
      const float dt = (float)(now - tij[i]);
      float z1, e1, p1, w1;
      cell_math(zij[i], eij[i], pij[i], dt, cnt * zj_row[c], p_pre, pj_row[c],
                k, z1, e1, p1, w1);
      zij[i] = z1;
      eij[i] = e1;
      pij[i] = p1;
      wij[i] = w1;
      tij[i] = now;
      if (wrow_out != nullptr) wrow_out[c] = w1;
    }
  }
}

// One warp per worklist slot (row_walk). Valid rows are unique network-wide,
// so no two warps ever write the same row. Slot s belongs to HCU s / A: its
// zj / pj are that HCU's (H, C) j-vector rows, read in place.
template <bool kVec>
__global__ void __launch_bounds__(32 * kRowWarps)
fused_row_kernel(float* __restrict__ zij, float* __restrict__ eij,
                 float* __restrict__ pij, float* __restrict__ wij,
                 int* __restrict__ tij, float* __restrict__ zi,
                 float* __restrict__ ei, float* __restrict__ pi,
                 int* __restrict__ ti, const int* __restrict__ rows,
                 const int* __restrict__ now_p,
                 const float* __restrict__ counts,
                 const float* __restrict__ zj, const float* __restrict__ p_i,
                 const float* __restrict__ pj,
                 const float* __restrict__ zi_new,
                 const float* __restrict__ ei_new,
                 const float* __restrict__ pi_new, float* __restrict__ wrow,
                 int W, int A, long long HR, Tiling g, Coeffs k) {
  const int slot = blockIdx.x * kRowWarps + threadIdx.y;
  if (slot >= W) return;
  const int lane = threadIdx.x;
  float* out = wrow + (long long)slot * g.C;
  const int gr = rows[slot];
  if (gr < 0 || gr >= HR) {  // sentinel slot: no plane write, zero weight row
    if constexpr (kVec) {
      for (int c = 4 * lane; c < g.C; c += 128)
        *reinterpret_cast<float4*>(out + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = lane; c < g.C; c += 32) out[c] = 0.0f;
    }
    return;
  }
  const int now = *now_p;
  const long long hj = (long long)(slot / A) * g.C;
  row_walk<kVec>(zij, eij, pij, wij, tij, g, row_off(g, gr / g.R, gr % g.R),
                 zj + hj, pj + hj, counts[slot], p_i[slot], now, lane, k, out);
  if (lane == 0) {
    zi[gr] = zi_new[slot];
    ei[gr] = ei_new[slot];
    pi[gr] = pi_new[slot];
    ti[gr] = now;
  }
}

// The unfused worklist row update, reading through the compaction: entry
// i < *nv_p takes slot s = order[i], whose row g_row[s] it rewrites when
// that is a logical plane row, with dz = counts[s] * zj[s / A],
// p_pre = p_i[s], p_post = pj[s / A] (the (H, C) j-vectors read in place,
// as fused_row_kernel reads them). Live rows are unique, so no two entries
// share a row; the rest write nothing.
//
// What bounds it is DRAM latency as much as bytes: a live entry reads
// 4 x C x 4 plane bytes behind two dependent index loads (order, then
// g_row), and the call's reads alone take ~2 us at 3.35 TB/s. The grid
// holds at most kWlResident warps an SM, each striding over the entries
// i, i + G, ... (G warps in all; the grid is sized from W and the SM count
// on the host). A warp reads the valid count with its first slot, then
// that slot's row and scalars, then the row's cells and j-vector cells;
// the next entry's slot, row and scalars load while the current row's
// cells are in flight, before its math. A lane holds up to 4 cells of a
// row (kVec: the 16-byte segment at column 4 l; else the cells l + 32 q),
// rows of C > 128 in rounds of 128 columns. Measured on the H100: a warp
// an entry beat two or four entries a warp loaded together, and blocks of
// 4 warps suit rows of few sectors (flat, (2, 4), (4, 4)) while blocks of
// 16 suit rows of a sector a segment ((8, 4) up, and scalar tiles).
constexpr int kWlResident = 64;   // warps an SM the grid is sized for

struct RowCells {
  float z[4], e[4], p[4], zj[4], pj[4];
  int t[4];
};

template <bool kVec>
__device__ __forceinline__ void load_cells(
    const float* __restrict__ zij, const float* __restrict__ eij,
    const float* __restrict__ pij, const int* __restrict__ tij,
    const Tiling& g, long long base, const float* __restrict__ zj_row,
    const float* __restrict__ pj_row, int cb, int lane, RowCells& x) {
  if constexpr (kVec) {
    const int c = cb + 4 * lane;
    if (c < g.C) {
      const long long i = base + col_off(g, c);
      const float4 z = *reinterpret_cast<const float4*>(zij + i);
      const float4 e = *reinterpret_cast<const float4*>(eij + i);
      const float4 p = *reinterpret_cast<const float4*>(pij + i);
      const int4 t = *reinterpret_cast<const int4*>(tij + i);
      const float4 zj = *reinterpret_cast<const float4*>(zj_row + c);
      const float4 pj = *reinterpret_cast<const float4*>(pj_row + c);
      x.z[0] = z.x; x.z[1] = z.y; x.z[2] = z.z; x.z[3] = z.w;
      x.e[0] = e.x; x.e[1] = e.y; x.e[2] = e.z; x.e[3] = e.w;
      x.p[0] = p.x; x.p[1] = p.y; x.p[2] = p.z; x.p[3] = p.w;
      x.t[0] = t.x; x.t[1] = t.y; x.t[2] = t.z; x.t[3] = t.w;
      x.zj[0] = zj.x; x.zj[1] = zj.y; x.zj[2] = zj.z; x.zj[3] = zj.w;
      x.pj[0] = pj.x; x.pj[1] = pj.y; x.pj[2] = pj.z; x.pj[3] = pj.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cb + lane + 32 * q;
      if (c < g.C) {
        const long long i = base + col_off(g, c);
        x.z[q] = zij[i];
        x.e[q] = eij[i];
        x.p[q] = pij[i];
        x.t[q] = tij[i];
        x.zj[q] = zj_row[c];
        x.pj[q] = pj_row[c];
      }
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cells(
    float* __restrict__ zij, float* __restrict__ eij, float* __restrict__ pij,
    float* __restrict__ wij, int* __restrict__ tij, const Tiling& g,
    long long base, int cb, int lane, const RowCells& x, float cnt,
    float p_pre, int now, const Coeffs& k) {
  float z1[4], e1[4], p1[4], w1[4];
  if constexpr (kVec) {
    const int c = cb + 4 * lane;
    if (c < g.C) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cell_math(x.z[q], x.e[q], x.p[q], (float)(now - x.t[q]),
                  cnt * x.zj[q], p_pre, x.pj[q], k, z1[q], e1[q], p1[q],
                  w1[q]);
      const long long i = base + col_off(g, c);
      *reinterpret_cast<float4*>(zij + i) = make_float4(z1[0], z1[1], z1[2], z1[3]);
      *reinterpret_cast<float4*>(eij + i) = make_float4(e1[0], e1[1], e1[2], e1[3]);
      *reinterpret_cast<float4*>(pij + i) = make_float4(p1[0], p1[1], p1[2], p1[3]);
      *reinterpret_cast<float4*>(wij + i) = make_float4(w1[0], w1[1], w1[2], w1[3]);
      *reinterpret_cast<int4*>(tij + i) = make_int4(now, now, now, now);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cb + lane + 32 * q;
      if (c < g.C) {
        cell_math(x.z[q], x.e[q], x.p[q], (float)(now - x.t[q]),
                  cnt * x.zj[q], p_pre, x.pj[q], k, z1[q], e1[q], p1[q],
                  w1[q]);
        const long long i = base + col_off(g, c);
        zij[i] = z1[q];
        eij[i] = e1[q];
        pij[i] = p1[q];
        wij[i] = w1[q];
        tij[i] = now;
      }
    }
  }
}

template <bool kVec, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
worklist_row_kernel(float* __restrict__ zij, float* __restrict__ eij,
                    float* __restrict__ pij, float* __restrict__ wij,
                    int* __restrict__ tij, const int* __restrict__ g_row,
                    const int* __restrict__ order,
                    const int* __restrict__ nv_p,
                    const int* __restrict__ now_p,
                    const float* __restrict__ counts,
                    const float* __restrict__ zj,
                    const float* __restrict__ p_i,
                    const float* __restrict__ pj, int W, int A, long long HR,
                    Tiling g, Coeffs k) {
  const int G = gridDim.x * WARPS;
  int i = blockIdx.x * WARPS + threadIdx.y;
  if (i >= W) return;
  const int lane = threadIdx.x;
  // the valid count, the first slot and the clock in one round
  const int nv = min(*nv_p, W);
  int s = order[i];
  const int now = *now_p;
  if (i >= nv) return;
  // the slot's row and scalars (a slot out of range writes nothing)
  int gr = -1;
  float cnt = 0.f, p_pre = 0.f;
  if (s >= 0 && s < W) {
    gr = g_row[s];
    cnt = counts[s];
    p_pre = p_i[s];
  }
  for (;;) {
    const bool live = gr >= 0 && gr < HR;
    long long base = 0;
    const float* zj_row = zj;
    const float* pj_row = pj;
    RowCells x;
    if (live) {
      base = row_off(g, gr / g.R, gr % g.R);
      const long long hj = (long long)(s / A) * g.C;
      zj_row += hj;
      pj_row += hj;
      load_cells<kVec>(zij, eij, pij, tij, g, base, zj_row, pj_row, 0, lane,
                       x);
    }
    // the next entry's slot, row and scalars load behind this row's cells
    const int i_next = i + G;
    int s_next = -1, gr_next = -1;
    float cnt_next = 0.f, p_next = 0.f;
    if (i_next < nv) {
      s_next = order[i_next];
      if (s_next >= 0 && s_next < W) {
        gr_next = g_row[s_next];
        cnt_next = counts[s_next];
        p_next = p_i[s_next];
      }
    }
    if (live) {
      for (int cb = 0;;) {
        store_cells<kVec>(zij, eij, pij, wij, tij, g, base, cb, lane, x, cnt,
                          p_pre, now, k);
        if ((cb += 128) >= g.C) break;
        load_cells<kVec>(zij, eij, pij, tij, g, base, zj_row, pj_row, cb,
                         lane, x);
      }
    }
    if (i_next >= nv) return;
    i = i_next;
    s = s_next;
    gr = gr_next;
    cnt = cnt_next;
    p_pre = p_next;
  }
}

// Grid (row blocks, fired entries). Entry e rewrites column j of HCU h, one
// row a thread, the lanes of a warp on neighbouring rows, so a warp reads
// runs of consecutive cells of one tile column (xr cells xc*4 bytes apart in
// each xr*xc*4-byte tile; flat: single cells C*4 bytes apart). The entry's
// i-vector traces zi, ei, pi, ti (contiguous at h*R + r) are decayed to
// `now` here, as decay_zep does (dz = Z_i(now), p_pre = P_i(now)), and
// p_post = pj[h, j] is read by index; a thread's eight loads are issued
// before its arithmetic. Fired HCUs are unique within a batch, so entries
// never share a cell; padding entries (h == n_hcu) return at once.
__global__ void __launch_bounds__(kColThreads)
fused_col_kernel(float* __restrict__ zij, float* __restrict__ eij,
                 float* __restrict__ pij, float* __restrict__ wij,
                 int* __restrict__ tij, const float* __restrict__ zi,
                 const float* __restrict__ ei, const float* __restrict__ pi,
                 const int* __restrict__ ti, const float* __restrict__ pj,
                 const int* __restrict__ h_idx, const int* __restrict__ j_idx,
                 const int* __restrict__ now_p, int n_hcu, Tiling g,
                 Coeffs kij, Coeffs ki) {
  const int e = blockIdx.y;
  const int h = h_idx[e];
  const int j = j_idx[e];
  if (h < 0 || h >= n_hcu || j < 0 || j >= g.C) return;  // padding entry
  const int r = blockIdx.x * kColThreads + threadIdx.x;
  if (r >= g.R) return;
  const int now = *now_p;
  const long long i = row_off(g, h, r) + col_off(g, j);
  const long long v = (long long)h * g.R + r;
  const float z = zij[i], ez = eij[i], pz = pij[i];
  const int t = tij[i];
  const float zv = zi[v], ev = ei[v], pv = pi[v];
  const int tv = ti[v];
  const float p_post = pj[(long long)h * g.C + j];
  float zi_t, p_i, z1, e1, p1, w1;
  zp_decay(zv, ev, pv, (float)(now - tv), ki, zi_t, p_i);
  cell_math(z, ez, pz, (float)(now - t), zi_t, p_i, p_post, kij, z1, e1, p1,
            w1);
  zij[i] = z1;
  eij[i] = e1;
  pij[i] = p1;
  wij[i] = w1;
  tij[i] = now;
}

// The dense row update over gathered (S, C) blocks, S = H*A slots in
// h-major order: one thread per cell, dz = counts[s] * zj[s/A, c],
// p_pre = p_i[s], p_post = pj[s/A, c]. Every slot is computed, padding
// included, as the TPU kernel does; outputs are fresh blocks.
__global__ void __launch_bounds__(kBlockThreads)
row_block_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 const float* __restrict__ p, const int* __restrict__ t,
                 float* __restrict__ zo, float* __restrict__ eo,
                 float* __restrict__ po, float* __restrict__ wo,
                 int* __restrict__ to, const int* __restrict__ now_p,
                 const float* __restrict__ counts,
                 const float* __restrict__ zj, const float* __restrict__ p_i,
                 const float* __restrict__ pj, long long n_cells, int A,
                 int C, Coeffs k) {
  const long long i = (long long)blockIdx.x * kBlockThreads + threadIdx.x;
  if (i >= n_cells) return;
  const long long s = i / C;
  const long long hc = (s / A) * C + (i - s * C);
  const int now = *now_p;
  const float dt = (float)(now - t[i]);
  float z1, e1, p1, w1;
  cell_math(z[i], e[i], p[i], dt, counts[s] * zj[hc], p_i[s], pj[hc], k, z1,
            e1, p1, w1);
  zo[i] = z1;
  eo[i] = e1;
  po[i] = p1;
  wo[i] = w1;
  to[i] = now;
}

// The column update over gathered (K, R) columns: one thread per cell,
// dz = zi_t[k, r], p_pre = p_i[k, r], p_post = pj_sc[k]. Every entry is
// computed, padding included; outputs are fresh blocks.
__global__ void __launch_bounds__(kBlockThreads)
col_block_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 const float* __restrict__ p, const int* __restrict__ t,
                 float* __restrict__ zo, float* __restrict__ eo,
                 float* __restrict__ po, float* __restrict__ wo,
                 int* __restrict__ to, const int* __restrict__ now_p,
                 const float* __restrict__ zi_t,
                 const float* __restrict__ p_i,
                 const float* __restrict__ pj_sc, long long n_cells, int R,
                 Coeffs k) {
  const long long i = (long long)blockIdx.x * kBlockThreads + threadIdx.x;
  if (i >= n_cells) return;
  const int now = *now_p;
  const float dt = (float)(now - t[i]);
  float z1, e1, p1, w1;
  cell_math(z[i], e[i], p[i], dt, zi_t[i], p_i[i], pj_sc[i / R], k, z1, e1,
            p1, w1);
  zo[i] = z1;
  eo[i] = e1;
  po[i] = p1;
  wo[i] = w1;
  to[i] = now;
}

dim3 cell_grid(long long n_cells) {
  return dim3((unsigned)((n_cells + kBlockThreads - 1) / kBlockThreads));
}

template <bool kVec, int WARPS>
cudaError_t launch_worklist(float* zij, float* eij, float* pij, float* wij,
                            int* tij, const int* g_row, const int* order,
                            const int* nv, const int* now,
                            const float* counts, const float* zj,
                            const float* p_i, const float* pj, int W, int A,
                            long long HR, const Tiling& g, const Coeffs& k,
                            cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (W + WARPS - 1) / WARPS;
  const int cap = sms * (kWlResident / WARPS);
  const int grid = blocks < cap ? blocks : cap;
  worklist_row_kernel<kVec, WARPS><<<grid, dim3(32, WARPS), 0, stream>>>(
          zij, eij, pij, wij, tij, g_row, order, nv, now, counts, zj, p_i,
          pj, W, A, HR, g, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bcpnn_fused_row_update(
    float* zij, float* eij, float* pij, float* wij, int* tij, float* zi,
    float* ei, float* pi, int* ti, const int* rows, const int* now,
    const float* counts, const float* zj, const float* p_i, const float* pj,
    const float* zi_new, const float* ei_new, const float* pi_new,
    float* wrow, int W, int A, long long HR, int R, int C, int xr, int xc,
    int Tr, int Tc, int vec, float inv_tau_z, float inv_tau_e,
    float inv_tau_p, float c_ze, float c_ep, float c_zp, float eps,
    float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const Tiling g{R, C, xr, xc, Tr, Tc};
  const dim3 block(32, kRowWarps);
  const dim3 grid((W + kRowWarps - 1) / kRowWarps);
  auto kernel = vec ? fused_row_kernel<true> : fused_row_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      zij, eij, pij, wij, tij, zi, ei, pi, ti, rows, now, counts, zj, p_i, pj,
      zi_new, ei_new, pi_new, wrow, W, A, HR, g, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bcpnn_worklist_row_update(
    float* zij, float* eij, float* pij, float* wij, int* tij,
    const int* g_row, const int* order, const int* nv, const int* now,
    const float* counts, const float* zj, const float* p_i, const float* pj,
    int W, int A, long long HR, int R, int C, int xr, int xc, int Tr, int Tc,
    int vec, float inv_tau_z, float inv_tau_e, float inv_tau_p, float c_ze,
    float c_ep, float c_zp, float eps, float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const Tiling g{R, C, xr, xc, Tr, Tc};
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte segments of rows that share sectors (xr < 8): small blocks
  auto launch = !vec ? launch_worklist<false, 16>
                     : xr < 8 ? launch_worklist<true, 4>
                              : launch_worklist<true, 16>;
  return static_cast<int>(launch(zij, eij, pij, wij, tij, g_row, order, nv,
                                 now, counts, zj, p_i, pj, W, A, HR, g, k,
                                 s));
}

extern "C" int bcpnn_fused_col_update(
    float* zij, float* eij, float* pij, float* wij, int* tij, const float* zi,
    const float* ei, const float* pi, const int* ti, const float* pj,
    const int* h_idx, const int* j_idx, const int* now, int K, int n_hcu,
    int R, int C, int xr, int xc, int Tr, int Tc, float inv_tau_z,
    float inv_tau_e, float inv_tau_p, float c_ze, float c_ep, float c_zp,
    float eps, float eps2, float i_inv_tau_z, float i_inv_tau_e,
    float i_inv_tau_p, float i_c_ze, float i_c_ep, float i_c_zp,
    void* stream) {
  const Coeffs kij{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps,
                   eps2};
  const Coeffs ki{i_inv_tau_z, i_inv_tau_e, i_inv_tau_p, i_c_ze, i_c_ep,
                  i_c_zp, 0.0f, 0.0f};
  const Tiling g{R, C, xr, xc, Tr, Tc};
  const dim3 grid((R + kColThreads - 1) / kColThreads, K);
  fused_col_kernel<<<grid, kColThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      zij, eij, pij, wij, tij, zi, ei, pi, ti, pj, h_idx, j_idx, now, n_hcu,
      g, kij, ki);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bcpnn_row_update(
    const float* z, const float* e, const float* p, const int* t, float* zo,
    float* eo, float* po, float* wo, int* to, const int* now,
    const float* counts, const float* zj, const float* p_i, const float* pj,
    long long S, int A, int C, float inv_tau_z, float inv_tau_e,
    float inv_tau_p, float c_ze, float c_ep, float c_zp, float eps,
    float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const long long n_cells = S * C;
  row_block_kernel<<<cell_grid(n_cells), kBlockThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      z, e, p, t, zo, eo, po, wo, to, now, counts, zj, p_i, pj, n_cells, A, C,
      k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bcpnn_col_update(
    const float* z, const float* e, const float* p, const int* t, float* zo,
    float* eo, float* po, float* wo, int* to, const int* now,
    const float* zi_t, const float* p_i, const float* pj_sc, long long K,
    int R, float inv_tau_z, float inv_tau_e, float inv_tau_p, float c_ze,
    float c_ep, float c_zp, float eps, float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const long long n_cells = K * R;
  col_block_kernel<<<cell_grid(n_cells), kBlockThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      z, e, p, t, zo, eo, po, wo, to, now, zi_t, p_i, pj_sc, n_cells, R, k);
  return static_cast<int>(cudaGetLastError());
}
