// Hopper (sm_90a) kernels for the BCPNN lazy cell update.
//
//   bcpnn_fused_row_update     replaces repro/kernels/bcpnn_update.py
//                              fused_row_update_kernel_call (_fused_row_kernel)
//   bcpnn_fused_col_update     replaces fused_col_update_kernel_call
//                              (_fused_col_kernel)
//   bcpnn_worklist_row_update  replaces worklist_update_kernel_call
//                              (_worklist_kernel)
//   bcpnn_row_update           replaces row_update_kernel_call (_row_kernel)
//   bcpnn_col_update           replaces col_update_kernel_call (_col_kernel)
//
// The first three rewrite the five unpadded (H*R, C) ij planes (z, e, p, w
// float32 and t int32) in place through raw pointers; the fused row kernel
// also rewrites the four (H*R,) i-vectors and emits the per-slot weight rows.
// The last two are elementwise passes over blocks the caller gathered from
// the planes: they read z, e, p, t and write five fresh output blocks. The
// per-cell arithmetic is cell_math of repro_torch/kernels/bcpnn_ref.py in the
// same operation order (expf/logf in float32); the library is built with
// -fmad=false so no multiply-add is contracted that the plain version does
// not contract either.
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

constexpr int kRowWarps = 8;      // worklist slots per block (one warp each)
constexpr int kColThreads = 256;  // column rows per block
constexpr int kBlockThreads = 256;  // cells per block of the block kernels

// One warp rewrites plane row `base / C` in place: its lanes stride over the
// C columns, so every plane access is a coalesced run of consecutive cells.
// dz = cnt * zj_row[c], p_pre, p_post = pj_row[c]; Tij = now. The weight row
// also goes to wrow_out where that is not null.
__device__ __forceinline__ void row_walk(
    float* __restrict__ zij, float* __restrict__ eij, float* __restrict__ pij,
    float* __restrict__ wij, int* __restrict__ tij, long long base,
    const float* __restrict__ zj_row, const float* __restrict__ pj_row,
    float cnt, float p_pre, int now, int C, int lane, const Coeffs& k,
    float* __restrict__ wrow_out) {
  for (int c = lane; c < C; c += 32) {
    const long long i = base + c;
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

// One warp per worklist slot (row_walk). Valid rows are unique network-wide,
// so no two warps ever write the same row.
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
                 int W, int C, long long HR, Coeffs k) {
  const int slot = blockIdx.x * kRowWarps + threadIdx.y;
  if (slot >= W) return;
  const int lane = threadIdx.x;
  const long long e_off = (long long)slot * C;
  const int r = rows[slot];
  if (r < 0 || r >= HR) {  // sentinel slot: no plane write, zero weight row
    for (int c = lane; c < C; c += 32) wrow[e_off + c] = 0.0f;
    return;
  }
  const int now = *now_p;
  row_walk(zij, eij, pij, wij, tij, (long long)r * C, zj + e_off, pj + e_off,
           counts[slot], p_i[slot], now, C, lane, k, wrow + e_off);
  if (lane == 0) {
    zi[r] = zi_new[slot];
    ei[r] = ei_new[slot];
    pi[r] = pi_new[slot];
    ti[r] = now;
  }
}

// The unfused worklist row update: entries are compacted valid-first and
// entry i is live when i < *nv_p and its row is in range. Live entries'
// rows are unique (deduplicated), so warps never share a row; the rest
// write nothing.
__global__ void __launch_bounds__(32 * kRowWarps)
worklist_row_kernel(float* __restrict__ zij, float* __restrict__ eij,
                    float* __restrict__ pij, float* __restrict__ wij,
                    int* __restrict__ tij, const int* __restrict__ rows,
                    const int* __restrict__ nv_p,
                    const int* __restrict__ now_p,
                    const float* __restrict__ counts,
                    const float* __restrict__ zj,
                    const float* __restrict__ p_i,
                    const float* __restrict__ pj, int W, int C, long long HR,
                    Coeffs k) {
  const int slot = blockIdx.x * kRowWarps + threadIdx.y;
  if (slot >= W || slot >= *nv_p) return;
  const int r = rows[slot];
  if (r < 0 || r >= HR) return;
  const long long e_off = (long long)slot * C;
  row_walk(zij, eij, pij, wij, tij, (long long)r * C, zj + e_off, pj + e_off,
           counts[slot], p_i[slot], *now_p, C, threadIdx.x, k, nullptr);
}

// Grid (row blocks, fired entries): each thread rewrites one cell of the
// entry's fired column, (h*R + r)*C + j. Fired HCUs are unique within a
// batch, so entries never share a cell. The cells of one column sit C*4
// bytes apart, so each access costs a 32-byte sector for 4 useful bytes.
__global__ void __launch_bounds__(kColThreads)
fused_col_kernel(float* __restrict__ zij, float* __restrict__ eij,
                 float* __restrict__ pij, float* __restrict__ wij,
                 int* __restrict__ tij, const int* __restrict__ h_idx,
                 const int* __restrict__ j_idx, const int* __restrict__ now_p,
                 const float* __restrict__ zi_t,
                 const float* __restrict__ p_i,
                 const float* __restrict__ pj_sc, int R, int C, int n_hcu,
                 Coeffs k) {
  const int e = blockIdx.y;
  const int h = h_idx[e];
  const int j = j_idx[e];
  if (h < 0 || h >= n_hcu || j < 0 || j >= C) return;  // padding entry
  const int r = blockIdx.x * kColThreads + threadIdx.x;
  if (r >= R) return;
  const int now = *now_p;
  const long long i = ((long long)h * R + r) * C + j;
  const long long v = (long long)e * R + r;
  const float dt = (float)(now - tij[i]);
  float z1, e1, p1, w1;
  cell_math(zij[i], eij[i], pij[i], dt, zi_t[v], p_i[v], pj_sc[e], k, z1, e1,
            p1, w1);
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

}  // namespace

extern "C" int bcpnn_fused_row_update(
    float* zij, float* eij, float* pij, float* wij, int* tij, float* zi,
    float* ei, float* pi, int* ti, const int* rows, const int* now,
    const float* counts, const float* zj, const float* p_i, const float* pj,
    const float* zi_new, const float* ei_new, const float* pi_new,
    float* wrow, int W, int C, long long HR, float inv_tau_z,
    float inv_tau_e, float inv_tau_p, float c_ze, float c_ep, float c_zp,
    float eps, float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const dim3 block(32, kRowWarps);
  const dim3 grid((W + kRowWarps - 1) / kRowWarps);
  fused_row_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      zij, eij, pij, wij, tij, zi, ei, pi, ti, rows, now, counts, zj, p_i, pj,
      zi_new, ei_new, pi_new, wrow, W, C, HR, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bcpnn_worklist_row_update(
    float* zij, float* eij, float* pij, float* wij, int* tij,
    const int* rows, const int* nv, const int* now, const float* counts,
    const float* zj, const float* p_i, const float* pj, int W, int C,
    long long HR, float inv_tau_z, float inv_tau_e, float inv_tau_p,
    float c_ze, float c_ep, float c_zp, float eps, float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const dim3 block(32, kRowWarps);
  const dim3 grid((W + kRowWarps - 1) / kRowWarps);
  worklist_row_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      zij, eij, pij, wij, tij, rows, nv, now, counts, zj, p_i, pj, W, C, HR,
      k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bcpnn_fused_col_update(
    float* zij, float* eij, float* pij, float* wij, int* tij,
    const int* h_idx, const int* j_idx, const int* now, const float* zi_t,
    const float* p_i, const float* pj_sc, int K, int R, int C, int n_hcu,
    float inv_tau_z, float inv_tau_e, float inv_tau_p, float c_ze, float c_ep,
    float c_zp, float eps, float eps2, void* stream) {
  const Coeffs k{inv_tau_z, inv_tau_e, inv_tau_p, c_ze, c_ep, c_zp, eps, eps2};
  const dim3 grid((R + kColThreads - 1) / kColThreads, K);
  fused_col_kernel<<<grid, kColThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      zij, eij, pij, wij, tij, h_idx, j_idx, now, zi_t, p_i, pj_sc, R, C,
      n_hcu, k);
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
