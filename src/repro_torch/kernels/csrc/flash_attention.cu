// Hopper (sm_90a) forward flash attention: two kernels behind one entry.
//
//   flash_mma_kernel   bfloat16, hd a multiple of 16 up to 256
//   flash_fwd_kernel   float32, and bfloat16 with another hd (a multiple
//                      of 4 up to 256)
//
// Both replace repro/kernels/flash_attention.py flash_attention
// (_flash_kernel). The wrapper (kernels/flash_attention.py) picks one by
// dtype and head dim alone.
//
// For q (B, Sq, H, hd) and k / v (B, Skv, Kv, hd), H % Kv == 0, each a
// strided view with a contiguous last dim (query head h reads kv head
// h / (H / Kv), the order jnp.repeat gives; k / v may be a KV cache read
// in place): logits = (q . k) * scale in float32; tanh(logits / softcap) *
// softcap where softcap != 0; -1e30 (not -inf) where the key is masked
// (key >= kv_len, key > query when causal, query - key >= window when a
// window is given; query positions count from 0 at the first row); an
// online softmax in float32; PV in float32; o (B, Sq, H, hd) = acc /
// max(l, 1e-30) in the input dtype.
//
// Key tiles masked for every row of a query tile are skipped when the
// tile's last row has a valid key (then every row has one, and a masked
// tile changes nothing: before a row's first valid key its sums are erased
// by exp(-1e30 - m) = 0, after it they gain exp(-1e30 - m) = 0). Otherwise
// every tile runs, as the JAX kernel runs them. Both kernels run the
// heaviest (last) query tiles first.
//
// flash_mma_kernel. Bound on the H100: 4 * hd FLOP per valid (q, k) pair
// against the bytes of q, o and the per-kv-head k, v: ~440 FLOP/byte at
// the qwen2-1.5b prefill (GQA 6), above the bf16 ridge of ~295, so the
// tensor cores bound it. Design (FlashAttention-2 on mma.sync, not wgmma):
//   * one block of 4 warps per (b, h, 64-row query tile); each warp owns
//     16 query rows; S = Q K^T and the output accumulator stay in
//     registers as mma.sync.m16n8k16 bf16 fragments with float32
//     accumulation, so Q K^T is exact per product as in JAX;
//   * K / V tiles of 32 keys arrive by cp.async in a two-stage ring: tile
//     i + 1 loads while tile i is multiplied; Q, K and V sit in shared
//     memory with their 16-byte chunks XOR-swizzled by row, so ldmatrix
//     (.trans for V) reads them without bank conflicts; head dims past hd
//     are zero-filled by the copy (hd 48 runs as 64);
//   * P never touches shared memory: the S accumulator fragment is the A
//     fragment of P V. JAX multiplies P by V in float32, and one bf16
//     rounding of P (2^-9 relative per weight) would give errors that do
//     not shrink with |out|, so P is split into hi = bf16(p) and lo =
//     bf16(p - hi) and both are multiplied by the exact bf16 V (relative
//     error ~2^-17): the P V products cost twice their FLOPs;
//   * the grid is (b * h, query tile), the last (heaviest causal) query
//     tiles of every head launching first, so the light tiles fill the
//     tail; the query heads of a kv head (six in qwen2-1.5b) run side by
//     side and share its K / V tiles in L2;
//   * 32-key tiles keep a thread at 128 registers up to hd 128 (48 KB of
//     shared memory a block), so four blocks share an SM and hide each
//     other's latency (hd 256: 96 KB, two blocks an SM);
//   * the mask is evaluated only on tiles that cross a mask boundary;
//     logits are kept in log2 units (scale * log2 e folded in), so each
//     exp is one MUFU.EX2 in float32; softcap with tanhf.
//
// flash_fwd_kernel (float32 on the CUDA cores: a tensor-core product would
// be TF32 and miss float32 accuracy). Bound: 4 * hd FLOP per valid pair
// over 67 TFLOP/s. Design: one block per (b, h, 64-row query tile), 8 warps
// of 8 query rows each, the query tile in shared memory in float32; 32-key
// K / V tiles staged synchronously in float32, K transposed with a padded
// row (lane j reads key j with no bank conflict); lane j owns key j for
// the logits, the softmax reduces over the warp with shuffles, and in PV
// each lane owns head dims lane + 32 i and takes p_j from lane j.
//
// Plain C interface (loaded with ctypes): launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element strides of (batch, sequence, head); the last dim is contiguous.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, Kv, Sq, Skv, hd, kv_len, causal, has_window, window;
  float scale, softcap;   // softcap 0: none
  // flash_mma_kernel's logits in log2 units: x = s * mma_scale, then with
  // a softcap x = tanh(x * inv_softcap) * mma_softcap (kernel parameters
  // cost no registers)
  float mma_scale;     // scale * log2 e, or scale with a softcap
  float inv_softcap;   // 1 / softcap
  float mma_softcap;   // softcap * log2 e
};

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool key_valid(const FlashArgs& a, int qp, int key) {
  return key < a.kv_len && (!a.causal || qp >= key) &&
         (!a.has_window || qp - key < a.window);
}

// [begin, end) of the key tiles (of bk keys) a query tile [q0, q0 + bq)
// visits: the tiles that can hold a valid key for some row when its last
// row has one, else all of them.
__device__ __forceinline__ void key_range(const FlashArgs& a, int q0, int bq,
                                          int bk, int* begin, int* end) {
  const int q_last = q0 + bq - 1;
  const int lo_last = a.has_window ? max(0, q_last - a.window + 1) : 0;
  const int hi_last = min(a.kv_len, a.causal ? q_last + 1 : a.Skv);
  *begin = 0;
  *end = a.Skv;
  if (lo_last < hi_last) {
    const int lo_first = a.has_window ? max(0, q0 - a.window + 1) : 0;
    *begin = lo_first / bk * bk;
    *end = min(a.Skv, (hi_last + bk - 1) / bk * bk);
  }
}

// ---------------------------------------------------------------------------
// flash_mma_kernel: bf16 tensor cores

constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaBQ = 64;         // query rows a block, 16 a warp
constexpr int kMmaBK = 32;         // keys a K / V tile

// blocks an SM the registers are sized for: 4 (128 registers) up to hd 128
// (48 KB of shared memory a block), 1 at hd 256 (96 KB, 255 registers).
// Without a softcap nothing spills up to hd 128; with one, tanhf's slow
// path is a call, around which ptxas saves 12-20 bytes a thread
template <int HD>
constexpr int mma_min_blocks() { return HD <= 128 ? 4 : 1; }

template <int HD>
constexpr size_t mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)HD * (kMmaBQ + 4 * kMmaBK);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// [rows][HD] tile: eight rows reading one logical chunk hit eight distinct
// 16-byte bank groups
template <int HD>
__device__ __forceinline__ int sw(int row, int chunk) {
  constexpr int C = HD / 8;
  constexpr int kRowsPerLine = C >= 8 ? 1 : 8 / C;
  constexpr int kSwz = (C >= 8 ? 8 : C) - 1;
  return row * HD + ((chunk ^ ((row / kRowsPerLine) & kSwz)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 float32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in float32 (MUFU.EX2: ~2 ulp; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) as hi = bf16(.) and lo = bf16(. - hi), packed low half first
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// rows [0, ROWS) of a (rows, hd) slice with row stride `stride` into a
// swizzled [ROWS][HD] tile; chunks at or past hd are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int hd, int tid) {
  constexpr int C = HD / 8, N = ROWS * C;   // chunks of the tile
#pragma unroll
  for (int it = 0; it < (N + kMmaThreads - 1) / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    if (N % kMmaThreads == 0 || i < N) {
      const int r = i / C, c = i % C;
      const bool in = c * 8 < hd;
      cp_async16(dst + sw<HD>(r, c), src + r * stride + (in ? c * 8 : 0), in);
    }
  }
}

// CAP: a softcap is given (tanhf only in the kernels that need it)
template <int HD, bool CAP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<HD>())
flash_mma_kernel(const FlashArgs a) {
  constexpr int BK = kMmaBK, BQ = kMmaBQ;
  constexpr int NS = BK / 8;   // n-tiles of S
  constexpr int NO = HD / 8;   // n-tiles of the output
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][HD]
  bf16* sK = sQ + BQ * HD;                         // [2][BK][HD]
  bf16* sV = sK + 2 * BK * HD;                     // [2][BK][HD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // x: (b, h); y: query tiles, the heaviest (last) first for every head
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb +
                   q0 * a.q_ss + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int t_begin, t_end;
  key_range(a, q0, BQ, BK, &t_begin, &t_end);

  load_tile<HD, BQ>(sQ, qg, a.q_ss, a.hd, tid);
  if (t_begin < t_end) {
    load_tile<HD, BK>(sK, kg + t_begin * a.k_ss, a.k_ss, a.hd, tid);
    load_tile<HD, BK>(sV, vg + t_begin * a.v_ss, a.v_ss, a.hd, tid);
  }
  cp_async_commit();

  const int row_w = warp * 16;   // the warp's first row in the tile
  // ldmatrix row / chunk offsets of this lane: A (Q) fragments, B (K)
  // fragments of two n-tiles, B (V, transposed) fragments of two n-tiles
  const int a_row = row_w + (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += BK, stage ^= 1) {
    if (t0 + BK < t_end) {   // the next tile loads while this one is used
      load_tile<HD, BK>(sK + (stage ^ 1) * BK * HD, kg + (t0 + BK) * a.k_ss,
                        a.k_ss, a.hd, tid);
      load_tile<HD, BK>(sV + (stage ^ 1) * BK * HD, vg + (t0 + BK) * a.v_ss,
                        a.v_ss, a.hd, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * BK * HD;
    const bf16* cV = sV + stage * BK * HD;

    // S = Q K^T for the warp's 16 rows
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned qa[4];
      ldsm_x4(qa, sQ + sw<HD>(a_row, 2 * kk + a_chunk));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        unsigned kb[4];
        ldsm_x4(kb, cK + sw<HD>(8 * j + k_row, 2 * kk + k_chunk));
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, softcap, mask; element (j, e) is row g + 8 (e >> 1), key
    // 8 j + 2 t + (e & 1)
    const bool full = t0 + BK <= a.kv_len && (!a.causal || t0 + BK - 1 <= q0) &&
                      (!a.has_window || q0 + BQ - 1 - t0 < a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // in log2 units (x log2 e), so p = 2^(x - m) is one MUFU.EX2
        float x = s[j][e] * a.mma_scale;
        if (CAP) x = tanhf(x * a.inv_softcap) * a.mma_softcap;
        if (!full && !key_valid(a, q0 + row_w + g + (e >> 1) * 8,
                                t0 + 8 * j + 2 * t + (e & 1)))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // a row's four lanes (t = 0..3) share its maximum
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};   // this lane's part of the row sums
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += (P_hi + P_lo) V: S n-tiles 2 kk and 2 kk + 1 form the A
    // fragment of keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vb[4];
        ldsm_x4_t(vb, cV + sw<HD>(16 * kk + v_row, n + v_chunk));
        mma_bf16(acc[n], ph, vb[0], vb[1]);
        mma_bf16(acc[n], pl, vb[0], vb[1]);
        mma_bf16(acc[n + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[n + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is read before the copy two tiles on
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh +
             (q0 + row_w + g) * a.o_ss;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < a.hd) {   // padded head dims are not stored
      const int d = 8 * n + 2 * t;
      // __fdividef: within 2 ulp before the bf16 rounding, and no slow-path
      // call (whose saved registers would spill at the 128-register cap)
      *reinterpret_cast<__nv_bfloat162*>(og + d) = __floats2bfloat162_rn(
          __fdividef(acc[n][0], den[0]), __fdividef(acc[n][1], den[0]));
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * a.o_ss + d) =
          __floats2bfloat162_rn(__fdividef(acc[n][2], den[1]),
                                __fdividef(acc[n][3], den[1]));
    }
  }
}

template <int HD>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t stream) {
  auto kern = a.softcap != 0.f ? flash_mma_kernel<HD, true>
                               : flash_mma_kernel<HD, false>;
  const size_t smem = mma_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.H), (unsigned)(a.Sq / kMmaBQ));
  kern<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const FlashArgs& a, cudaStream_t s) {
  if (a.hd <= 16) return launch_mma<16>(a, s);
  if (a.hd <= 32) return launch_mma<32>(a, s);
  if (a.hd <= 64) return launch_mma<64>(a, s);
  if (a.hd <= 128) return launch_mma<128>(a, s);
  return launch_mma<256>(a, s);
}

// ---------------------------------------------------------------------------
// flash_fwd_kernel: float32 on the CUDA cores

constexpr int kBQ = 64;                 // query rows per block
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kBK = 32;                 // keys per tile, one per lane
constexpr int kKtStride = kBK + 1;      // padded row of the transposed K tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)hd * (kBQ + kKtStride + kBK);
}

// NV = head dims per lane: hd <= 32 * NV, hd % 4 == 0.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  float* sQ = smem;                      // [kBQ][hd]
  float* sKt = sQ + kBQ * hd;            // [hd][kKtStride]
  float* sV = sKt + hd * kKtStride;      // [kBK][hd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.Kv);
  // the heaviest causal tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + q0 * a.q_ss +
                h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + q0 * a.o_ss + h * a.o_sh;

  for (int i = tid; i < kBQ * hd; i += kWarps * 32) {
    const int r = i / hd, d = i - r * hd;
    sQ[i] = to_f(qg[r * a.q_ss + d]);
  }

  int t_begin, t_end;
  key_range(a, q0, kBQ, kBK, &t_begin, &t_end);

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    for (int i = tid; i < kBK * hd; i += kWarps * 32) {
      const int j = i / hd, d = i - j * hd;
      sKt[d * kKtStride + j] = to_f(kg[(t0 + j) * a.k_ss + d]);
      sV[i] = to_f(vg[(t0 + j) * a.v_ss + d]);
    }
    __syncthreads();

    // logits of the warp's rows against key t0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      const float k0 = sKt[(d + 0) * kKtStride + lane];
      const float k1 = sKt[(d + 1) * kKtStride + lane];
      const float k2 = sKt[(d + 2) * kKtStride + lane];
      const float k3 = sKt[(d + 3) * kKtStride + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + r) * hd + d);
        s[r] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }

    const int key = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
      float x = s[r] * a.scale;
      if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
      x = key_valid(a, qp, key) ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      s[r] = p;
    }

    // acc[r][d] += sum_j p[r][j] * v[j][d]
    for (int j = 0; j < kBK; ++j) {
      float vv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < hd ? sV[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
    T* row = og + (r0 + r) * a.o_ss;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store(row + d, acc[r][i] / den);
    }
  }
}

template <typename T, int NV>
cudaError_t launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NV>;
  const size_t smem = smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.Sq / kBQ), (unsigned)(a.B * a.H));
  kern<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const FlashArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch_fwd<T, 1>(a, s);
  if (a.hd <= 64) return launch_fwd<T, 2>(a, s);
  if (a.hd <= 128) return launch_fwd<T, 4>(a, s);
  return launch_fwd<T, 8>(a, s);
}

}  // namespace

// a: device pointers, strides and sizes; Sq % 64 == 0, Skv % 64 == 0,
// hd <= 256, B * H <= 65535, H % Kv == 0 (the wrapper checks). mma != 0
// takes flash_mma_kernel (bf16, hd % 16 == 0, 16-byte aligned rows), else
// flash_fwd_kernel (hd % 4 == 0). softcap 0 means none.
extern "C" int flash_attention_fwd(const FlashArgs* a, int mma, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->hd <= 0 || a->hd > 256 || a->Kv <= 0 || a->H % a->Kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mma) {
    if (!is_bf16 || a->hd % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_mma(*a, s));
  }
  if (a->hd % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(is_bf16 ? dispatch_fwd<__nv_bfloat16>(*a, s)
                                  : dispatch_fwd<float>(*a, s));
}

