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
// be TF32 and miss float32 accuracy). Bound on the H100: 4 * hd FLOP per
// valid pair over the CUDA cores' 67 TFLOP/s; at the qwen2-1.5b prefill
// that is ~220 FLOP per byte of q, k, v and o, far above the float32
// ridge (~20), so the FMA pipe bounds it, and shared memory (128 bytes a
// clock an SM, against 4 warp-wide FMAs a clock) is what starves it: the
// first version issued 12 shared loads per 32 FMAs in Q K^T and a shuffle
// per 4 FMAs in P V. Design:
// FlashAttention-2's loop with both products as register-blocked SGEMM
// micro-tiles:
//   * one block of 8 warps per (b, h, 64-row query tile), the heaviest
//     (last) tiles of every head first; a warp owns 8 query rows, two a
//     lane, so a row's max and sum reduce over 8 lanes (3 shuffles) and
//     the sum stays a per-lane part until the end;
//   * Q (64 rows) and 32-key K / V tiles sit in shared memory in float32,
//     each row padded by 4 floats, so the 8 K rows or 4 Q rows a warp
//     reads at once fall in distinct banks (one 128-byte wavefront);
//   * S = Q K^T: each lane a 2 x 4 tile (2 rows, 4 keys) from float4
//     loads along the head dims, 32 FMAs per 6 loads;
//   * P (64 x 32 float32) goes to shared memory once a tile; P V: each
//     lane a 2-row x hd/8-dim tile of the accumulator in registers from
//     float4 loads of P and V, 128 FMAs per 18 loads at hd 128, no
//     shuffle per key;
//   * K / V tiles arrive by cp.async (16-byte copies where every row is
//     16-byte aligned, else 4-byte) in a two-stage ring: tile i + 1 loads
//     while tile i is multiplied, two barriers a tile (bf16 inputs are
//     widened by the threads instead);
//   * hd is padded to 64, 128 or 256 in shared memory (zero-filled);
//     at hd <= 128, 108 KB of shared memory and <= 128 registers a thread
//     let two blocks (16 warps) share an SM; hd 256 takes 204 KB, one;
//   * expf and IEEE division in float32, as the plain version computes.

// Plain C interface (loaded with ctypes): launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

constexpr int kThreads = 256;   // 8 warps
constexpr int kBQ = 64;         // query rows a block
constexpr int kBK = 32;         // keys a K / V tile
constexpr int kPad = 4;         // floats of padding at the end of a shared row

// blocks an SM the registers and shared memory are sized for: two up to
// hd 128 (108 KB of shared memory, 128 registers), one at hd 256 (204 KB)
template <int HDP>
constexpr int fwd_min_blocks() { return HDP <= 128 ? 2 : 1; }

// Q [kBQ], K [2][kBK] and V [2][kBK] rows of HDP + kPad floats, then
// P [kBQ][kBK + kPad] and two floats a query row
template <int HDP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(kBQ + 4 * kBK) * (HDP + kPad) +
                          (size_t)kBQ * (kBK + kPad + 2));
}

// 4 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [0, ROWS) of a (rows, hd) slice with row stride `stride` into a
// [ROWS][HDP + kPad] float tile, head dims at or past hd zero. float: by
// cp.async, 16 bytes a copy where every row is 16-byte aligned (`vec`),
// else 4; bfloat16: loaded, widened and stored by the threads.
template <typename T, int HDP, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int hd, int tid,
                                      bool vec) {
  constexpr int LD = HDP + kPad;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C = HDP / 4, N = ROWS * C;
#pragma unroll
      for (int it = 0; it < N / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / C, c = (i % C) * 4;
        const bool in = c < hd;
        cp_async16(dst + r * LD + c, src + r * stride + (in ? c : 0), in);
      }
      return;
    }
  }
  constexpr int N = ROWS * HDP;
#pragma unroll 4
  for (int it = 0; it < N / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / HDP, d = i % HDP;
    const bool in = d < hd;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(dst + r * LD + d, src + r * stride + (in ? d : 0), in);
    } else {
      dst[r * LD + d] = in ? __bfloat162float(src[r * stride + d]) : 0.f;
    }
  }
}

// HDP: hd rounded up to 64, 128 or 256 (the padded dims are zero in
// shared memory and add nothing). The two products map threads apart:
//   S: lane l of warp w owns query rows r0 and r0 + 1, r0 = 8 w + 2 (l / 8),
//      and the keys c + 8 j of each tile, c = l % 8: a row lies on 8 lanes
//      of one warp, so its max and sum reduce over 3 shuffles;
//   P V: warp w owns rows 32 (w % 2) + [0, 32) and head dims HDP / 4 (w / 2)
//      + [0, HDP / 4); lane l the rows 32 (w % 2) + l / 4 + 8 i (i < 4) and
//      the dims 4 (l % 4) + 16 q (q < HDP / 64) of them, so a warp's float4
//      loads of P hit 8 consecutive rows and of V 64 contiguous bytes.
// Each row's rescale factor and final sum pass between the two through
// shared memory.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<HDP>())
flash_fwd_kernel(const FlashArgs a, const bool vec) {
  constexpr int LD = HDP + kPad, PLD = kBK + kPad, NQ = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // [kBQ][LD]
  float* sK = sQ + kBQ * LD;        // [2][kBK][LD]
  float* sV = sK + 2 * kBK * LD;    // [2][kBK][LD]
  float* sP = sV + 2 * kBK * LD;    // [kBQ][PLD]
  float* sCorr = sP + kBQ * PLD;    // [kBQ] this tile's rescale of a row
  float* sL = sCorr + kBQ;          // [kBQ] a row's softmax sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = 8 * warp + 2 * (lane >> 3);      // S rows r0, r0 + 1
  const int c = lane & 7;                         // S keys c + 8 j
  const int pr = 32 * (warp & 1) + (lane >> 2);   // P V rows pr + 8 i
  const int pd = HDP / 4 * (warp >> 1) + 4 * (lane & 3);   // dims pd + 16 q
  // x: (b, h); y: query tiles, the heaviest (last) first for every head
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + q0 * a.q_ss +
                h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int t_begin, t_end;
  key_range(a, q0, kBQ, kBK, &t_begin, &t_end);

  stage<T, HDP, kBQ>(sQ, qg, a.q_ss, a.hd, tid, vec);
  if (t_begin < t_end) {
    stage<T, HDP, kBK>(sK, kg + t_begin * a.k_ss, a.k_ss, a.hd, tid, vec);
    stage<T, HDP, kBK>(sV, vg + t_begin * a.v_ss, a.v_ss, a.hd, tid, vec);
  }
  cp_async_commit();

  float acc[4][NQ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's part of the row sums

  int st = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kBK, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();   // tile t0 is in; the other stage and sP are free
    if (t0 + kBK < t_end) {   // the next tile loads while this one is used
      stage<T, HDP, kBK>(sK + (st ^ 1) * kBK * LD, kg + (t0 + kBK) * a.k_ss,
                         a.k_ss, a.hd, tid, vec);
      stage<T, HDP, kBK>(sV + (st ^ 1) * kBK * LD, vg + (t0 + kBK) * a.v_ss,
                         a.v_ss, a.hd, tid, vec);
    }
    cp_async_commit();
    const float* cK = sK + st * kBK * LD;
    const float* cV = sV + st * kBK * LD;

    // S = Q K^T: a 2 x 4 register tile from float4 loads along the head
    // dims; a warp's loads hit 4 Q rows and 8 consecutive K rows, each
    // one 128-byte wavefront
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; d += 4) {
      float4 q[2], k[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) q[i] = ld4(sQ + (r0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = ld4(cK + (c + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
          s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
          s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
          s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask (evaluated only on tiles that cross a mask
    // boundary); the online softmax in float32 with expf; P to shared
    const bool full = t0 + kBK <= a.kv_len &&
                      (!a.causal || t0 + kBK - 1 <= q0) &&
                      (!a.has_window || q0 + kBQ - 1 - t0 < a.window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        if (!full && !key_valid(a, q0 + r0 + i, t0 + c + 8 * j)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        rs += p;
        sP[(r0 + i) * PLD + c + 8 * j] = p;
      }
      l[i] = l[i] * corr + rs;
      if (c == 0) sCorr[r0 + i] = corr;
    }
    __syncthreads();   // P and the rescale factors are complete

    // acc = acc * corr + P V: a 4-row x 4 NQ-dim register tile; per 4
    // keys, 4 float4 loads of P and 4 NQ of V for 64 NQ FMAs, no shuffle
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sCorr[pr + 8 * i];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ld4(sP + (pr + 8 * i) * PLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = ld4(cV + (j + jj) * LD + pd + 16 * q);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                             : jj == 2 ? p[i].z : p[i].w;
            acc[i][q][0] = fmaf(pj, v.x, acc[i][q][0]);
            acc[i][q][1] = fmaf(pj, v.y, acc[i][q][1]);
            acc[i][q][2] = fmaf(pj, v.z, acc[i][q][2]);
            acc[i][q][3] = fmaf(pj, v.w, acc[i][q][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) li += __shfl_xor_sync(kFull, li, o);
    if (c == 0) sL[r0 + i] = li;
  }
  __syncthreads();
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(sL[pr + 8 * i], 1e-30f);
    T* row = og + (q0 + pr + 8 * i) * a.o_ss;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int d = pd + 16 * q;
      if (d < a.hd) {   // hd % 4 == 0: a group of 4 dims is all in or out
#pragma unroll
        for (int e = 0; e < 4; ++e) store(row + d + e, acc[i][q][e] / den);
      }
    }
  }
}

// every row of a (B, S, heads, hd) view starts 16-byte aligned: the base
// and each stride of a dim longer than one (in floats) a multiple of 4
bool rows_aligned(const void* p, long long sb, long long ss, long long sh,
                  int B, int S, int heads) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb % 4 == 0) &&
         (S == 1 || ss % 4 == 0) && (heads == 1 || sh % 4 == 0);
}

template <typename T, int HDP>
cudaError_t launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HDP>;
  const size_t smem = fwd_smem<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = rows_aligned(a.q, a.q_sb, a.q_ss, a.q_sh, a.B, a.Sq, a.H) &&
                   rows_aligned(a.k, a.k_sb, a.k_ss, a.k_sh, a.B, a.Skv, a.Kv) &&
                   rows_aligned(a.v, a.v_sb, a.v_ss, a.v_sh, a.B, a.Skv, a.Kv);
  dim3 grid((unsigned)(a.B * a.H), (unsigned)(a.Sq / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const FlashArgs& a, cudaStream_t s) {
  if (a.hd <= 64) return launch_fwd<T, 64>(a, s);
  if (a.hd <= 128) return launch_fwd<T, 128>(a, s);
  return launch_fwd<T, 256>(a, s);
}

}  // namespace

// a: device pointers, strides and sizes; Sq % 64 == 0, Skv % 64 == 0,
// hd <= 256, Sq / 64 <= 65535, H % Kv == 0 (the wrapper checks). mma != 0
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

