// Hopper (sm_90a) forward flash attention.
//
//   flash_attention_fwd   replaces repro/kernels/flash_attention.py
//                         flash_attention (_flash_kernel)
//
// For q (BH, Sq, hd) and k / v (BH, Skv, hd), contiguous, float32 or
// bfloat16: logits = (q . k) * scale in float32; tanh(logits / softcap) *
// softcap where softcap != 0; -1e30 (not -inf) where the key is masked
// (key >= kv_len, key > query when causal, query - key >= window when a
// window is given; query positions count from 0 at the first row); an
// online softmax in float32; PV in float32; out = acc / max(l, 1e-30) in
// the input dtype.
//
// Bound on the H100: at the prefill shapes the causally needed work is
// ~240 FLOP per byte of q, k, v and o, near the bf16 tensor-core ridge.
// This first kernel does the products on the CUDA cores in float32; its
// design is plain and correct first:
//   * one block per (bh, 64-row query tile), 8 warps of 8 query rows each;
//     the query tile sits in shared memory in float32;
//   * 32-key K / V tiles are staged through shared memory in float32, K
//     transposed with a padded row (lane j reads key j with no bank
//     conflict), V row-major (lane d reads column d);
//   * the logits of a warp's 8 rows against a tile: lane j owns key j;
//     the online-softmax update reduces over the warp with shuffles; PV:
//     each lane owns head dims lane + 32 i, i < NV, and takes p_j from
//     lane j by shuffle;
//   * the running max, sum and accumulator stay in float32 registers;
//   * key tiles masked for every row of the query tile are skipped when
//     the tile's last row has a valid key (then every row has one, and a
//     masked tile changes nothing: before a row's first valid key its sums
//     are erased by exp(-1e30 - m) = 0, after it they gain exp(-1e30 - m)
//     = 0). Otherwise every tile runs, as the JAX kernel runs them.
//
// Plain C interface (loaded with ctypes): launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kBK = 32;                 // keys per tile, one per lane
constexpr int kKtStride = kBK + 1;      // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int hd, int kv_len, int causal, int has_window, int window,
                 float scale, float softcap) {
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBQ][hd]
  float* sKt = sQ + kBQ * hd;            // [hd][kKtStride]
  float* sV = sKt + hd * kKtStride;      // [kBK][hd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  // the heaviest causal tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t q_base = ((size_t)bh * Sq + q0) * hd;
  const size_t kv_base = (size_t)bh * Skv * hd;

  for (int i = tid; i < kBQ * hd; i += kWarps * 32) sQ[i] = to_f(q[q_base + i]);

  // key range that can hold a valid key for some row of this tile
  const int q_last = q0 + kBQ - 1;
  const int lo_last = has_window ? max(0, q_last - window + 1) : 0;
  const int hi_last = min(kv_len, causal ? q_last + 1 : Skv);
  int t_begin = 0, t_end = Skv;
  if (lo_last < hi_last) {
    const int lo_first = has_window ? max(0, q0 - window + 1) : 0;
    t_begin = lo_first / kBK * kBK;
    t_end = min(Skv, (hi_last + kBK - 1) / kBK * kBK);
  }

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
      const size_t g = kv_base + (size_t)t0 * hd + i;
      sKt[d * kKtStride + j] = to_f(k[g]);
      sV[i] = to_f(v[g]);
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
      float x = s[r] * scale;
      if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
      const bool ok = key < kv_len && (!causal || qp >= key) &&
                      (!has_window || qp - key < window);
      x = ok ? x : kNegInf;
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
    T* row = o + q_base + (size_t)(r0 + r) * hd;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store(row + d, acc[r][i] / den);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int hd, int kv_len, int causal,
                   int has_window, int window, float scale, float softcap,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NV>;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(Sq / kBQ), (unsigned)BH);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, hd, kv_len,
      causal, has_window, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Skv, int hd, int kv_len, int causal,
                     int has_window, int window, float scale, float softcap,
                     cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, o, BH, Sq, Skv, hd, kv_len, causal,
                        has_window, window, scale, softcap, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, o, BH, Sq, Skv, hd, kv_len, causal,
                        has_window, window, scale, softcap, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, o, BH, Sq, Skv, hd, kv_len, causal,
                        has_window, window, scale, softcap, stream);
  return launch<T, 8>(q, k, v, o, BH, Sq, Skv, hd, kv_len, causal,
                      has_window, window, scale, softcap, stream);
}

}  // namespace

// q, k, v, o: device pointers; Sq % 64 == 0, Skv % 32 == 0, hd % 4 == 0,
// hd <= 256, BH <= 65535 (the wrapper checks). softcap 0 means none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BH, int Sq,
                                   int Skv, int hd, int kv_len, int causal,
                                   int has_window, int window, int is_bf16,
                                   float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, hd, kv_len,
                                        causal, has_window, window, scale,
                                        softcap, s)
              : dispatch<float>(q, k, v, o, BH, Sq, Skv, hd, kv_len, causal,
                                has_window, window, scale, softcap, s);
  return static_cast<int>(err);
}
