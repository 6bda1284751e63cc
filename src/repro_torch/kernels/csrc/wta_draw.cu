// Hopper (sm_90a) kernel of the tick's soft winner-take-all: the per-HCU
// keys, the fire draw, the Gumbel noise, the support integration and the
// argmax of repro_torch/core/hcu.py wta_draw, in one launch a tick.
//
//   wta_draw_kernel  replaces no TPU kernel. The JAX package draws the
//                    tick's randomness with jax.random (repro/core/engine.py
//                    tick: two fold_in; repro/core/hcu.py periodic_math: a
//                    split, a uniform and a categorical), which XLA fuses.
//                    The port ran the same Threefry-2x32 stream as int64
//                    PyTorch glue (repro_torch/core/rng.py): five block
//                    evaluations of ~170 elementwise operations each, about
//                    900 graph nodes a tick that each cost ~1.1 us and do
//                    almost nothing (three quarters of a 256-HCU tick).
//
// What it computes, bit for bit the plain version's (hcu.wta_draw_plain on
// the card): for HCU h, its key is fold_in(fold_in(base_key, t), gid_base
// + h) (or keys[h] where the caller gives the keys), split into (k0, k1);
// it fires when the float32 uniform of the first word under k0 lies below
// out_rate * dt; the drive is sum_a counts[h, a] * w_rows[h, a, :], added
// in slot order from 0; h' = h * decay + drive; the winner is the first
// maximum over columns of -log(-log(u_c)) + (h' + log(pj + eps)) / temp,
// u_c the uniform in [tiny, 1) of word c under k1 (count c hashed with
// count c + ceil(C/2), the last count of an odd C paired with 0). The
// scale by 1/temp is a multiplication by the float32 reciprocal, as
// PyTorch divides a CUDA tensor by a scalar. Built with -fmad=false: every
// float32 operation rounds as the plain version's separate operations do.
//
// What bounds it on the H100: bytes, and at small sizes one launch. It
// reads the weight rows of the slots that received a spike (nv x C x 4
// bytes: 125 MB at 32,000 HCUs and ~14 live slots of 44 an HCU, 37 us at
// 3.35 TB/s), the slot counts, h and pj, and writes h' and fired. The
// integer work (about 55 Threefry blocks an HCU, ~7 k operations) is 0.2 G
// operations at 32,000 HCUs, a few us on 132 SMs.
//
// Design: one warp an HCU, four HCUs a block. Each lane owns the Gumbel
// pairs i = lane + 32 k (columns i and i + ceil(C/2)): it loads their
// support and Pj first, derives the HCU's keys itself (five dependent
// blocks while those loads are in flight; no shared memory, no barrier),
// hashes its own columns and reads their weights. The slot counts are
// read 32 at a time, one a lane, the next 32 while the current ones are
// summed; a warp ballot of the nonzero ones gives the live slots, whose
// weight rows are loaded four slots at a time and summed in slot order. Skipping a zero-count slot leaves the sum
// as it is (adding +0 or -0 to a float32 sum that starts at +0 changes no
// bit) as long as the skipped weight is finite, which a weight log-ratio
// and the zero rows of padding slots are. A shuffle reduction with
// PyTorch's argmax order (NaN first, then the larger value, then the lower
// index) finds the winner. The time and the base key are read on the
// device, so the launch needs no host value and can be captured in a graph.
//
// Plain C interface (loaded with ctypes): wta_draw launches on the given
// stream and returns the first cudaError_t.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;             // HCUs a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kSlotsInFlight = 4;     // weight rows loaded before summing
constexpr unsigned kFull = 0xffffffffu;
// jnp.finfo(float32).tiny, the uniform's lower bound in gumbel
constexpr float kTiny = 1.17549435082228750797e-38f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py threefry2x32); (x1, x2) in
// and out.
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += k1;
  x2 += k2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, kRot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.uniform's float32 in [0, 1): 23 random mantissa bits under
// the exponent of 1.0, minus 1.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// torch.argmax's order on CUDA: a NaN beats any number, the larger value
// wins, a tie goes to the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

// P: Gumbel pairs a lane (ceil(ceil(C / 2) / 32) rounded up to 1, 2 or 4).
template <int P>
__global__ void __launch_bounds__(kThreads)
wta_draw_kernel(const float* __restrict__ h_in, const float* __restrict__ pj,
                const float* __restrict__ w_rows,
                const float* __restrict__ counts,
                const long long* __restrict__ base_key,
                const int* __restrict__ t, const long long* __restrict__ keys,
                long long gid_base, float* __restrict__ h_out,
                int* __restrict__ fired, int n, int A, int C, float decay,
                float eps, float inv_temp, float thresh) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (h >= n) return;  // the whole warp
  const int half = (C + 1) >> 1;

  // the lane's columns, and their support and Pj loaded ahead of the keys
  const long long cell0 = static_cast<long long>(h) * C;
  int col[2 * P];
  float h0[2 * P], pj0[2 * P], acc[2 * P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = lane + 32 * k;
    col[2 * k] = i < half ? i : -1;
    col[2 * k + 1] = i < half && half + i < C ? half + i : -1;
  }
#pragma unroll
  for (int j = 0; j < 2 * P; ++j) {
    h0[j] = col[j] >= 0 ? h_in[cell0 + col[j]] : 0.0f;
    pj0[j] = col[j] >= 0 ? pj[cell0 + col[j]] : 0.0f;
    acc[j] = 0.0f;
  }

  // the HCU's key: fold_in(fold_in(base_key, t), gid_base + h)
  uint32_t k1, k2;
  if (keys != nullptr) {
    k1 = static_cast<uint32_t>(keys[2 * h]);
    k2 = static_cast<uint32_t>(keys[2 * h + 1]);
  } else {
    uint32_t a = 0, b = static_cast<uint32_t>(*t);
    threefry(static_cast<uint32_t>(base_key[0]),
             static_cast<uint32_t>(base_key[1]), a, b);
    k1 = 0;
    k2 = static_cast<uint32_t>(gid_base + h);
    threefry(a, b, k1, k2);
  }
  // split(key): counts (0, 1) and (2, 3) hashed pairwise; the fire key is
  // the two first words, the noise key the two second words
  uint32_t f1 = 0, n1 = 2, f2 = 1, n2 = 3;
  threefry(k1, k2, f1, n1);
  threefry(k1, k2, f2, n2);
  uint32_t w0 = 0, w1 = 0;
  threefry(f1, f2, w0, w1);
  const bool fire = unit_float(w0) < thresh;

  const long long row0 = static_cast<long long>(h) * A;
  if (counts == nullptr) {  // the drive itself, one row an HCU
#pragma unroll
    for (int j = 0; j < 2 * P; ++j)
      if (col[j] >= 0) acc[j] = w_rows[row0 * C + col[j]];
  } else {
    float next = lane < A ? counts[row0 + lane] : 0.0f;
    for (int base = 0; base < A; base += 32) {
      const float cnt = next;  // the next chunk's counts load meanwhile
      next = base + 32 + lane < A ? counts[row0 + base + 32 + lane] : 0.0f;
      unsigned live = __ballot_sync(kFull, cnt != 0.0f);
      while (live) {  // warp-uniform
        int s[kSlotsInFlight];
        float c[kSlotsInFlight];
        float w[kSlotsInFlight][2 * P];
#pragma unroll
        for (int q = 0; q < kSlotsInFlight; ++q) {
          s[q] = live ? __ffs(live) - 1 : -1;
          live &= live - 1;
          c[q] = __shfl_sync(kFull, cnt, s[q] < 0 ? 0 : s[q]);
        }
#pragma unroll
        for (int q = 0; q < kSlotsInFlight; ++q) {
          const float* row = w_rows + (row0 + base + (s[q] < 0 ? 0 : s[q])) * C;
#pragma unroll
          for (int j = 0; j < 2 * P; ++j)
            w[q][j] = s[q] >= 0 && col[j] >= 0 ? row[col[j]] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kSlotsInFlight; ++q) {
          if (s[q] < 0) break;
#pragma unroll
          for (int j = 0; j < 2 * P; ++j) acc[j] = acc[j] + c[q] * w[q][j];
        }
      }
    }
  }

  float best = -INFINITY;
  int best_c = INT_MAX;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = lane + 32 * k;
    if (i >= half) break;
    uint32_t x1 = static_cast<uint32_t>(i);
    uint32_t x2 = half + i < C ? static_cast<uint32_t>(half + i) : 0u;
    threefry(n1, n2, x1, x2);
    const uint32_t word[2] = {x1, x2};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col[2 * k + e];
      if (c < 0) continue;
      const float hv = h0[2 * k + e] * decay + acc[2 * k + e];
      h_out[cell0 + c] = hv;
      const float s = hv + logf(pj0[2 * k + e] + eps);
      // uniform(minval=tiny): u * (1 - tiny) + tiny, clamped at tiny
      const float u = fmaxf(unit_float(word[e]) * 1.0f + kTiny, kTiny);
      const float g = -logf(-logf(u));
      const float score = g + s * inv_temp;
      if (beats(score, c, best, best_c)) {
        best = score;
        best_c = c;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b = __shfl_xor_sync(kFull, best, off);
    const int bc = __shfl_xor_sync(kFull, best_c, off);
    if (beats(b, bc, best, best_c)) {
      best = b;
      best_c = bc;
    }
  }
  if (lane == 0) fired[h] = fire ? best_c : -1;
}

}  // namespace

extern "C" int wta_draw(const float* h_in, const float* pj,
                        const float* w_rows, const float* counts,
                        const long long* base_key, const int* t,
                        const long long* keys, long long gid_base,
                        float* h_out, int* fired, int n, int A, int C,
                        float decay, float eps, float inv_temp, float thresh,
                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = (C + 1) / 2;
  const unsigned blocks = (n + kWarps - 1) / kWarps;
#define WTA_LAUNCH(P)                                                       \
  wta_draw_kernel<P><<<blocks, kThreads, 0, s>>>(                           \
      h_in, pj, w_rows, counts, base_key, t, keys, gid_base, h_out, fired,  \
      n, A, C, decay, eps, inv_temp, thresh)
  if (half <= 32)
    WTA_LAUNCH(1);
  else if (half <= 64)
    WTA_LAUNCH(2);
  else if (half <= 128)
    WTA_LAUNCH(4);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef WTA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
