// Hopper (sm_90a) kernels of the tick's fan-out: the delay-queue enqueue of
// repro_torch/core/network.py enqueue_spikes.
//
//   spike_enqueue   replaces no TPU kernel. The JAX package's enqueue
//                   (repro/core/network.py enqueue_spikes) is XLA glue: a
//                   stable sort of every message's key, a cumulative max
//                   over the sorted keys and two scatters. The port ran the
//                   same glue in PyTorch, and at 32,000 HCUs that glue took
//                   about 3.9 of a 10.1-ms tick on an H100: the fired batch
//                   is sized for 35% of the HCUs, so 71% of its 1.12 M
//                   messages are padding, and PyTorch's scan with indices
//                   runs a 1-D cummax on one SM.
//
// What it computes, bit for bit the plain version's: message i (in position
// order) with valid[i] goes to key hb = dest_h*D + (t + delay) % D; its slot
// is count[hb] + rank, rank = #{j < i : valid j, key j == hb}; it is written
// to delay_rows[hb, slot] when slot < A. Then count = min(count + arrivals,
// A) and drops_in grows by what that cut. The delay queue, the counts and
// the drop counter are written to new buffers; the inputs are not touched.
//
// What bounds it on the H100 is bytes: the copy of the (H, D, A) int32 queue
// into the new buffer (read and write: 147 MB at 32,000 HCUs, 44 us at
// 3.35 TB/s), one byte of valid flag a message, 16 bytes a valid message
// (dest_h, delay, dest_row read; its slot written) and 8 bytes a key (its
// count read and written): 158 MB, 47 us, at 32,000 HCUs and 3,200 fired.
//
// Design: a counting sort by key over the valid messages only.
//   enqueue_init_kernel     zeroes the per-key counts;
//   enqueue_count_kernel    one thread a message: a padding message leaves
//                           after reading its flag (no atomic); a valid one
//                           counts itself into its key with an integer
//                           atomic and keeps the place it got (an order that
//                           changes from run to run; nothing depends on it);
//   enqueue_alloc_kernel    one thread a key: a block scan of the counts and
//                           one atomic a block give each key a region of the
//                           message list (regions in any order); the new
//                           count and the block's drops (one atomic a
//                           block); keys of more than kSmallKey messages go
//                           on a list of large keys;
//   enqueue_scatter_kernel  each valid message writes its position into its
//                           key's region;
//   enqueue_place_kernel    a small key (1 to kSmallKey messages, the usual
//                           case: about 3 a key at 32,000 HCUs) takes one
//                           thread, which ranks each position by counting
//                           the smaller ones; a large key (the skew of a
//                           recall tick, about 86 messages into one bucket
//                           a HCU) takes a block, which bitonic-sorts its
//                           positions in shared memory kChunk at a time,
//                           keeping the A - count smallest. Either writes
//                           the first A - count positions, in position
//                           order, into the key's free slots.
// No pass sorts or scans the message array, padding messages do one byte of
// work, the work grows with the valid messages and the keys, and the output
// does not depend on the order the atomics land in. Every size arrives as a
// launch argument and the current time as a device pointer, so the launches
// need no host value and the tick never synchronises.
//
// Plain C interface (loaded with ctypes): spike_enqueue launches on the
// given stream and returns the first cudaError_t.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;    // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kSmallKey = 16;    // keys of at most this many messages: a thread
constexpr int kChunk = 1024;     // a large key's positions sorted at a time
constexpr int kBigBlocks = 264;  // blocks sharing out the large keys (2 an SM)

// Key of message i, or -1 for padding (and for an HCU out of range, which
// the plain version would fault on).
__device__ __forceinline__ int message_key(long long i,
                                           const unsigned char* valid,
                                           const int* dest_h, const int* delay,
                                           int t, int n, int D) {
  if (!valid[i]) return -1;
  const int h = dest_h[i];
  if (h < 0 || h >= n) return -1;
  int b = (t + delay[i]) % D;
  if (b < 0) b += D;  // the plain version's % takes the divisor's sign
  return h * D + b;
}

__global__ void enqueue_init_kernel(int* cnt, int n_keys, int* counters,
                                    const int* drops_in, int* drops_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_keys) cnt[k] = 0;
  if (k < 2) counters[k] = 0;  // list allocated, large keys
  if (k == 0) *drops_out = *drops_in;
}

__global__ void enqueue_count_kernel(const unsigned char* valid,
                                     const int* dest_h, const int* delay,
                                     const int* now, int n, int D, long long M,
                                     int* cnt, int* pos) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int k = message_key(i, valid, dest_h, delay, *now, n, D);
  if (k >= 0) pos[i] = atomicAdd(&cnt[k], 1);
}

__global__ void enqueue_alloc_kernel(const int* cnt, const int* count_in,
                                     int n_keys, int A, int* off,
                                     int* count_out, int* counters, int* big,
                                     int* drops_out) {
  __shared__ int warp_base[kWarps];
  __shared__ int warp_drop[kWarps];
  __shared__ int block_base;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int c = 0, drop = 0;
  if (k < n_keys) {
    c = cnt[k];
    // int32 arithmetic that wraps, as the plain version's
    const int total = (int)((unsigned)count_in[k] + (unsigned)c);
    const int kept = min(total, A);
    count_out[k] = kept;
    drop = (int)((unsigned)total - (unsigned)kept);
    if (c > kSmallKey) big[atomicAdd(&counters[1], 1)] = k;
  }
  int incl = c;  // inclusive scan of the counts within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int wdrop = __reduce_add_sync(0xffffffffu, drop);
  if (lane == 31) warp_base[w] = incl;
  if (lane == 0) warp_drop[w] = wdrop;
  __syncthreads();
  if (w == 0) {
    const int v = lane < kWarps ? warp_base[lane] : 0;
    int winc = v;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += y;
    }
    const int bdrop =
        __reduce_add_sync(0xffffffffu, lane < kWarps ? warp_drop[lane] : 0);
    if (lane < kWarps) warp_base[lane] = winc - v;
    if (lane == kWarps - 1) block_base = atomicAdd(&counters[0], winc);
    if (lane == 0 && bdrop != 0) atomicAdd(drops_out, bdrop);
  }
  __syncthreads();
  if (k < n_keys) off[k] = block_base + warp_base[w] + incl - c;
}

__global__ void enqueue_scatter_kernel(const unsigned char* valid,
                                       const int* dest_h, const int* delay,
                                       const int* now, int n, int D,
                                       long long M, const int* off,
                                       const int* pos, int* list) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int k = message_key(i, valid, dest_h, delay, *now, n, D);
  if (k >= 0) list[off[k] + pos[i]] = (int)i;
}

// Ascending bitonic sort of buf[0, P), P a power of two, by the block.
__device__ void block_sort(int* buf, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const int a = buf[i], b = buf[j];
          if ((a > b) == ((i & size) == 0)) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Slots a key still has: A - count, within [0, A] (counts lie in [0, A]).
__device__ __forceinline__ int free_slots(int count, int A) {
  return min(max(A - count, 0), A);
}

// Blocks [0, key_blocks) place the small keys, a thread a key; the
// kBigBlocks blocks after them share out the large keys, a block a key.
__global__ void enqueue_place_kernel(const int* cnt, const int* off,
                                     const int* list, const int* count_in,
                                     const int* counters, const int* big,
                                     const int* dest_row, int n_keys, int A,
                                     int key_blocks, int* rows_out) {
  if ((int)blockIdx.x < key_blocks) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n_keys) return;
    const int c = cnt[k];
    if (c == 0 || c > kSmallKey) return;
    const int count = count_in[k];
    const int keep = free_slots(count, A);
    const int* l = list + off[k];
    int* q = rows_out + (long long)k * A;
    for (int a = 0; a < c; ++a) {
      const int e = l[a];
      int r = 0;
      for (int b = 0; b < c; ++b) r += l[b] < e;
      if (r < keep && count + r >= 0) q[count + r] = dest_row[e];
    }
    return;
  }
  __shared__ int buf[2 * kChunk];
  const int n_big = counters[1];
  for (int b = blockIdx.x - key_blocks; b < n_big; b += kBigBlocks) {
    const int k = big[b];
    const int c = cnt[k], count = count_in[k];
    const int keep = free_slots(count, A);
    if (keep == 0) continue;
    const int* l = list + off[k];
    int have = 0;  // buf[0, have): the smallest positions so far, sorted
    for (int s = 0; s < c; s += kChunk) {
      const int m = min(kChunk, c - s);
      const int tot = have + m;
      int P = 1;
      while (P < tot) P <<= 1;
      for (int i = threadIdx.x; i < m; i += blockDim.x) buf[have + i] = l[s + i];
      for (int i = tot + threadIdx.x; i < P; i += blockDim.x) buf[i] = INT_MAX;
      __syncthreads();
      block_sort(buf, P);
      have = min(keep, tot);
    }
    int* q = rows_out + (long long)k * A;
    for (int r = threadIdx.x; r < have; r += blockDim.x) {
      if (count + r >= 0) q[count + r] = dest_row[buf[r]];
    }
    __syncthreads();  // buf is the next key's
  }
}

}  // namespace

// rows_in / rows_out (n, D, A), count_in / count_out (n, D), drops_in /
// drops_out and now one int32 each; dest_h / dest_row / delay (M,) int32 and
// valid (M,) bool; scratch 3*n*D + 2 + 2*M int32. A <= kChunk.
extern "C" int spike_enqueue(const int* rows_in, int* rows_out,
                             const int* count_in, int* count_out,
                             const int* drops_in, int* drops_out,
                             const int* now, const int* dest_h,
                             const int* dest_row, const int* delay,
                             const unsigned char* valid, int* scratch,
                             long long M, int n, int D, int A, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_keys = n * D;
  int* cnt = scratch;
  int* off = cnt + n_keys;
  int* big = off + n_keys;
  int* counters = big + n_keys;
  int* pos = counters + 2;
  int* list = pos + M;
  cudaError_t err = cudaMemcpyAsync(rows_out, rows_in,
                                    (size_t)n_keys * A * sizeof(int),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int key_blocks = (n_keys + kThreads - 1) / kThreads;
  const unsigned msg_blocks = (unsigned)((M + kThreads - 1) / kThreads);
  enqueue_init_kernel<<<key_blocks, kThreads, 0, s>>>(cnt, n_keys, counters,
                                                      drops_in, drops_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    enqueue_count_kernel<<<msg_blocks, kThreads, 0, s>>>(
        valid, dest_h, delay, now, n, D, M, cnt, pos);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  enqueue_alloc_kernel<<<key_blocks, kThreads, 0, s>>>(
      cnt, count_in, n_keys, A, off, count_out, counters, big, drops_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    enqueue_scatter_kernel<<<msg_blocks, kThreads, 0, s>>>(
        valid, dest_h, delay, now, n, D, M, off, pos, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    enqueue_place_kernel<<<key_blocks + kBigBlocks, kThreads, 0, s>>>(
        cnt, off, list, count_in, counters, big, dest_row, n_keys, A,
        key_blocks, rows_out);
  }
  return static_cast<int>(cudaGetLastError());
}
