// Device marks of the tick recorder (repro_torch/core/spans.py).
//
//   span_mark   one thread writes the device's %globaltimer (a 64-bit
//               nanosecond clock shared by every SM) into one int64 slot
//
// A mark is launched on the caller's stream where a phase of the tick ends,
// so it runs when the phase's last operation has finished, and it is
// captured into a chunk's CUDA graph like any other kernel: every replay of
// the graph rewrites the slot. It touches nothing but its slot.
#include <cuda_runtime.h>

namespace {

__global__ void span_mark_kernel(long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = static_cast<long long>(t);
}

}  // namespace

extern "C" int span_mark(long long* slot, void* stream) {
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slot);
  return static_cast<int>(cudaGetLastError());
}
