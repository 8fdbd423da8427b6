// The trace registry's stamp (ops/tracing.py): one thread reads the
// device's global nanosecond timer, charges the interval since the
// previous stamp to one stage's slots and makes this stamp the previous
// one. Launched on the traced stream between the work it separates, so a
// CUDA graph captured with tracing on holds it as a node and every replay
// adds into the same slots.
//
// slots (int64): [0] the previous stamp's time (0 before the first), and
// per stage s [1 + 2s] its nanoseconds and [2 + 2s] the intervals charged
// to it. One stream writes them, in order, so no atomics are needed.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slots, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long last = slots[0];
  if (last != 0) {
    slots[1 + 2 * stage] += static_cast<long long>(now) - last;
    slots[2 + 2 * stage] += 1;
  }
  slots[0] = static_cast<long long>(now);
}

}  // namespace

extern "C" int stamp(long long* slots, int stage, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots,
                                                                 stage);
  return static_cast<int>(cudaGetLastError());
}
