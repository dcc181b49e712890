// The tracer's device marks (utils/timing.py): one thread writes the
// card's global nanosecond timer (%globaltimer) into a slot of a buffer.
//
// A layer mark inside a step is captured into the step's CUDA graph. As a
// kernel it is one more kernel node of the graph; a timing event there is
// an event record node, which cost the graph's launch and the device about
// 5 us each (an H100: 61 such nodes among 2000 small kernels added 0.31 ms
// of host launch and 0.26 ms of device time to a replay). The slot's value
// is read on the host after the stream has passed it.

#include <stdint.h>

#include <cuda_runtime.h>

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

// Launch the stamp of `slot` (a device address of 8 bytes) on `stream`;
// returns the launch's cudaError_t.
extern "C" int stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)slot);
  return (int)cudaGetLastError();
}
