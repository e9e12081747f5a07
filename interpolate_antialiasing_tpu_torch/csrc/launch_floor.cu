// An empty kernel: the device time of a launch that does no work, at a
// given grid, as a floor beside a small kernel's bytes bound
// (utils/timing.launch_floor_ms).  It replaces no TPU kernel and no path of
// the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// `blocks` blocks of `threads` threads of the empty kernel on `stream`;
// returns the cudaError_t of the launch (0 on success).
int ia_launch_floor(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
