// One Pillow 8bpc fixed-point pass over one axis: uint8 x viewed as [outer,
// n_in, inner] -> uint8 out [outer, n_out, inner].  inner == 1 is a pass over
// the last axis; NHWC and NCHW both run through the view, with no moves.
//
// Replaces interpolate_antialiasing_tpu/ops/pil_exact.py::_kernel_mid_digit
// (wrapper digit_pass_mid_dynamic), the H pass of the sharded byte-exact
// route, and also runs that route's shard-local W pass.  The TPU kernel
// contracts per-shard int8 digit bands with traced window starts on its
// matrix unit and recombines the digits; here each output is a direct
// windowed int32 multiply-accumulate over Pillow's compact tables (xmin[out],
// Wb[out, ntaps]), which gives the same bytes as the dense integer pass:
//
//   acc = (1 << (pb-1)) + sum_k Wb[o,k] * x[j, clamp(xmin[o]+k, 0, n_in-1), i]
//   out[j, o, i] = clip(acc >> pb, 0, 255)   (arithmetic shift, then clip8)
//
// The tables are runtime values on the card, so one launch serves any shard's
// tables.  Taps past a row's window carry zero weight, so the clamp never
// adds signal; a shard's wrap-around halo rows are reached only through zero
// weights.  The clip always runs: the TPU skips it only where it changes no
// byte (_needs_clip).  The host wrapper checks 255 * max row sum|Wb| +
// 2^(pb-1) < 2^31 before every launch, so the int32 accumulator cannot
// overflow (Pillow's `ss` is int32 too).
//
// Design: one thread per output element over the flat output index
// ((j * n_out + o) * inner + i), so neighbouring threads take neighbouring
// inner elements (a coalesced row of the middle-axis pass) or, when inner
// == 1, neighbouring outputs whose windows overlap in cache.  A grid-stride
// loop with 64-bit indices covers any element count.
//
// Bounds: a pass reads n_in and writes n_out bytes per (j, i) and does ntaps
// int32 multiply-adds per output byte written, so device-memory bytes set the
// floor; one byte load, a clamp and an address per tap may hold this first
// version above it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 22;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
pil_resample_axis_kernel(const uint8_t* __restrict__ x,
                         uint8_t* __restrict__ out,
                         const int* __restrict__ xmin,
                         const int* __restrict__ wb, long long inner,
                         long long total, int n_in, int n_out, int ntaps,
                         int pb) {
  const long long stride = (long long)gridDim.x * kThreads;
  const int bias = 1 << (pb - 1);
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx % inner;
    const long long jo = idx / inner;
    const int o = (int)(jo % n_out);
    const long long j = jo / n_out;
    const uint8_t* xp = x + j * n_in * inner + i;
    const int xm = xmin[o];
    const int* wk = wb + (long long)o * ntaps;
    int acc = bias;
    for (int k = 0; k < ntaps; ++k) {
      acc += wk[k] * (int)xp[(long long)clampi(xm + k, 0, n_in - 1) * inner];
    }
    // signed shift: bicubic/lanczos accumulators can be negative
    out[idx] = (uint8_t)clampi(acc >> pb, 0, 255);
  }
}

}  // namespace

extern "C" {

// uint8 x[outer, n_in, inner] -> uint8 out[outer, n_out, inner] on `stream`.
// All pointers are device pointers; xmin is int32 [n_out], wb int32 row-major
// [n_out, ntaps].  Returns the cudaError_t of the launch (0 on success).
int ia_pil_resample_axis(const void* x, void* out, long long outer, int n_in,
                         long long inner, int n_out, const void* xmin,
                         const void* wb, int ntaps, int pb, void* stream) {
  const long long total = outer * n_out * inner;
  if (total < 1 || n_in < 1 || ntaps < 1 || pb < 1 || pb > 30) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pil_resample_axis_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, (const int*)xmin, (const int*)wb,
      inner, total, n_in, n_out, ntaps, pb);
  return (int)cudaGetLastError();
}

}  // extern "C"
