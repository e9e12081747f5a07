// One separable resample pass over one axis: x viewed as [outer, n_in,
// inner] -> out [outer, n_out, inner], uint8 / float32 / bfloat16 in and
// out, float32 accumulation.  inner == 1 is a pass over the last axis.
//
// Replaces interpolate_antialiasing_tpu/ops/pallas_resize.py::_kernel_last
// and ::_kernel_mid (wrapper resize_axis_pallas), and serves the per-axis
// passes of _kernel_last_unrolled / _kernel_mid_unrolled (wrapper
// resize2d_pallas).  The TPU kernels contract one tile-compacted weight band
// per 128 outputs on the matrix unit; here each output is a direct windowed
// float32 multiply-add (ia_dtypes.cuh::mac, bit for bit the plain
// version's) over the compact tables of weights.py::compute_tables:
//
//   out[j, o, i] = sum_k w[o, k] * x[j, clamp(xmin[o] + k, 0, n_in - 1), i]
//
// Taps past the window carry zero weight, so the clamp never adds signal.
// Stores as in ia_dtypes.cuh: uint8 floor(v + 0.5) clamped, bfloat16
// round-to-nearest-even.
//
// Design: one thread per output element over the flat output index
// ((j * n_out + o) * inner + i), so neighbouring threads take neighbouring
// inner elements (a coalesced row of the middle-axis pass) or, when inner
// == 1, neighbouring outputs whose windows overlap in cache.  A grid-stride
// loop with 64-bit indices covers any element count; nothing is capped at a
// grid dimension.
//
// Bounds: a pass reads n_in and writes n_out elements per (j, i) and does
// ntaps multiply-adds per output, a few per byte moved, so device memory sets the
// floor; the 64-bit index split and the per-tap clamp and address cost
// instructions that may hold this first version above it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ia_dtypes.cuh"

namespace {

using namespace ia;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 22;

struct ArgsAxis {
  const void* x;
  void* out;
  const void *xmin, *w;
  long long inner, total;
  int n_in, n_out, ntaps;
  unsigned blocks;
  cudaStream_t stream;
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
resample_axis_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                     const int* __restrict__ xmin, const float* __restrict__ w,
                     long long inner, long long total, int n_in, int n_out,
                     int ntaps) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx % inner;
    const long long jo = idx / inner;
    const int o = (int)(jo % n_out);
    const long long j = jo / n_out;
    const Tin* xp = x + j * n_in * inner + i;
    const int xm = xmin[o];
    const float* wk = w + (long long)o * ntaps;
    float acc = 0.0f;
    for (int k = 0; k < ntaps; ++k) {
      acc = mac(acc, wk[k], load_f32(xp + clampi(xm + k, 0, n_in - 1) * inner));
    }
    store_f32(out + idx, acc);
  }
}

template <typename Tin, typename Tout>
struct LaunchAxis {
  static int run(const ArgsAxis& a) {
    resample_axis_kernel<Tin, Tout><<<a.blocks, kThreads, 0, a.stream>>>(
        (const Tin*)a.x, (Tout*)a.out, (const int*)a.xmin, (const float*)a.w,
        a.inner, a.total, a.n_in, a.n_out, a.ntaps);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x[outer, n_in, inner] -> out[outer, n_out, inner] on `stream`, element
// types by dtype code (0 uint8, 1 float32, 2 bfloat16).  All pointers are
// device pointers; xmin is int32 [n_out], w float32 row-major [n_out,
// ntaps].  Returns the cudaError_t of the launch (0 on success).
int ia_resample_axis(const void* x, void* out, int in_dt, int out_dt,
                     long long outer, int n_in, long long inner, int n_out,
                     const void* xmin, const void* w, int ntaps,
                     void* stream) {
  const long long total = outer * n_out * inner;
  if (total < 1 || n_in < 1 || ntaps < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const ArgsAxis a{x, out, xmin, w, inner, total, n_in, n_out, ntaps,
                   (unsigned)blocks, (cudaStream_t)stream};
  return ia::dispatch_dtypes<LaunchAxis>(in_dt, out_dt, a);
}

}  // extern "C"
