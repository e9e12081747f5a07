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
// The weights come from host tables (ia_resample_axis) or are synthesised
// from the pass's closed form in the kernel (ia_resample_axis_fused, the
// counterpart of _kernel_last_fused / _kernel_mid_fused): the kernel is
// templated on the weight source (ia_taps.cuh) and keeps one multiply-add
// loop for both.
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
#include "ia_taps.cuh"

namespace {

using namespace ia;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 22;

template <typename Taps>
struct ArgsAxis {
  const void* x;
  void* out;
  Taps taps;
  long long inner, total;
  int n_in, n_out;
  unsigned blocks;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, typename Taps>
__global__ void __launch_bounds__(kThreads)
resample_axis_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                     Taps taps, long long inner, long long total, int n_in,
                     int n_out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx % inner;
    const long long jo = idx / inner;
    const int o = (int)(jo % n_out);
    const long long j = jo / n_out;
    const Tin* xp = x + j * n_in * inner + i;
    const auto row = taps.row(o);
    float acc = 0.0f;
    for (int k = 0; k < taps.ntaps; ++k) {
      acc = mac(acc, row(k), load_f32(xp + clampi(row.first + k, 0, n_in - 1) * inner));
    }
    store_f32(out + idx, acc);
  }
}

template <typename Taps>
struct LaunchAxis {
  template <typename Tin, typename Tout>
  struct Op {
    static int run(const ArgsAxis<Taps>& a) {
      resample_axis_kernel<Tin, Tout, Taps><<<a.blocks, kThreads, 0, a.stream>>>(
          (const Tin*)a.x, (Tout*)a.out, a.taps, a.inner, a.total, a.n_in,
          a.n_out);
      return (int)cudaGetLastError();
    }
  };
};

template <typename Taps>
int launch_axis(const void* x, void* out, int in_dt, int out_dt,
                long long outer, int n_in, long long inner, int n_out,
                const Taps& taps, void* stream) {
  const long long total = outer * n_out * inner;
  if (total < 1 || n_in < 1 || taps.ntaps < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const ArgsAxis<Taps> a{x, out, taps, inner, total, n_in, n_out,
                         (unsigned)blocks, (cudaStream_t)stream};
  return ia::dispatch_dtypes<LaunchAxis<Taps>::template Op>(in_dt, out_dt, a);
}

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
  const ia::TableTaps taps{(const int*)xmin, (const float*)w, ntaps};
  return launch_axis(x, out, in_dt, out_dt, outer, n_in, inner, n_out, taps,
                     stream);
}

// The same pass with each output's weights synthesised in the kernel from
// `*spec` (a host pointer, read before the launch; spec->in_size == n_in).
int ia_resample_axis_fused(const void* x, void* out, int in_dt, int out_dt,
                           long long outer, int n_in, long long inner,
                           int n_out, const ia::Synth* spec, void* stream) {
  if (spec->in_size != n_in) return (int)cudaErrorInvalidValue;
  return launch_axis(x, out, in_dt, out_dt, outer, n_in, inner, n_out,
                     ia::synth_taps(*spec), stream);
}

}  // extern "C"
