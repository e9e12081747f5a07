// One pass of the windowed crop-and-resize with per-image boxes: uint8
// x viewed as [N, R, n_in, inner] -> uint8 out [N, R, n_out, inner], each
// output row o of image n reading its own taps:
//
//   out[n, r, o, i] = q( sum_{j < cnt[n, o]} w[n, o, j] * x[n, r, first[n, o] + j, i] )
//
// Replaces interpolate_antialiasing_tpu/ops/crop_pallas.py::_kernel_crop_mid_dig
// and ::_kernel_crop_last_dig (integer weights), and serves ::_kernel_crop_mid
// and ::_kernel_crop_last (float weights, precision="split").  The host
// (ops/crop_cuda.py) launches it twice: the H pass (inner = W, the image's
// rows) into a uint8 intermediate, then the W pass (R = C * OH rows, inner =
// 1) into the output.
//
// The TPU kernels contract a [K, 128] band per (image, 128-row tile) on the
// matrix unit: K window pixels for every output, most of them at zero
// weight, with int8 digit planes and pixels re-centred by -128 for its int8
// unit.  Here each output runs a direct multiply-add over only its nonzero
// range (the host compacts each band column to first / cnt / w), so the work
// is ntaps, not K, per output; the digit split and the -128 bias cancel
// exactly, so the int32 sum gives the TPU kernels' bytes:
//
//   integer (pb >= 0): K int32 weights, S = sum K * x exact in int32 (the
//     host bounds 255 * row sum + 2^(pb-1) below 2^31 before the launch),
//     q(S) = (S + 2^(pb-1)) >> pb;
//   float (pb < 0): float32 weights, each product and sum rounded in tap
//     order (ia_dtypes.cuh::mac, bit for bit the plain version's),
//     q(v) = floor(v + 0.5).
//
// Both clamp to [0, 255], a no-op where admission's clip-free bound holds.
//
// Design: one thread per output element over the flat output index, so
// neighbouring threads take neighbouring inner elements (a coalesced row of
// the H pass) or, when inner == 1, neighbouring outputs whose windows
// overlap in cache; the row's table entries are the same for a whole warp
// in the H pass.  Nothing is staged in shared memory: a window of any size
// runs.  A grid-stride loop with 64-bit indices covers any element count.
//
// Bounds: the H pass reads the image once from device memory (its windows
// overlap by the tap count over the scale, through L2) and does ntaps
// multiply-adds per intermediate element; at 4K -> 224 that is ~21 per
// output and one byte loaded per multiply-add, so load issue, not bytes,
// may bound this first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ia_dtypes.cuh"

namespace {

using namespace ia;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 22;

template <typename Tw>
__global__ void __launch_bounds__(kThreads)
crop_pass_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 long long R, int n_in, long long inner, int n_out,
                 const int* __restrict__ first, const int* __restrict__ cnt,
                 const Tw* __restrict__ w, int k, int pb, long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx % inner;
    const long long rest = idx / inner;
    const int o = (int)(rest % n_out);
    const long long nr = rest / n_out;
    const long long t = (nr / R) * n_out + o;  // the image's row table
    const uint8_t* xp = x + (nr * n_in + first[t]) * inner + i;
    const Tw* wk = w + t * k;
    const int taps = cnt[t];
    float v;
    if constexpr (std::is_same_v<Tw, int>) {
      int acc = 0;
      for (int j = 0; j < taps; ++j) acc += wk[j] * (int)xp[j * inner];
      v = (float)((acc + (1 << (pb - 1))) >> pb);
    } else {
      float acc = 0.0f;
      for (int j = 0; j < taps; ++j) acc = mac(acc, wk[j], (float)xp[j * inner]);
      v = floorf(acc + 0.5f);
    }
    out[idx] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" {

// x[N, R, n_in, inner] -> out[N, R, n_out, inner] (uint8, device pointers)
// on `stream`; first/cnt int32 [N, n_out], w [N, n_out, k]: int32 when
// pb >= 0, float32 when pb < 0.  Returns the cudaError_t of the launch.
int ia_crop_pass(const void* x, void* out, int N, long long R, int n_in,
                 long long inner, int n_out, const void* first,
                 const void* cnt, const void* w, int k, int pb,
                 void* stream) {
  const long long total = (long long)N * R * n_out * inner;
  if (total < 1 || n_in < 1 || k < 1 || pb > 30) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (pb >= 0) {
    crop_pass_kernel<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)out, R, n_in, inner, n_out,
        (const int*)first, (const int*)cnt, (const int*)w, k, pb, total);
  } else {
    crop_pass_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)out, R, n_in, inner, n_out,
        (const int*)first, (const int*)cnt, (const float*)w, k, pb, total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
