// normalize: the pipelines' last step, ((x * scale) - mean[c]) / std[c] in
// float32, stored as float32 or bfloat16, in one pass over a [N, C, H, W]
// input read through its strides (the last axis unit-stride: a contiguous
// crop, or the eval pipeline's centre-crop view of the resized batch).
//
// It replaces no TPU kernel: the JAX package leaves the normalisation to
// XLA, which fuses it into one loop.  On the card, eager PyTorch ran it as
// four elementwise kernels (the cast, * 1/255, - mean, / std), each a full
// pass over the float32 output; this kernel reads the input once and
// writes the output once.  Bound: bytes (b64 224x224 uint8 -> float32:
// 9.6 MB read, 38.5 MB written, 0.0144 ms at 3.35 TB/s), with about ten
// instructions of arithmetic per output.
//
// Bits: each step is rounded once, in the plain expression's order
// (ops/normalize.py::_normalize_plain): __fmul_rn, __fsub_rn, __fdiv_rn,
// then __float2bfloat16_rn for bfloat16.  The intrinsics are never
// contracted into a fused multiply-add, and std divides (no reciprocal),
// so the kernel equals the plain expression on the card bit for bit.
//
// Design (from a sweep of variants on the H100: rows per warp, loads in
// flight, launch bounds, grids, a shared table of the 256 levels, 4, 8 or
// 16 outputs per lane): one warp per row of W outputs, one block per 8
// rows, so the card's block scheduler balances the rows; each lane takes 8
// consecutive outputs of its row per pass (a row of 224 in one pass).  Its
// uint8 input is one 8-byte load where aligned, two 4-byte loads where
// aligned to 4, else three aligned words joined by funnel shifts (the eval
// view's rows start at every byte offset); float32 is two 16-byte loads
// where aligned, else one each.  Each aligned four outputs are one 16-byte
// store of float32 (8 bytes of bfloat16); a row's tail goes element by
// element.  The b64 224x224 calls take 0.019-0.020 ms (71-76% of the
// bound), the four aten kernels 0.127-0.134 ms (CUDA graphs of 40 launches,
// H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ia_dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows per block
constexpr int kVec = 8;                // consecutive outputs per lane and pass

struct Args {
  const void* x;
  void* out;
  long long sn, sc, sh;  // input strides, in elements
  unsigned C, H, W, rows;
  const float* mean;
  const float* std;
  float scale;
};

// n (1 to 8) consecutive inputs from p, widened to float32 into v[0..n).
__device__ __forceinline__ void load(const uint8_t* p, unsigned n, float (&v)[kVec]) {
  unsigned w[2] = {0u, 0u};
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == kVec) {
    const unsigned k = static_cast<unsigned>(a & 3u);
    const unsigned* q = reinterpret_cast<const unsigned*>(a - k);
    if ((a & 7u) == 0) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x, w[1] = u.y;
    } else if (k == 0) {
      w[0] = __ldg(q), w[1] = __ldg(q + 1);
    } else {
      // the three aligned words each hold a byte of the group: no read
      // past the input
      const unsigned q1 = __ldg(q + 1);
      w[0] = __funnelshift_r(__ldg(q), q1, 8u * k);
      w[1] = __funnelshift_r(q1, __ldg(q + 2), 8u * k);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (e < n) w[e >> 2] |= static_cast<unsigned>(__ldg(p + e)) << (8 * (e & 3));
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = __uint2float_rn((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
}

__device__ __forceinline__ void load(const float* p, unsigned n, float (&v)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    if (e + 4u <= n && (reinterpret_cast<uintptr_t>(p + e) & 15u) == 0) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + e));
      v[e] = f.x, v[e + 1] = f.y, v[e + 2] = f.z, v[e + 3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[e + i] = e + i < n ? __ldg(p + e + i) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Four outputs at an address aligned to all four.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                                            bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}

// n (1 to 8) consecutive outputs at p: a whole aligned group as two
// stores of four (one alignment test for the group: a test per four made
// the kernel 25% slower on the H100), else each aligned four as one store.
template <typename Tout>
__device__ __forceinline__ void store(Tout* p, const float (&v)[kVec], unsigned n) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(Tout) - 1)) == 0) {
    store4(p, v);
    store4(p + 4, v + 4);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    if (e + 4u <= n && (reinterpret_cast<uintptr_t>(p + e) & (4 * sizeof(Tout) - 1)) == 0) {
      store4(p + e, v + e);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e + i < n) store1(p + e + i, v[e + i]);
      }
    }
  }
}

// ((v * scale) - m) / s, each step rounded once
__device__ __forceinline__ float norm(float v, float scale, float m, float s) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(v, scale), m), s);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) normalize_kernel(const Args a) {
  const unsigned row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const unsigned plane = row / a.H, h = row - plane * a.H;
  const unsigned n = plane / a.C, c = plane - n * a.C;
  const Tin* x = static_cast<const Tin*>(a.x) + (n * a.sn + c * a.sc + h * a.sh);
  Tout* o = static_cast<Tout*>(a.out) + static_cast<size_t>(row) * a.W;
  const float m = __ldg(a.mean + c), s = __ldg(a.std + c);
  for (unsigned col = (threadIdx.x & 31u) * kVec; col < a.W; col += 32u * kVec) {
    const unsigned cnt = min(static_cast<unsigned>(kVec), a.W - col);
    float v[kVec];
    load(x + col, cnt, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = norm(v[e], a.scale, m, s);
    store(o + col, v, cnt);
  }
}

template <typename Tin, typename Tout>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  normalize_kernel<Tin, Tout><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[n, c, h, w] = ((x[n*sn + c*sc + h*sh + w] * scale) - mean[c]) / std[c]
// for the [N, C, H, W] input x (dtype code in_dt: uint8 or float32) into
// the contiguous out (out_dt: float32 or bfloat16); mean and std are C
// float32 values on the card.  `blocks` blocks of 256 threads, one warp
// per row n*C*H + c*H + h (the host gives ceil(rows / 8)).  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for what
// it does not take, an empty output included: the host launches none).
int ia_normalize(const void* x, void* out, int in_dt, int out_dt, int N, int C, int H, int W,
                 long long sn, long long sc, long long sh, const void* mean, const void* std,
                 float scale, int blocks, void* stream) {
  const long long rows = static_cast<long long>(N) * C * H;
  if (N < 1 || C < 1 || H < 1 || W < 1 || rows >= (1ll << 31) || blocks < 1 ||
      static_cast<long long>(blocks) * kWarps < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, out, sn, sc, sh,
               static_cast<unsigned>(C), static_cast<unsigned>(H), static_cast<unsigned>(W),
               static_cast<unsigned>(rows), static_cast<const float*>(mean),
               static_cast<const float*>(std), scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == ia::kU8 && out_dt == ia::kF32) return launch<uint8_t, float>(a, blocks, s);
  if (in_dt == ia::kU8 && out_dt == ia::kBF16) return launch<uint8_t, __nv_bfloat16>(a, blocks, s);
  if (in_dt == ia::kF32 && out_dt == ia::kF32) return launch<float, float>(a, blocks, s);
  if (in_dt == ia::kF32 && out_dt == ia::kBF16) return launch<float, __nv_bfloat16>(a, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
