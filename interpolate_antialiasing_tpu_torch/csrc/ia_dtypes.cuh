// Element loads and stores, asynchronous copies and the exact-tap-count
// dispatch shared by the tiled resample kernels (resample2d.cuh,
// resample_axis.cuh).
//
// Pixels cross device memory in their storage type (uint8, float32 or
// bfloat16) and are widened to float32 in registers; every sum is float32.
// The stores follow the JAX package's kernels (pallas_resize.py::_store and
// ::_quant_u8grid): uint8 is floor(v + 0.5) clamped to [0, 255], never
// round-half-to-even; bfloat16 is round-to-nearest-even.
//
// Each tap is mac(): the product and the sum each rounded to float32, taps
// in order from k = 0, from a sum of 0.  That is exactly what the plain
// PyTorch versions (cuda_resize.py) compute, so a kernel and its plain
// version agree bit for bit and any difference on the card is a fault.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ia {

// dtype codes of the C entry points (cuda_resize.py::_DTYPES)
enum DType : int { kU8 = 0, kF32 = 1, kBF16 = 2 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float load_f32(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// acc + w * x without a fused multiply-add (the intrinsics are never
// contracted): the rounding of the plain version's `acc += x * w`.
__device__ __forceinline__ float mac(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

// The uint8 lattice, kept in float: floor(v + 0.5) clamped to [0, 255].
__device__ __forceinline__ float quant_u8(float v) {
  return fminf(fmaxf(floorf(v + 0.5f), 0.0f), 255.0f);
}

__device__ __forceinline__ void store_f32(uint8_t* p, float v) {
  *p = (uint8_t)quant_u8(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Asynchronous copies from device to shared memory (sm_80 and later): 16
// bytes each, both addresses aligned to 16; a thread's copies
// since its last commit form one group, and wait_1 returns when all but
// its latest group have landed (the block then syncs to see every
// thread's).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
// 4 bytes, both addresses aligned to 4 (through L1: tables are reread)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Returns when all but this thread's latest n (0 to 3) groups have landed.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__host__ __device__ __forceinline__ int align16(int v) { return (v + 15) & ~15; }

template <int N>
struct Int {
  static constexpr int value = N;
};

// f(Int<n>{}) for n in [LO, HI], else f(Int<0>{}): a loop body compiled
// once per exact tap count, chosen once per tile rather than per output.
template <int LO, int HI, typename F>
__device__ __forceinline__ void with_taps(int n, F&& f) {
  if constexpr (HI < LO || HI == 0) {
    f(Int<0>{});
  } else {
    if (n == HI) {
      f(Int<HI>{});
    } else {
      with_taps<LO, HI - 1>(n, f);
    }
  }
}

template <template <typename, typename> class Op, typename Tin, typename Args>
int dispatch_out(int out_dt, const Args& a) {
  switch (out_dt) {
    case kU8: return Op<Tin, uint8_t>::run(a);
    case kF32: return Op<Tin, float>::run(a);
    case kBF16: return Op<Tin, __nv_bfloat16>::run(a);
  }
  return (int)cudaErrorInvalidValue;
}

// Op<Tin, Tout>::run(a) with the element types named by two dtype codes;
// cudaErrorInvalidValue for a code it does not know.
template <template <typename, typename> class Op, typename Args>
int dispatch_dtypes(int in_dt, int out_dt, const Args& a) {
  switch (in_dt) {
    case kU8: return dispatch_out<Op, uint8_t>(out_dt, a);
    case kF32: return dispatch_out<Op, float>(out_dt, a);
    case kBF16: return dispatch_out<Op, __nv_bfloat16>(out_dt, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ia
