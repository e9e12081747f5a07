// Where a resample kernel takes each output's weights from: float32 host
// tables (TableTaps), the pass's closed form evaluated in the kernel
// (SynthTaps), or Pillow's int32 fixed-point tables (PilTaps); and how it
// sums them (Acc below: a float32 multiply-add chain, or Pillow's int32
// sum).  Kernel A (resample2d.cuh: resample2d, its fused twin and the
// Pillow two-pass kernel) and kernel B (resample_axis.cuh: resample_axis,
// its fused twin, pil_resample_axis and the crop passes) are templated on
// all three, so each keeps one multiply-add loop for every source.  A
// block writes its tile's first taps and weights into shared memory once,
// tap-major (stage(); kernel B copies tables with stage_async(), 4-byte
// asynchronous copies), and reads them from there; kernel B's unstaged
// body asks for one output's taps where it uses them:
//
//   const auto row = taps.row(o);
//   for (int k = 0; k < taps.ntaps; ++k)
//     acc = mac(acc, row(k), x[clamp(row.first + k, 0, in - 1)]);
//
// The table sources can hold one table per image (the windowed crop's
// per-image boxes): `stride` outputs apart, image(n) selects image n's.
//
// SynthTaps replaces the weight-band synthesis of the JAX package's
// _kernel_last_fused / _kernel_mid_fused and of the fused_spec branch of
// _kernel_last_unrolled / _kernel_mid_unrolled
// (interpolate_antialiasing_tpu/ops/pallas_resize.py::_synth_band): no weight
// crosses device memory.  For output o of a pass over in_size inputs, every
// step in float32, each rounded (the intrinsics are never contracted into a
// fused multiply-add), in the order of the plain version
// (cuda_resize.py::_synth_tables):
//
//   center = scale * (o + 0.5) + offset          (align_corners: scale * o + 0.5)
//   first  = floor(center - support + 0.5)       (may lie before the axis)
//   w_k    = filter((first + k - center + 0.5) * invscale), k < ntaps,
//            0 where first + k lies outside [0, in_size - 1]
//   total  = w_0 + w_1 + ... in tap order, 1 where it is 0
//   weight = w_k / total
//
// The window of ntaps = ceil(support) * 2 + 1 taps from `first` covers every
// tap where the filter is nonzero; the TPU kernel evaluates the same filter
// over its tile's whole band, whose other taps weigh 0.  Continuous filters
// only (triangle, Keys cubic, Hamming, Lanczos): the host gate sends box,
// nearest, area and the non-renorm borders to the tables, as the JAX
// package's gate does.
//
// Bounds: synthesis is arithmetic.  Through stage(), a kernel does it once
// per output and tap of its tile (ntaps evaluations and divisions per
// output, shared by every input row, column or plane the block reads), so
// its weight work does not scale with the elements it computes; the table
// routes' stage() is one load per weight.  Through row() (kernel B's
// unstaged body only) it is 2 * ntaps evaluations and ntaps divisions per
// output element.

#pragma once

#include <cuda_runtime.h>

#include "ia_dtypes.cuh"

namespace ia {

// filter codes (cuda_resize.py::_SYNTH_FILTERS)
enum SynthFilter : int { kTriangle = 0, kCubic = 1, kHamming = 2, kLanczos = 3 };

// One pass's closed form.  Every float is the spec's Python float rounded to
// float32 once, on the host (JAX's weak typing does the same).  c0, c1, c2:
// a + 2, a + 3 and a of the Keys cubic; c0 = n of Lanczos-n.
struct Synth {
  int filter, in_size, ntaps, align_corners;
  float scale, invscale, support, offset;
  float c0, c1, c2;
};

// float32(pi), as jnp.sinc and jnp.pi * x round it
constexpr float kPi = 3.14159265358979323846f;

// jnp.sinc: sin(pi x) / (pi x) with pi x rounded once; 1 at 0
__device__ __forceinline__ float sinc_f32(float x) {
  if (x == 0.0f) return 1.0f;
  const float px = __fmul_rn(kPi, x);
  return __fdiv_rn(sinf(px), px);
}

// The JAX package's filters (ops/filters.py) evaluated in float32, operation
// by operation as jnp evaluates them on float32 arguments.
__device__ __forceinline__ float synth_filter(const Synth& s, float x) {
  const float ax = fabsf(x);
  switch (s.filter) {
    case kTriangle:
      return ax < 1.0f ? __fsub_rn(1.0f, ax) : 0.0f;
    case kCubic: {
      if (ax < 1.0f) {  // ((a + 2) * ax - (a + 3)) * ax * ax + 1
        const float t = __fsub_rn(__fmul_rn(s.c0, ax), s.c1);
        return __fadd_rn(__fmul_rn(__fmul_rn(t, ax), ax), 1.0f);
      }
      if (ax < 2.0f) {  // (((ax - 5) * ax + 8) * ax - 4) * a
        const float t = __fadd_rn(__fmul_rn(__fsub_rn(ax, 5.0f), ax), 8.0f);
        return __fmul_rn(__fsub_rn(__fmul_rn(t, ax), 4.0f), s.c2);
      }
      return 0.0f;
    }
    case kHamming: {  // sinc(x) * (0.54f + 0.46f * cos(pi x)), exactly 1 at 0
      if (!(ax < 1.0f)) return 0.0f;
      if (ax == 0.0f) return 1.0f;
      const float px = __fmul_rn(kPi, x);
      const float win = __fadd_rn(0.54f, __fmul_rn(0.46f, cosf(px)));
      return __fmul_rn(__fdiv_rn(sinf(px), px), win);
    }
    case kLanczos:  // sinc(x) * sinc(x / n)
      if (!(ax < s.c0)) return 0.0f;
      return __fmul_rn(sinc_f32(x), sinc_f32(__fdiv_rn(x, s.c0)));
  }
  return 0.0f;
}

__device__ __forceinline__ float synth_center(const Synth& s, int o) {
  const float of = (float)o;
  if (s.align_corners) return __fadd_rn(__fmul_rn(s.scale, of), 0.5f);
  return __fadd_rn(__fmul_rn(s.scale, __fadd_rn(of, 0.5f)), s.offset);
}

__device__ __forceinline__ int synth_first(const Synth& s, float center) {
  return (int)floorf(__fadd_rn(__fsub_rn(center, s.support), 0.5f));
}

// The unnormalised weight of input position `pos` (0 off the axis).
__device__ __forceinline__ float synth_raw(const Synth& s, int pos, float center) {
  if (pos < 0 || pos > s.in_size - 1) return 0.0f;
  const float arg = __fmul_rn(__fadd_rn(__fsub_rn((float)pos, center), 0.5f),
                              s.invscale);
  return synth_filter(s, arg);
}

// ---------------------------------------------------------------------------
// The weight sources
// ---------------------------------------------------------------------------

// Outputs [o0, o0 + n) of a table (xmin [out], w [out, ntaps]) into shared
// memory for a tile of `tile` outputs, tap-major: ws[k * tile + t], fs[t];
// slots t >= n repeat output o0 + n - 1's first tap with zero weight.
// Every thread of the block calls it.
template <typename W>
__device__ __forceinline__ void stage_table(const int* xmin, const W* w, int ntaps, int o0,
                                            int n, int tile, W* ws, int* fs) {
  for (int t = threadIdx.x; t < tile; t += blockDim.x) fs[t] = xmin[o0 + min(t, n - 1)];
  for (int i = threadIdx.x; i < ntaps * tile; i += blockDim.x) {
    const int k = i / tile, t = i - k * tile;
    ws[i] = t < n ? w[(long long)(o0 + t) * ntaps + k] : W(0);
  }
}

// As stage_table for outputs [o0, o0 + n) only, by 4-byte asynchronous
// copies in the caller's commit group (slots t >= n are left unwritten).
template <typename W>
__device__ __forceinline__ void stage_table_async(const int* xmin, const W* w, int ntaps,
                                                  int o0, int n, int tile, W* ws, int* fs) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) cp_async4(fs + t, xmin + o0 + t);
  for (int i = threadIdx.x; i < ntaps * n; i += blockDim.x) {
    const int t = i / ntaps, k = i - t * ntaps;
    cp_async4(ws + k * tile + t, w + (long long)o0 * ntaps + i);
  }
}

// Host tables: xmin int32 [out], w float32 row-major [out, ntaps]; with
// stride > 0, one such table per image, image n's at xmin + n * stride.
struct TableTaps {
  const int* xmin;
  const float* w;
  int ntaps;
  long long stride;

  struct Row {
    int first;
    const float* w;
    __device__ __forceinline__ float operator()(int k) const { return w[k]; }
  };
  __device__ __forceinline__ TableTaps image(long long n) const {
    return {xmin + n * stride, w + n * stride * ntaps, ntaps, stride};
  }
  __device__ __forceinline__ int first(int o) const { return xmin[o]; }
  __device__ __forceinline__ Row row(int o) const {
    return {xmin[o], w + (long long)o * ntaps};
  }
  __device__ __forceinline__ void stage_async(int o0, int n, int tile, float* ws,
                                              int* fs) const {
    stage_table_async(xmin, w, ntaps, o0, n, tile, ws, fs);
  }
  __device__ __forceinline__ void stage(int o0, int n, int tile, float* ws, int* fs,
                                        float*) const {
    stage_table(xmin, w, ntaps, o0, n, tile, ws, fs);
  }
};

// Weights synthesised from the pass's closed form.
struct SynthTaps {
  Synth s;
  int ntaps;

  __device__ __forceinline__ SynthTaps image(long long) const { return *this; }

  struct Row {
    Synth s;
    int first;
    float center, total;
    __device__ __forceinline__ float operator()(int k) const {
      return __fdiv_rn(synth_raw(s, first + k, center), total);
    }
  };
  __device__ __forceinline__ int first(int o) const {
    return synth_first(s, synth_center(s, o));
  }
  __device__ __forceinline__ Row row(int o) const {
    const float center = synth_center(s, o);
    const int first = synth_first(s, center);
    float total = 0.0f;
    for (int k = 0; k < ntaps; ++k) {
      total = __fadd_rn(total, synth_raw(s, first + k, center));
    }
    return {s, first, center, total == 0.0f ? 1.0f : total};
  }
  // As TableTaps::stage, the weights evaluated once per output and tap,
  // `total[tile]` scratch: the same operations as row() in the same order,
  // so the same floats.  Every thread of the block calls it (it syncs).
  __device__ __forceinline__ void stage(int o0, int n, int tile, float* ws,
                                        int* fs, float* total) const {
    for (int i = threadIdx.x; i < ntaps * tile; i += blockDim.x) {
      const int k = i / tile, t = i - k * tile;
      const float center = synth_center(s, o0 + min(t, n - 1));
      const int first = synth_first(s, center);
      if (k == 0) fs[t] = first;
      ws[i] = synth_raw(s, first + k, center);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      float sum = 0.0f;
      for (int k = 0; k < ntaps; ++k) sum = __fadd_rn(sum, ws[k * tile + t]);
      total[t] = sum == 0.0f ? 1.0f : sum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ntaps * tile; i += blockDim.x) {
      const int t = i % tile;
      ws[i] = t < n ? __fdiv_rn(ws[i], total[t]) : 0.0f;
    }
  }
};

// Pillow's 8bpc fixed-point tables (pil_exact.py::_int_tables): xmin int32
// [out], wb int32 row-major [out, ntaps], pb precision bits; per image as
// TableTaps.  Also the windowed crop's integer tables (crop_cuda.py), whose
// (S + 2^(pb-1)) >> pb is this sum from the bias.
struct PilTaps {
  const int* xmin;
  const int* wb;
  int ntaps;
  int pb;
  long long stride;

  struct Row {
    int first;
    const int* w;
    __device__ __forceinline__ int operator()(int k) const { return w[k]; }
  };
  __device__ __forceinline__ PilTaps image(long long n) const {
    return {xmin + n * stride, wb + n * stride * ntaps, ntaps, pb, stride};
  }
  __device__ __forceinline__ Row row(int o) const {
    return {xmin[o], wb + (long long)o * ntaps};
  }
  __device__ __forceinline__ void stage_async(int o0, int n, int tile, int* ws,
                                              int* fs) const {
    stage_table_async(xmin, wb, ntaps, o0, n, tile, ws, fs);
  }
  __device__ __forceinline__ void stage(int o0, int n, int tile, int* ws, int* fs,
                                        float*) const {
    stage_table(xmin, wb, ntaps, o0, n, tile, ws, fs);
  }
};

// ---------------------------------------------------------------------------
// Accumulation: a float32 multiply-add chain, or Pillow's int32 sum
// ---------------------------------------------------------------------------

// The float sources: each tap mac() in tap order from 0, stored as
// ia_dtypes.cuh stores.  W: a weight; A: the sum; X: an element as kernel
// A loads it (take(), widened once; add() sums it); I: kernel A's W-pass
// result in shared memory (float32, put on the uint8 lattice by mid()
// where uint8 -> uint8 asks for it).
template <typename Taps>
struct Acc {
  using W = float;
  using A = float;
  using X = float;
  using I = float;
  __device__ __forceinline__ static A init(const Taps&) { return 0.0f; }
  template <typename T>
  __device__ __forceinline__ static X take(const T* p) {
    return load_f32(p);
  }
  __device__ __forceinline__ static A add(A acc, W w, X x) { return mac(acc, w, x); }
  template <typename T>
  __device__ __forceinline__ static A step(A acc, W w, T v) {
    return mac(acc, w, load_f32(&v));
  }
  __device__ __forceinline__ static A step_byte(A acc, W w, unsigned b) {
    return mac(acc, w, (float)b);
  }
  template <typename T>
  __device__ __forceinline__ static T put(A acc, const Taps&) {
    T v;
    store_f32(&v, acc);
    return v;
  }
  __device__ __forceinline__ static I mid(A acc, const Taps&, bool quant) {
    return quant ? quant_u8(acc) : acc;
  }
};

// Pillow's: acc = 2^(pb-1) + sum_k Wb[o, k] * x (exact in int32: the hosts
// bound it), then clip8(acc >> pb); its W-pass result is that byte.
template <>
struct Acc<PilTaps> {
  using W = int;
  using A = int;
  using X = int;
  using I = uint8_t;
  __device__ __forceinline__ static A init(const PilTaps& t) {
    return 1 << (t.pb - 1);
  }
  __device__ __forceinline__ static X take(const uint8_t* p) { return *p; }
  __device__ __forceinline__ static A add(A acc, W w, X x) { return acc + w * x; }
  __device__ __forceinline__ static A step(A acc, W w, uint8_t v) {
    return acc + w * (int)v;
  }
  __device__ __forceinline__ static A step_byte(A acc, W w, unsigned b) {
    return acc + w * (int)b;
  }
  // signed shift: bicubic / lanczos sums can be negative
  template <typename T>
  __device__ __forceinline__ static T put(A acc, const PilTaps& t) {
    return (T)clampi(acc >> t.pb, 0, 255);
  }
  __device__ __forceinline__ static I mid(A acc, const PilTaps& t, bool) {
    return put<uint8_t>(acc, t);
  }
};

__host__ __forceinline__ SynthTaps synth_taps(const Synth& s) {
  return {s, s.ntaps};
}

}  // namespace ia
