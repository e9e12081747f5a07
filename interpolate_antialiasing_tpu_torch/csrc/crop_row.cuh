// One output row of the windowed crop's tables, from its box alone: the
// per-row weight code that the table kernel (crop_tables.cu) and the crop
// passes (resample_axis.cuh's crop instantiation, for a row with more taps
// than the tables hold) share, so that both compute each weight from the
// same source and the bits agree by construction.  The passes take a
// row's total from row_sum once per block and each weight from the
// image's box_row with the row's center (weight_at(first + i): position
// start + j for j = first - start + i, the same float).
//
// Every float step is float32, rounded once (the intrinsics are never
// contracted into a fused multiply-add), in the plain version's order
// (ops/crop_cuda.py::_windowed_band):
//
//   lo, hi  = box * in_size;  scale = (hi - lo) / out_size
//   widen   = antialias ? max(scale, 1) : 1;  sup = support * widen
//   start   = clamp(floor(raw / align) * align, 0, hi_start), raw =
//             floor(c0 - sup - 0.5) - 1, c0 the centre of the row's tile's
//             first output (o / 128 * 128)
//   center  = lo + scale * (o + 0.5);  pos_j = start + j, j < k
//   w_j     = filter((pos_j - center + 0.5) / widen) where |pos_j - center
//             + 0.5| <= sup, lo <= pos_j + 0.5 <= hi, pos_j <= in_size - 1;
//             else 0
//   total   = the sum of w_j in XLA's CPU order (crop_cuda._tree_sum: for
//             k > 32, windows of 32 taps after (-k mod 32) / 2 zeros, each
//             summed in order, then the window sums the same way while
//             there are more than 32; the last in order)
//   band_j  = w_j / total where total > 0 (else the table kernel's one-hot)
//   K_j     = (int)(band_j * 2^pb +- 0.5) for pb >= 0 (integer weights)
//
// The sum runs over the row's support range widened by two taps and clipped
// to the window (row_sum): the valid test above still decides each tap, and
// the taps outside weigh +0, which adds exactly, so the sums are the plain
// version's.  The tree sum streams (TreeSum): a level's running window sum
// joins the level above when the next tap starts a new window there;
// windows the loop never reaches would add +0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ia_taps.cuh"

namespace ia {
namespace crop {

constexpr int kLane = 128;  // output rows per window tile (crop_cuda._LANE)
constexpr int kBox = 4;     // beside ia::SynthFilter's codes
constexpr int kSumWindow = 32;  // crop_cuda._SUM_WINDOW
constexpr int kSumLevels = 4;   // window levels: k up to 32^5 taps

// One pass's geometry and filter: what a row's weights need beside its box
// and its output index.
struct Geom {
  const float* boxes;  // [N, 4] normalised (y0, x0, y1, x1), device
  int axis;            // 0: H from box columns 0 and 2, 1: W from 1 and 3
  int in_size, out_size, k, align, hi_start, pb;  // pb -1: float32 weights
  int filter, antialias;  // filter: 0 triangle, 2 Hamming, 4 box
  float support;          // the filter's unwidened support
};

// ops/filters.py's non-negative filters: triangle and Hamming as the fused
// kernels evaluate them, and the box (x > -0.5 and x <= 0.5)
__device__ __forceinline__ float table_filter(int f, float x) {
  if (f == kBox) return (x > -0.5f && x <= 0.5f) ? 1.0f : 0.0f;
  Synth s{};
  s.filter = f;
  return synth_filter(s, x);
}

struct Row {
  float lo, hi, scale, widen, sup, center, in_last;
  int start, filter;

  // the weight of input position p (start + j): 0 where the valid test
  // fails; F the filter's code where the caller knows it (else `filter`)
  template <int F = -1>
  __device__ __forceinline__ float weight_at(int p) const {
    const float pos = (float)p;
    const float d = __fadd_rn(__fsub_rn(pos, center), 0.5f);
    const float ph = __fadd_rn(pos, 0.5f);
    if (!(fabsf(d) <= sup && ph >= lo && ph <= hi && pos <= in_last)) return 0.0f;
    return table_filter(F < 0 ? filter : F, __fdiv_rn(d, widen));
  }
  // w_j
  template <int F = -1>
  __device__ __forceinline__ float weight(int j) const { return weight_at<F>(start + j); }
  // the centre of output o
  __device__ __forceinline__ float center_of(int o) const {
    return __fadd_rn(lo, __fmul_rn(scale, __fadd_rn((float)o, 0.5f)));
  }
};

// A sum in crop_cuda._tree_sum's order over taps added in increasing j
// (taps not added weigh +0).  Level 0 holds the taps, level l + 1 the sums
// of level l's windows of kSumWindow elements (after front[l] zeros), and
// the top level m is summed in order.  acc[l] (l < m) runs over the level-l
// elements of level l + 1's element win[l]; acc[m] over the top level.
// Closing a window adds its sum to the level above, whose window then
// still holds it.
struct TreeSum {
  int m = 0;
  int front[kSumLevels];  // zeros in front of each window level
  int win[kSumLevels];
  float acc[kSumLevels + 1];

  // (the loops run to the static kSumLevels, so that acc and win stay in
  // registers; the host builds one for a kernel's parameters too)
  TreeSum() = default;
  __host__ __device__ explicit TreeSum(int k) {
    int s = k;
#pragma unroll
    for (int l = 0; l < kSumLevels; ++l) {
      front[l] = 0;
      win[l] = -1;
      if (s > kSumWindow) {
        const int pad = (kSumWindow - s % kSumWindow) % kSumWindow;
        front[l] = pad / 2;
        s = (s + pad) / kSumWindow;
        m = l + 1;
      }
    }
#pragma unroll
    for (int l = 0; l <= kSumLevels; ++l) acc[l] = 0.0f;
  }

  __device__ void add(int j, float v) {
    int idx = j;
#pragma unroll
    for (int l = 0; l < kSumLevels; ++l) {  // close the windows tap j leaves, bottom up
      if (l >= m) break;
      idx = (idx + front[l]) / kSumWindow;
      if (idx == win[l]) break;
      acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
      acc[l] = 0.0f;
      win[l] = idx;
    }
    acc[0] = __fadd_rn(acc[0], v);
  }

  __device__ float total() {
    float t = acc[0];
#pragma unroll
    for (int l = 0; l < kSumLevels; ++l) {
      if (l < m) {
        acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
        t = acc[l + 1];
      }
    }
    return t;
  }
};

// The level-0 windows of a sum over k taps in TreeSum's order: tap j lies
// in window (j + front) / kSumWindow, each window is summed in tap order
// from +0, and the window sums in order make a sum over `count` elements,
// TreeSum(count)'s (its levels are TreeSum(k)'s above the first).  A sum of
// at most kSumWindow taps is one window.
struct SumWindows {
  int front, count;
};

__host__ __device__ __forceinline__ SumWindows sum_windows(int k) {
  if (k <= kSumWindow) return SumWindows{0, 1};
  const int pad = (kSumWindow - k % kSumWindow) % kSumWindow;
  return SumWindows{pad / 2, (k + pad) / kSumWindow};
}

// band_j as the pass stores it: K_j (integer weights) or band_j, as bits
__device__ __forceinline__ int32_t stored(float band, int pb) {
  if (pb < 0) return __float_as_int(band);
  const float s = __fmul_rn(band, (float)(1 << pb));
  return (int32_t)(s < 0.0f ? __fsub_rn(s, 0.5f) : __fadd_rn(s, 0.5f));
}

__device__ __forceinline__ bool nonzero(int32_t v, int pb) {
  return pb < 0 ? __int_as_float(v) != 0.0f : v != 0;
}

// Row o of image n: its geometry, the taps [j_lo, j_hi) whose weight may
// be nonzero (the support range with a guard of two, clipped to the
// window) and the total of their weights.
struct RowSum {
  Row r;
  int j_lo, j_hi;
  float total;
};

// Image n's part of its rows' geometry (lo, hi, scale, widen, sup,
// in_last, filter), which every row of the image shares; center and start
// are left to the row.
__device__ __forceinline__ Row box_row(const Geom& g, long long n) {
  Row r;
  r.filter = g.filter;
  const float size = (float)g.in_size;
  r.lo = __fmul_rn(g.boxes[4 * n + g.axis], size);
  r.hi = __fmul_rn(g.boxes[4 * n + g.axis + 2], size);
  r.scale = __fdiv_rn(__fsub_rn(r.hi, r.lo), (float)g.out_size);
  r.widen = g.antialias ? fmaxf(r.scale, 1.0f) : 1.0f;
  r.sup = __fmul_rn(g.support, r.widen);
  r.in_last = (float)(g.in_size - 1);
  r.center = 0.0f;
  r.start = 0;
  return r;
}

// Row o of image n's geometry and its taps [j_lo, j_hi), total left 0.
__device__ __forceinline__ RowSum row_range(const Geom& g, long long n, int o) {
  RowSum s;
  Row& r = s.r;
  r = box_row(g, n);

  // the window start of the row's tile, from the centre of its first output
  const float c0 = r.center_of(o / kLane * kLane);
  const float raw = __fsub_rn(floorf(__fsub_rn(__fsub_rn(c0, r.sup), 0.5f)), 1.0f);
  // raw / align: a product with the exact reciprocal where align is a power
  // of two (the passes' alignments are; the same float as the quotient)
  const float al = (float)g.align;
  const float q = (g.align & (g.align - 1)) == 0
                      ? __fmul_rn(raw, __int_as_float(0x7f000000 - __float_as_int(al)))
                      : __fdiv_rn(raw, al);
  r.start = (int)fminf(fmaxf(__fmul_rn(floorf(q), al), 0.0f), (float)g.hi_start);
  r.center = r.center_of(o);

  // the taps whose |pos - center + 0.5| may pass sup, with a guard of two
  const float cm = __fsub_rn(r.center, 0.5f);
  const float k = (float)g.k, s0 = (float)r.start;
  s.j_lo = (int)fminf(fmaxf(floorf(cm - r.sup) - 2.0f - s0, 0.0f), k);
  s.j_hi = (int)fminf(fmaxf(ceilf(cm + r.sup) + 3.0f - s0, 0.0f), k);
  s.total = 0.0f;
  return s;
}

// row_range and the total, one tap after the other (the crop passes' form;
// the table kernel sums a row with a group of lanes in the same order)
__device__ __forceinline__ RowSum row_sum(const Geom& g, long long n, int o) {
  RowSum s = row_range(g, n, o);
  TreeSum sum(g.k);
  for (int j = s.j_lo; j < s.j_hi; ++j) sum.add(j, s.r.weight(j));
  s.total = sum.total();
  return s;
}

// A pass's row source for the crop passes: its geometry, each row's true
// tap count (cnt [N, out_size], device), which may pass the tables' bound
// T, and the images it mirrors (flip [N] bool, device; nullptr for none:
// the integer passes and every H pass).
struct Pass {
  Geom g;
  const int* cnt;
  const uint8_t* flip;
};

// The row whose weights output o of image n takes: its own, or row
// out_size - 1 - o in an image the pass mirrors (the table kernel wrote
// that row's tables into o's slot).  M: whether the instantiation may
// mirror at all (only the float32-intermediate W pass does); without it
// the row is o, with no branch.
template <bool M>
__device__ __forceinline__ int source_row(const Pass& cp, long long n, int o) {
  if constexpr (M) {
    return cp.flip != nullptr && cp.flip[n] ? cp.g.out_size - 1 - o : o;
  } else {
    return o;
  }
}

}  // namespace crop
}  // namespace ia
