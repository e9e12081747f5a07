// The windowed crop's per-image tables, both axes in one launch: for every
// image n and output row o of a pass, the row's first input index, its
// count of nonzero taps and its weights, compacted to the pass's static tap
// bound T (crop_cuda._compact's layout), from the boxes on the device.
//
// Replaces the band build that feeds the JAX package's crop kernels:
// interpolate_antialiasing_tpu/ops/crop_pallas.py::_windowed_band and
// ::_digitize_band, called inside crop_and_resize_windowed, where XLA fuses
// the elementwise chain into the programs that feed the two pallas_calls.
// The port's plain version (ops/crop_cuda.py::_windowed_tables_plain)
// builds dense [N, nt, k, 128] bands and their masks in eager torch and
// compacts them; this kernel computes only the compact tables.
//
// One thread per (axis, image, output row), blockIdx.y the axis (0: H from
// box columns 0 and 2, 1: W from columns 1 and 3).  Every float step is
// float32, rounded once (the intrinsics are never contracted into a fused
// multiply-add), in the plain version's order (crop_cuda._windowed_band):
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
//   band_j  = w_j / total where total > 0, else the one-hot at
//             clamp(rint(center - 0.5), 0, in_size - 1) (half to even, as
//             torch.round)
//   K_j     = (int)(band_j * 2^pb +- 0.5) for pb >= 0 (integer weights)
//
// then the compaction: j0, j1 the first and one-past-last nonzero value
// (K_j, or band_j for float weights), first = start + j0, cnt = j1 - j0
// (0, with j0 = 0, for a row without one), w[i] = value_{j0 + i} for i <
// cnt and 0 up to T.  A row with more than T taps traps, as the plain
// version's device-side assertion fails.  The loop runs over the row's
// support range widened by two taps and clipped to the window: the valid
// test above still decides each tap, and the taps outside weigh +0, which
// adds exactly, so the sums and the values are the plain version's.  The
// tree sum streams (TreeSum): a level's running window sum joins the level
// above when the next tap starts a new window there; windows the loop
// never reaches would add +0.
//
// Bounds: at the train batch (b64 u8 [64, 3, 438, 906] -> 224^2) it writes
// 64 * 224 * (2 + 5 + 2 + 10) * 4 bytes, about 1.1 MB (0.0003 ms at 3.35
// TB/s), and evaluates about 14 filter taps per row twice: 28,672 threads
// of a few hundred instructions each.  Launch latency bounds it; it needs
// neither shared memory nor tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "ia_taps.cuh"

namespace {

constexpr int kLane = 128;  // output rows per window tile (crop_cuda._LANE)
constexpr int kBox = 4;     // beside ia::SynthFilter's codes
constexpr int kThreads = 128;
constexpr int kSumWindow = 32;  // crop_cuda._SUM_WINDOW
constexpr int kSumLevels = 4;   // window levels: k up to 32^5 taps

struct Axis {
  int in_size, out_size, k, align, hi_start, T, pb;
  int* first;
  int* cnt;
  void* w;  // int32 when pb >= 0, else float32
};

struct Params {
  const float* boxes;  // [N, 4] normalised (y0, x0, y1, x1)
  int N, filter, antialias;
  float support;
  Axis ax[2];
};

// ops/filters.py's non-negative filters: triangle and Hamming as the fused
// kernels evaluate them, and the box (x > -0.5 and x <= 0.5)
__device__ __forceinline__ float table_filter(int f, float x) {
  if (f == kBox) return (x > -0.5f && x <= 0.5f) ? 1.0f : 0.0f;
  ia::Synth s{};
  s.filter = f;
  return ia::synth_filter(s, x);
}

struct Row {
  float lo, hi, widen, sup, center, in_last;
  int start, filter;

  // w_j, 0 where the valid test fails
  __device__ __forceinline__ float weight(int j) const {
    const float pos = (float)(start + j);
    const float d = __fadd_rn(__fsub_rn(pos, center), 0.5f);
    const float ph = __fadd_rn(pos, 0.5f);
    if (!(fabsf(d) <= sup && ph >= lo && ph <= hi && pos <= in_last)) return 0.0f;
    return table_filter(filter, __fdiv_rn(d, widen));
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

  __device__ explicit TreeSum(int k) {
    for (int s = k; s > kSumWindow && m < kSumLevels; ++m) {
      const int pad = (kSumWindow - s % kSumWindow) % kSumWindow;
      front[m] = pad / 2;
      win[m] = -1;
      s = (s + pad) / kSumWindow;
    }
    for (int l = 0; l <= kSumLevels; ++l) acc[l] = 0.0f;
  }

  __device__ void add(int j, float v) {
    int idx = j;
    for (int l = 0; l < m; ++l) {  // close the windows tap j leaves, bottom up
      idx = (idx + front[l]) / kSumWindow;
      if (idx == win[l]) break;
      acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
      acc[l] = 0.0f;
      win[l] = idx;
    }
    acc[0] = __fadd_rn(acc[0], v);
  }

  __device__ float total() {
    for (int l = 0; l < m; ++l) acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
    return acc[m];
  }
};

// band_j as the pass stores it: K_j (integer weights) or band_j, as bits
__device__ __forceinline__ int32_t stored(float band, int pb) {
  if (pb < 0) return __float_as_int(band);
  const float s = __fmul_rn(band, (float)(1 << pb));
  return (int32_t)(s < 0.0f ? __fsub_rn(s, 0.5f) : __fadd_rn(s, 0.5f));
}

__device__ __forceinline__ bool nonzero(int32_t v, int pb) {
  return pb < 0 ? __int_as_float(v) != 0.0f : v != 0;
}

__global__ void __launch_bounds__(kThreads) crop_tables_kernel(Params p) {
  const Axis& ax = p.ax[blockIdx.y];
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)p.N * ax.out_size) return;
  const int n = (int)(idx / ax.out_size), o = (int)(idx % ax.out_size);
  const int a = blockIdx.y;

  Row r;
  r.filter = p.filter;
  const float size = (float)ax.in_size;
  r.lo = __fmul_rn(p.boxes[4 * n + a], size);
  r.hi = __fmul_rn(p.boxes[4 * n + a + 2], size);
  const float scale = __fdiv_rn(__fsub_rn(r.hi, r.lo), (float)ax.out_size);
  r.widen = p.antialias ? fmaxf(scale, 1.0f) : 1.0f;
  r.sup = __fmul_rn(p.support, r.widen);
  r.in_last = (float)(ax.in_size - 1);

  // the window start of the row's tile, from the centre of its first output
  const float c0 = __fadd_rn(r.lo, __fmul_rn(scale, __fadd_rn((float)(o / kLane * kLane), 0.5f)));
  const float raw = __fsub_rn(floorf(__fsub_rn(__fsub_rn(c0, r.sup), 0.5f)), 1.0f);
  const float al = (float)ax.align;
  r.start = (int)fminf(fmaxf(__fmul_rn(floorf(__fdiv_rn(raw, al)), al), 0.0f),
                       (float)ax.hi_start);
  r.center = __fadd_rn(r.lo, __fmul_rn(scale, __fadd_rn((float)o, 0.5f)));

  // the taps whose |pos - center + 0.5| may pass sup, with a guard of two
  const float cm = __fsub_rn(r.center, 0.5f);
  const float k = (float)ax.k, s0 = (float)r.start;
  const int j_lo = (int)fminf(fmaxf(floorf(cm - r.sup) - 2.0f - s0, 0.0f), k);
  const int j_hi = (int)fminf(fmaxf(ceilf(cm + r.sup) + 3.0f - s0, 0.0f), k);

  TreeSum sum(ax.k);
  for (int j = j_lo; j < j_hi; ++j) sum.add(j, r.weight(j));
  const float total = sum.total();

  const long long row = (long long)n * ax.out_size + o;
  int32_t* w = (int32_t*)ax.w + row * ax.T;
  const int T = ax.T, pb = ax.pb;
  int j0 = -1, j1 = 0;
  if (total > 0.0f) {
    for (int j = j_lo; j < j_hi; ++j) {
      const int32_t v = stored(__fdiv_rn(r.weight(j), total), pb);
      if (nonzero(v, pb)) {
        if (j0 < 0) j0 = j;
        j1 = j + 1;
      }
      if (j0 >= 0 && j - j0 < T) w[j - j0] = v;
    }
  } else {  // a sub-pixel box: the one-hot at the nearest input, if in the window
    const float jn = fminf(fmaxf(rintf(cm), 0.0f), r.in_last) - s0;
    if (jn >= 0.0f && jn < k) {
      j0 = (int)jn;
      j1 = j0 + 1;
      w[0] = stored(1.0f, pb);
    }
  }
  const int cnt = j0 < 0 ? 0 : j1 - j0;
  if (cnt > T) {
    printf("crop_tables: image %d axis %d row %d has %d taps, more than the bound T=%d\n",
           n, a, o, cnt, T);
    __trap();
  }
  for (int i = cnt; i < T; ++i) w[i] = 0;
  ax.first[row] = r.start + (j0 < 0 ? 0 : j0);
  ax.cnt[row] = cnt;
}

bool bad_axis(int in_size, int out_size, int k, int align, int hi_start, int T, int pb) {
  return in_size < 1 || out_size < 0 || k < 1 || align < 1 || hi_start < 0 || T < 1 ||
         pb > 30 || pb == 0 || pb < -1;
}

}  // namespace

extern "C" {

// Both passes' tables from boxes [N, 4] (float32, device) on `stream`; per
// axis (H, then W): in_size, out_size, the window k, its start alignment,
// its largest start hi_start, the tap bound T, pb (-1: float32 weights),
// then first [N, out] int32, cnt [N, out] int32, w [N, out, T] (int32 when
// pb >= 0, else float32), device pointers.  filter: 0 triangle, 2 Hamming,
// 4 box (crop_cuda._TABLE_FILTERS); support: its unwidened support.
// Returns the cudaError_t of the launch (0 on success).
int ia_crop_tables(const void* boxes, int N, int filter, float support, int antialias,
                   int in_h, int out_h, int k_h, int align_h, int hi_start_h, int T_h,
                   int pb_h, void* first_h, void* cnt_h, void* w_h, int in_w, int out_w,
                   int k_w, int align_w, int hi_start_w, int T_w, int pb_w, void* first_w,
                   void* cnt_w, void* w_w, void* stream) {
  if (N < 1 || (filter != ia::kTriangle && filter != ia::kHamming && filter != kBox) ||
      bad_axis(in_h, out_h, k_h, align_h, hi_start_h, T_h, pb_h) ||
      bad_axis(in_w, out_w, k_w, align_w, hi_start_w, T_w, pb_w))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.boxes = (const float*)boxes;
  p.N = N;
  p.filter = filter;
  p.antialias = antialias;
  p.support = support;
  p.ax[0] = Axis{in_h, out_h, k_h, align_h, hi_start_h, T_h, pb_h, (int*)first_h,
                 (int*)cnt_h, w_h};
  p.ax[1] = Axis{in_w, out_w, k_w, align_w, hi_start_w, T_w, pb_w, (int*)first_w,
                 (int*)cnt_w, w_w};
  const long long rows = (long long)N * (out_h > out_w ? out_h : out_w);
  if (rows == 0) return 0;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), 2);
  crop_tables_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
