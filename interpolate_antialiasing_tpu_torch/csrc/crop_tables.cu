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
// Two designs, chosen by the host's plan (crop_cuda._table_plan) from the
// launch's shape.  Where one thread per row gives every SM a block and no
// row of a box within the bound walks more than 16 taps (the train batch),
// crop_tables_kernel_serial gives each (axis, image, output row) one
// thread: row_sum, then the compaction, each weight evaluated again.
// Elsewhere (a few large frames, whose rows are wide and few) a group of G
// lanes takes a row, G 8, 16 or 32 (the least whose kChunks chunks hold
// the axis's widest row within the bound), kThreads / G rows a block.  In
// both the W axis's blocks follow the H axis's (H from box columns 0 and
// 2, W from 1 and 3).
// The row's geometry, its weights and the order of its sum come from
// crop_row.cuh (row_range, Row::weight, TreeSum, stored), which the crop
// passes share for rows past the bound T, in the plain version's float32
// steps (crop_cuda._windowed_band; the header lists them).  The group:
//
//   weights  lane l evaluates taps j_lo + c G + l of the row's range, each
//            once, into registers and shared memory; a row of more than
//            kChunks G taps (a box many times the image) is taken in
//            segments that end on a sum window's border;
//   total    lane l folds the segment's l-th window of 32 taps in tap order
//            from +0 (crop_cuda._tree_sum's order), and the window sums
//            join the levels above in order (TreeSum over the windows,
//            built on the host), in every lane alike;
//   tables   each lane divides its own weights by the total (stored), a
//            ballot per chunk gives j0, j1 (the first and one-past-last
//            nonzero value, K_j or band_j), and the lanes write first =
//            start + j0, cnt = j1 - j0 (0, with j0 = 0, for a row without
//            one) and w[i] = value_{j0 + i} for i < min(cnt, T), then 0 up
//            to T.  A row past kChunks G taps evaluates its weights again.
//
// A flip folded into the W tables (the float32-intermediate route's
// flip_w) moves no weight: row o of a mirrored image is computed as any
// row o, and written into output out_size - 1 - o's slot (slot()), so a
// mirrored output holds bit for bit the taps its unmirrored twin has.
//
// A row whose total is 0 (a sub-pixel box) takes the one-hot at
// clamp(rint(center - 0.5), 0, in_size - 1) (half to even, as
// torch.round).  A row of a box wider than the image can count more than T
// taps: its cnt is the true count, w holds its first T weights, and the
// crop pass computes the others again from the box (resample_axis.cuh).
// Every shuffle, ballot and sync names the whole warp, and each loop that
// holds one runs as often in every group of a warp: a mask per group made
// the compiler wrap each collective in a loop over the warp's groups.
//
// Bounds: at the train batch (b64 u8 [64, 3, 438, 906] -> 224^2) it writes
// 64 * 224 * (2 + 5 + 2 + 10) * 4 bytes, about 1.1 MB (0.0003 ms at 3.35
// TB/s), and evaluates about 12 filter taps per row: one thread per row,
// 224 blocks, where an empty kernel takes 0.0009 ms.  Inside the crop call
// it takes 0.0080 ms there, 0.0085 to 0.0087 at 4K (G = 8 and 16) and
// 0.0112 to 0.0113 with b64 zoom-out boxes (tools/time_crop_calls.py;
// NVIDIA H100 80GB HBM3, 700.00 W).  Groups lose at the train
// batch: G = 8 takes 0.0075 there back to back but 0.0123 inside the call,
// since after large crop passes the group kernel takes about 4
// microseconds more than back to back and one thread per row does not.
// They win where rows are wide or few: 64 4K frames 0.0155 against 0.0247
// one thread per row, 8 train images 0.0033 against 0.0074, in the call
// (tools/sweep_table_lanes.py).  Its time is each row's chain of dependent
// steps (geometry, the sum, the compaction) and the latency of those
// chains; it needs no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crop_row.cuh"

namespace {

using namespace ia::crop;

constexpr int kThreads = 128;  // crop_cuda._TABLE_THREADS
constexpr int kChunks = 4;     // a row's taps a lane holds: up to kChunks chunks of G
constexpr unsigned kWarp = 0xffffffffu;

struct Axis {
  Geom g;
  int T;      // the tap bound
  int G;      // lanes per row: 8, 16 or 32
  int front;  // zeros in front of the first sum window (sum_windows(g.k))
  TreeSum up;  // the sum of the windows' sums, empty
  int* first;
  int* cnt;
  void* w;  // int32 when g.pb >= 0, else float32
  const uint8_t* flip;  // [N] bool, the images whose rows land mirrored; or null
};

// Where row (image n, output o) of an axis is written: its own slot, or
// output out_size - 1 - o's in an image the axis mirrors (a horizontal
// flip folded into the W tables).  The row's values are the same either
// way.
__device__ __forceinline__ int slot(const Axis& ax, int row) {
  const int out = ax.g.out_size, n = row / out;
  return ax.flip != nullptr && ax.flip[n] ? (int)(2LL * n * out + out - 1 - row) : row;
}

struct Params {
  int N;
  int blocks0;  // the H axis's blocks; the W axis's follow them
  Axis ax[2];
};

// Output row `row` of an axis by a group of G lanes (lane l, the group's
// first lane `base` in the warp; `live` false for a group past the axis's
// rows, which only joins the warp's collectives), buf its kChunks * G
// floats of shared memory.  Every shuffle, ballot and sync names the whole
// warp: its groups run each one together (a mask per group made the
// compiler serialise the groups around every collective), and each loop
// that holds one runs as often in every group of the warp.
template <int G, int F>
__device__ __forceinline__ void table_row(const Axis& ax, int row, bool live, int l, int base,
                                          float* buf) {
  constexpr int kCap = G * kChunks;
  constexpr unsigned kGroup = G == 32 ? kWarp : (1u << G) - 1u;
  const Geom& g = ax.g;
  RowSum s{};
  if (live) s = row_range(g, row / g.out_size, row % g.out_size);
  const Row& r = s.r;
  const int L = s.j_hi - s.j_lo;

  // The total in TreeSum's order: segments of at most kCap taps that end
  // on a window border (but the last: one segment unless L > kCap); lane
  // l holds taps a + c * G + l of a segment (in wr[c], kept for the
  // division, and in buf), folds the segment's l-th window in tap order,
  // and the window sums join the levels above in order, in every lane of
  // the group alike.
  const int front = ax.front;
  TreeSum up = ax.up;
  float wr[kChunks];
  for (int a = s.j_lo; __any_sync(kWarp, a < s.j_hi);) {
    const bool on = a < s.j_hi;  // (a group whose row is done keeps its weights)
    int e = min(s.j_hi, a + kCap);
    if (e < s.j_hi) e = (e + front) / kSumWindow * kSumWindow - front;
#pragma unroll
    for (int c = 0; c < kChunks && on && c * G < e - a; ++c) {
      const int j = a + c * G + l;
      wr[c] = j < e ? r.weight<F>(j) : 0.0f;
      buf[c * G + l] = wr[c];
    }
    __syncwarp(kWarp);
    const int i0 = (a + front) / kSumWindow, i1 = on ? (e - 1 + front) / kSumWindow : i0 - 1;
    float ws = 0.0f;
    if (i0 + l <= i1) {
      const int w0 = (i0 + l) * kSumWindow - front;
      const int t1 = min(e, w0 + kSumWindow);
      for (int t = max(a, w0); t < t1; ++t) ws = __fadd_rn(ws, buf[t - a]);
    }
#pragma unroll
    for (int q = 0; q <= kCap / kSumWindow; ++q) {  // at most that many windows
      const float v = __shfl_sync(kWarp, ws, q, G);
      if (i0 + q <= i1) up.add(i0 + q, v);
    }
    __syncwarp(kWarp);  // the folds have read buf
    if (on) a = e;
  }
  const float total = up.total();

  // The compaction: j0, j1 the first and one-past-last nonzero value, from
  // a ballot per chunk of G taps; w[j - j0] for j - j0 < min(cnt, T), each
  // lane its own taps, then zeros up to T.  A row of one segment divides
  // the weights its lanes hold; a longer one evaluates each again.
  const int T = ax.T, pb = g.pb;
  const int dst = live ? slot(ax, row) : row;
  int32_t* w = (int32_t*)ax.w + (long long)dst * T;
  const bool held = total > 0.0f && L <= kCap, again = total > 0.0f && L > kCap;
  int j0 = -1, j1 = 0;
  int32_t v[kChunks];
  const int chunks = __reduce_max_sync(kWarp, held ? (L + G - 1) / G : 0);  // in the warp
#pragma unroll
  for (int c = 0; c < kChunks && c < chunks; ++c) {
    const bool tap = held && c * G + l < L;
    v[c] = tap ? stored(__fdiv_rn(wr[c], total), pb) : 0;
    const unsigned nz = (__ballot_sync(kWarp, tap && nonzero(v[c], pb)) >> base) & kGroup;
    if (nz) {
      if (j0 < 0) j0 = s.j_lo + c * G + __ffs(nz) - 1;
      j1 = s.j_lo + c * G + 32 - __clz(nz);
    }
  }
  if (held) {
    const int n_w = j0 < 0 ? 0 : min(j1 - j0, T);
#pragma unroll
    for (int c = 0; c < kChunks && c < chunks; ++c) {
      const int i = s.j_lo + c * G + l - j0;
      if (i >= 0 && i < n_w) w[i] = v[c];
    }
  }
  for (int a = s.j_lo; __any_sync(kWarp, again && a < s.j_hi); a += G) {
    const int j = a + l;
    const bool tap = again && j < s.j_hi;
    const int32_t u = tap ? stored(__fdiv_rn(r.weight<F>(j), total), pb) : 0;
    const unsigned nz = (__ballot_sync(kWarp, tap && nonzero(u, pb)) >> base) & kGroup;
    if (nz) {
      if (j0 < 0) j0 = a + __ffs(nz) - 1;
      j1 = a + 32 - __clz(nz);
    }
    if (tap && j0 >= 0 && j >= j0 && j - j0 < T) w[j - j0] = u;
  }
  if (live && !(total > 0.0f)) {  // a sub-pixel box: the one-hot at the nearest input
    const float jn = fminf(fmaxf(rintf(__fsub_rn(r.center, 0.5f)), 0.0f), r.in_last) -
                     (float)r.start;
    if (jn >= 0.0f && jn < (float)g.k) {
      j0 = (int)jn;
      j1 = j0 + 1;
      if (l == 0) w[0] = stored(1.0f, pb);
    }
  }
  __syncwarp(kWarp);  // a long row's writes past cnt come before the zeros
  if (!live) return;
  const int cnt = j0 < 0 ? 0 : j1 - j0;
  for (int i = min(cnt, T) + l; i < T; i += G) w[i] = 0;
  if (l == 0) {
    ax.first[dst] = r.start + (j0 < 0 ? 0 : j0);
    ax.cnt[dst] = cnt;
  }
}

// Block b of an axis: kThreads / G groups, one row each.
template <int G, int F>
__device__ __forceinline__ void block_rows(const Axis& ax, int N, int b, float* buf) {
  const int group = threadIdx.x / G, l = threadIdx.x % G;
  const int row = b * (kThreads / G) + group;
  table_row<G, F>(ax, row, row < N * ax.g.out_size, l, (threadIdx.x & 31) - l,
                  buf + group * kChunks * G);
}

template <int F>
__device__ __forceinline__ void block_rows_g(const Axis& ax, int N, int b, float* buf) {
  switch (ax.G) {
    case 8: block_rows<8, F>(ax, N, b, buf); break;
    case 16: block_rows<16, F>(ax, N, b, buf); break;
    default: block_rows<32, F>(ax, N, b, buf); break;
  }
}

// One thread per row (the plan's G = 1, a launch whose one-thread grid
// fills the card with narrow rows): row_sum one tap after the other, then
// the compaction, each weight evaluated again.
__device__ __forceinline__ void serial_row(const Axis& ax, int row) {
  const Geom& g = ax.g;
  const RowSum s = row_sum(g, row / g.out_size, row % g.out_size);
  const Row& r = s.r;
  const int dst = slot(ax, row);
  int32_t* w = (int32_t*)ax.w + (long long)dst * ax.T;
  const int T = ax.T, pb = g.pb;
  int j0 = -1, j1 = 0;
  if (s.total > 0.0f) {
    for (int j = s.j_lo; j < s.j_hi; ++j) {
      const int32_t v = stored(__fdiv_rn(r.weight(j), s.total), pb);
      if (nonzero(v, pb)) {
        if (j0 < 0) j0 = j;
        j1 = j + 1;
      }
      if (j0 >= 0 && j - j0 < T) w[j - j0] = v;
    }
  } else {  // a sub-pixel box: the one-hot at the nearest input, if in the window
    const float jn = fminf(fmaxf(rintf(__fsub_rn(r.center, 0.5f)), 0.0f), r.in_last) -
                     (float)r.start;
    if (jn >= 0.0f && jn < (float)g.k) {
      j0 = (int)jn;
      j1 = j0 + 1;
      w[0] = stored(1.0f, pb);
    }
  }
  const int cnt = j0 < 0 ? 0 : j1 - j0;
  for (int i = cnt; i < T; ++i) w[i] = 0;
  ax.first[dst] = r.start + (j0 < 0 ? 0 : j0);
  ax.cnt[dst] = cnt;
}

__global__ void __launch_bounds__(kThreads) crop_tables_kernel_serial(Params p) {
  const int a = blockIdx.x >= (unsigned)p.blocks0;
  const int b = (int)blockIdx.x - (a ? p.blocks0 : 0);
  const Axis& ax = p.ax[a];
  const int row = b * kThreads + (int)threadIdx.x;
  if (row < p.N * ax.g.out_size) serial_row(ax, row);
}

__global__ void __launch_bounds__(kThreads) crop_tables_kernel(Params p) {
  __shared__ float buf[kThreads * kChunks];
  const int a = blockIdx.x >= (unsigned)p.blocks0;
  const int b = (int)blockIdx.x - (a ? p.blocks0 : 0);
  const Axis& ax = p.ax[a];
  switch (ax.g.filter) {  // the filter known to the weight code
    case ia::kTriangle: block_rows_g<ia::kTriangle>(ax, p.N, b, buf); break;
    case kBox: block_rows_g<kBox>(ax, p.N, b, buf); break;
    default: block_rows_g<ia::kHamming>(ax, p.N, b, buf); break;
  }
}

bool bad_axis(int N, int in_size, int out_size, int k, int align, int hi_start, int T, int pb,
              int G, int blocks) {
  return in_size < 1 || out_size < 0 || k < 1 || align < 1 || hi_start < 0 || T < 1 ||
         pb > 30 || pb == 0 || pb < -1 || (G != 1 && G != 8 && G != 16 && G != 32) ||
         blocks < 0 ||
         (long long)N * out_size > 0x7fffffffLL ||
         (long long)blocks * (kThreads / G) < (long long)N * out_size;
}

Axis make_axis(const float* boxes, int axis, int in_size, int out_size, int k, int align,
               int hi_start, int T, int pb, int G, void* first, void* cnt, void* w,
               int filter, int antialias, float support, const void* flip) {
  Axis x{};
  x.g = Geom{boxes, axis, in_size, out_size, k, align, hi_start, pb, filter, antialias, support};
  x.T = T;
  x.G = G;
  const SumWindows sw = sum_windows(k);
  x.front = sw.front;
  x.up = TreeSum(sw.count);
  x.first = (int*)first;
  x.cnt = (int*)cnt;
  x.w = w;
  x.flip = (const uint8_t*)flip;
  return x;
}

}  // namespace

extern "C" {

// Both passes' tables from boxes [N, 4] (float32, device) on `stream`; per
// axis (H, then W): in_size, out_size, the window k, its start alignment,
// its largest start hi_start, the tap bound T, pb (-1: float32 weights),
// the lanes per row G (8, 16 or 32; 1 on both axes: one thread per row)
// and the axis's blocks (at least N * out_size / (kThreads / G)), then
// first [N, out] int32, cnt [N, out] int32, w [N, out, T] (int32 when pb
// >= 0, else float32), device pointers.  filter: 0 triangle, 2 Hamming, 4
// box (crop_cuda._TABLE_FILTERS); support: its unwidened support.
// flip_w: [N] bool (device), the images whose W rows land mirrored (output
// o's slot holds row out_w - 1 - o's tables), or null.  Returns the
// cudaError_t of the launch (0 on success).
int ia_crop_tables(const void* boxes, int N, int filter, float support, int antialias,
                   int in_h, int out_h, int k_h, int align_h, int hi_start_h, int T_h,
                   int pb_h, int G_h, int blocks_h, void* first_h, void* cnt_h, void* w_h,
                   int in_w, int out_w, int k_w, int align_w, int hi_start_w, int T_w,
                   int pb_w, int G_w, int blocks_w, void* first_w, void* cnt_w, void* w_w,
                   const void* flip_w, void* stream) {
  if (N < 1 || (filter != ia::kTriangle && filter != ia::kHamming && filter != kBox) ||
      bad_axis(N, in_h, out_h, k_h, align_h, hi_start_h, T_h, pb_h, G_h, blocks_h) ||
      bad_axis(N, in_w, out_w, k_w, align_w, hi_start_w, T_w, pb_w, G_w, blocks_w) ||
      (G_h == 1) != (G_w == 1) || (long long)blocks_h + blocks_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* b = (const float*)boxes;
  Params p{};
  p.N = N;
  p.blocks0 = blocks_h;
  p.ax[0] = make_axis(b, 0, in_h, out_h, k_h, align_h, hi_start_h, T_h, pb_h, G_h, first_h,
                      cnt_h, w_h, filter, antialias, support, nullptr);
  p.ax[1] = make_axis(b, 1, in_w, out_w, k_w, align_w, hi_start_w, T_w, pb_w, G_w, first_w,
                      cnt_w, w_w, filter, antialias, support, flip_w);
  if (blocks_h + blocks_w == 0) return 0;
  if (G_h == 1 && G_w == 1)
    crop_tables_kernel_serial<<<blocks_h + blocks_w, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    crop_tables_kernel<<<blocks_h + blocks_w, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
