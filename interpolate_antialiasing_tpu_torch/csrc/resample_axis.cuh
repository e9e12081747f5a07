// Kernel B, pil_resample_axis and the crop passes: one separable resample
// pass over one axis, x viewed as [outer, n_in, inner] -> out [outer, n_out,
// inner].  inner == 1 is a pass over the last axis; NCHW and NHWC both run
// through the view, with no moves.  The kernel is templated on the weight
// source and its accumulation (Acc, ia_taps.cuh):
//
//   * TableTaps / SynthTaps, float32: uint8, float32 or bfloat16 in and out,
//
//       out[j, o, i] = sum_k w[o, k] * x[j, clamp(first[o] + k, 0, n_in - 1), i]
//
//     each product and sum rounded in tap order from 0 (ia_dtypes.cuh::mac,
//     bit for bit the plain version's), stored as ia_dtypes.cuh stores.
//     resample_axis.cu holds the entry points (ia_resample_axis over host
//     tables, ia_resample_axis_fused over weights synthesised in the
//     kernel).  Replaces interpolate_antialiasing_tpu/ops/pallas_resize.py::
//     _kernel_last / _kernel_mid (resize_axis_pallas), their fused twins
//     _kernel_last_fused / _kernel_mid_fused, the per-axis passes of
//     _kernel_last_unrolled / _kernel_mid_unrolled, and serves the sharded
//     float H pass banded_pass_mid_dynamic over each shard's tables;
//   * PilTaps, Pillow's 8bpc int32 pass, uint8 in and out:
//
//       acc = (1 << (pb-1)) + sum_k Wb[o,k] * x[j, clamp(xmin[o]+k, 0, n_in-1), i]
//       out[j, o, i] = clip(acc >> pb, 0, 255)   (arithmetic shift, then clip8)
//
//     pil_resample_axis.cu holds its entry point.  Replaces
//     interpolate_antialiasing_tpu/ops/pil_exact.py::_kernel_mid_digit
//     (digit_pass_mid_dynamic), the sharded byte-exact route's H pass, and
//     runs that route's W pass.  The host checks that the int32 sum cannot
//     overflow;
//   * either source with one table per image (crop_resample.cu, the
//     windowed crop's two passes over per-image boxes): outer is images
//     of per_img planes each, and a block's planes lie in one image
//     (tiles along outer are cut at image edges), whose table it stages.
//     The crop's own instantiation (C = true) finds each tile's window in
//     the block.  It also takes each row's true tap count (crop_row.cuh's
//     Pass): a row with more taps than the tables hold (a box wider than
//     the image) computes its weights again from its box.  A tile that
//     holds such a row, or whose taps pass its window, is staged in chunks
//     of its outputs (crop_tile_chunked): each wide row's weights once per
//     block into shared memory, each chunk's window and weights within the
//     plan's; only a row too wide for a chunk of one output reads device
//     memory.  The crop's float32-intermediate passes
//     (crop_resample_f32.cu) are the same instantiation over TableTaps
//     with uint8 -> float32 (H) and float32 -> uint8 (W) elements; their
//     W pass may mirror an image (crop_row.cuh's Pass::flip), whose rows
//     past the bound then take the mirrored row's weights.
//
// Taps past a window carry zero weight, so the clamp never adds signal.
//
// Design.  One block of 256 threads per tile of tile_j planes (along outer)
// x tile_o outputs x tile_i inner columns; the host plan
// (ops/cuda_resize.py::_plan_axis) picks the tile from the shape and the
// card's SM count with a model of the launch fitted to every tile timed on
// the H100 (tools/sweep_axis_plans.py).  A block:
//
//   1. reads its output tile's first input row from the host's table
//      (win0, cuda_resize._win0) and stages the plan's window of `win` rows
//      from there, so no copy waits for the first taps (the crop's
//      instantiation, whose first taps the boxes set on the device, stages
//      its weights and first taps first and reduces them in one warp);
//   2. stages its outputs' first taps and weights in shared memory,
//      tap-major: host tables by 4-byte cp.async in the same round trip as
//      the window (stage_async()); synthesised weights are evaluated once
//      per output and tap while the copies are in flight (stage(), the
//      same intrinsics in the same order as the plain version, so the same
//      floats).  A tap outside the staged rows traps (host and kernel
//      disagree);
//   3. stages the window with 16-byte cp.async copies, each piece copied
//      from its first byte aligned down to 16 (rows of 906 float32 or 83
//      uint8, and any plane offset, start anywhere) and placed so that
//      every element of the tile sits at base + jj * sj + (r - r0) * sr +
//      ii * isz (the stride between runs is congruent, mod 16, to their
//      distance in device memory), in up to kGroups commit groups that the
//      block computes as they land.  Two shapes of tile:
//        - contiguous (tile_i == inner): the window of one plane is one run
//          of win * inner elements, a group per few planes.  The last-axis
//          pass (inner == 1, a tile of tile_j rows x tile_o output columns)
//          and NHWC's W pass (inner == 3) take it; tile_j planes share the
//          staged weights;
//        - rows (tile_i < inner, tile_j == 1): a wide inner (NHWC's H pass
//          at 960, the shards at 4096 and 8192) is cut into spans, and the
//          block stages win runs of tile_i elements, a group per column
//          chunk;
//   4. computes: G lanes of a warp per output row (G = 32 where the span
//      is 32 columns wide or more, else the next power of two, and 1 for a
//      row of at most 3 columns: the last axis, NHWC's 3 channels), so
//      neighbouring lanes take neighbouring columns or neighbouring
//      outputs, and loads and stores are coalesced.  A thread keeps its output's weights in
//      registers; where the plan's tile lets it keep one output for the
//      whole tile (the last axis, inner 3), only the plane moves between
//      its rows.  uint8 input takes 4 adjacent columns per thread (V = 4:
//      one 32-bit load per tap, one 32-bit store of uint8 out) where inner,
//      the tile and the plane offset are multiples of 4; elsewhere one
//      column per thread;
//   5. runs a body compiled for the exact tap count (with_taps, up to 16)
//      for rows whose window lies inside the axis, and the clamped loop for
//      the edge rows; one __launch_bounds__ per tap bucket (NT = 8, 16 or 0
//      for a loop), so a 5-tap pass does not pay for 16 taps' registers.
//
// Where no tile fits a block's shared memory (a 58,200-tap box window, say),
// and for passes small enough that a staged block's chain of copies and
// barriers is not hidden (the NHWC headline; cuda_resize.
// _AXIS_UNSTAGED_BYTES), the host passes tile_o = 0, and the entry point
// runs the unstaged body (resample_axis_kernel_unstaged): one thread per
// output element over a grid-stride loop, weights and rows read through the
// cache.  No input the kernels took before is refused.
//
// Bounds.  A pass reads n_in and writes n_out elements per (plane, inner
// column) and does ntaps multiply-adds per output: a few operations per
// byte, far below the ~295 the H100 needs before its tensor cores would
// limit it, so device memory sets the floor.  What the design cuts is
// instructions per output: no weight work per element, 16-byte copies
// instead of a clamped global load per tap, 32-bit index math in the tile,
// and four uint8 outputs per thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "crop_row.cuh"
#include "ia_dtypes.cuh"
#include "ia_taps.cuh"

namespace ia {
namespace rax {

constexpr int kThreads = 256;
// Largest shared memory one block may use on Hopper (227 KB).
constexpr int kSmemLimit = 232448;
constexpr long long kMaxDirectBlocks = 1LL << 22;
// Commit groups a block stages its window in (cp_async_wait_n takes up to 3).
constexpr int kGroups = 4;

// Weight sources read from tables in device memory (staged by 4-byte
// copies); SynthTaps evaluates its weights in the block.
template <typename Taps>
constexpr bool kTables = !std::is_same_v<Taps, SynthTaps>;

// ---------------------------------------------------------------------------
// The plan and the shared-memory layout
// ---------------------------------------------------------------------------

struct PlanAxis {
  const int* win0;  // [n_to] each output tile's first input row (device; not the crop's)
  long long outer, inner;
  long long per_img;  // planes (along outer) per image: outer, or a crop's C * rows
  int n_in, n_out, ntaps;
  int tile_j, tile_o, tile_i;  // tile_o == 0: the unstaged body
  int win;                     // widest input window of an output tile
  int n_tj, n_to, n_ti;        // tiles along an image's planes, n_out and inner
  int contig;                  // tile_i == inner
  int lanes;                   // G: lanes per output row
};

// Byte offsets of the dynamic shared memory; ops/cuda_resize.py::
// _axis_smem_bytes computes the same total.  Values past the block's limit
// come out as INT_MAX.
struct Layout {
  int stride;  // bytes between staged runs (planes, or rows of the window)
  int data, ws, fs, tot, total;
};

__host__ __device__ __forceinline__ Layout layout(int tile_j, int tile_o,
                                                  int tile_i, int win,
                                                  int ntaps, int isz,
                                                  long long n_in,
                                                  long long inner) {
  Layout L{};
  long long stride, data;
  if (tile_i == inner) {  // one run per plane: win * inner elements
    stride = ((win * inner * isz + 15 + 15) & ~15LL) + 16 + ((n_in * inner * isz) & 15);
    data = tile_j * stride + 16;
  } else {  // one run per row of the window: tile_i elements
    stride = (((long long)tile_i * isz + 15 + 15) & ~15LL) + 16 + ((inner * isz) & 15);
    data = win * stride + 16;
  }
  const long long total = ((data + 15) & ~15LL) + (((long long)ntaps * tile_o * 4 + 15) & ~15LL) +
                          2 * (((long long)tile_o * 4 + 15) & ~15LL);
  if (total > kSmemLimit) {
    L.total = INT_MAX;
    return L;
  }
  L.stride = (int)stride;
  int off = 0;
  L.data = off; off += align16((int)data);
  L.ws = off;   off += align16(ntaps * tile_o * 4);
  L.fs = off;   off += align16(tile_o * 4);
  L.tot = off;  off += align16(tile_o * 4);
  L.total = off;
  return L;
}

// Bytes [b0, b1) of runs [i_lo, i_hi) into shared memory, run i from
// g0 + i * gstride in device memory: byte x of run i lands at
// dst + h0 + i * dstride + x (h0 = g0 mod 16), each 16-byte copy from its
// piece's first byte aligned down to 16.  dstride is congruent to gstride
// mod 16, so every copy's destination is aligned too.  The block's threads
// share the pieces.
__device__ __forceinline__ void stage_part(const char* g0, long long gstride, int i_lo,
                                           int i_hi, int b0, int b1, unsigned char* dst,
                                           int dstride) {
  const int h0 = (int)((uintptr_t)g0 & 15u);
  const int pmax = (b1 - b0 + 30) >> 4;  // pieces of a range with a 15-byte head
  for (int idx = threadIdx.x; idx < (i_hi - i_lo) * pmax; idx += kThreads) {
    const int di = idx / pmax, q = idx - di * pmax;
    const int i = i_lo + di;
    const char* a0 = g0 + i * gstride + b0;
    const int h = (int)((uintptr_t)a0 & 15u);
    if (q < ((h + b1 - b0 + 15) >> 4)) {
      cp_async16(dst + h0 + i * dstride + b0 - h + q * 16, a0 - h + q * 16);
    }
  }
}

// ---------------------------------------------------------------------------
// One output row's V columns
// ---------------------------------------------------------------------------

template <typename A, int V>
struct Vals {
  A a[V];
};

// Exactly N taps at q + k * sr, weights wv[k] in registers: every load
// before the multiply-add chain, in tap order, no tap predicated.  V = 4:
// four uint8 columns per 32-bit load.
template <int N, int V, typename Tin, typename P, typename W, int NW>
__device__ __forceinline__ Vals<typename P::A, V> dot_exact(
    const unsigned char* q, int sr, const W (&wv)[NW], typename P::A init) {
  Vals<typename P::A, V> r;
  if constexpr (V == 1) {
    Tin xv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) xv[k] = *(const Tin*)(q + k * sr);
    r.a[0] = init;
#pragma unroll
    for (int k = 0; k < N; ++k) r.a[0] = P::step(r.a[0], wv[k], xv[k]);
  } else {
    uint32_t xv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) xv[k] = *(const uint32_t*)(q + k * sr);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      r.a[v] = init;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        r.a[v] = P::step_byte(r.a[v], wv[k], (xv[k] >> (8 * v)) & 255u);
      }
    }
  }
  return r;
}

// Any n taps, each index clamped to the axis, weights from shared memory
// (wcol[k * tile_o]): the edge rows and the loop bucket, out of line (one
// copy rather than one per exact tap count).
template <int V, typename Tin, typename P, typename W>
__device__ __noinline__ Vals<typename P::A, V> dot_clamped(
    const unsigned char* plane, int sr, const W* wcol, int tile_o, int first,
    int n, int n_in, int r0, typename P::A init) {
  Vals<typename P::A, V> r;
#pragma unroll
  for (int v = 0; v < V; ++v) r.a[v] = init;
  for (int k = 0; k < n; ++k) {
    const unsigned char* q = plane + (clampi(first + k, 0, n_in - 1) - r0) * sr;
    const W w = wcol[k * tile_o];
    if constexpr (V == 1) {
      r.a[0] = P::step(r.a[0], w, *(const Tin*)q);
    } else {
      const uint32_t x = *(const uint32_t*)q;
#pragma unroll
      for (int v = 0; v < V; ++v) r.a[v] = P::step_byte(r.a[v], w, (x >> (8 * v)) & 255u);
    }
  }
  return r;
}

__device__ __forceinline__ void store4(uint8_t* p, const uint8_t (&v)[4]) {
  *(uint32_t*)p = (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
                  ((uint32_t)v[3] << 24);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 (&v)[4]) {
  const uint32_t lo = (uint32_t)__bfloat16_as_ushort(v[0]) |
                      ((uint32_t)__bfloat16_as_ushort(v[1]) << 16);
  const uint32_t hi = (uint32_t)__bfloat16_as_ushort(v[2]) |
                      ((uint32_t)__bfloat16_as_ushort(v[3]) << 16);
  *(uint2*)p = make_uint2(lo, hi);
}

// ---------------------------------------------------------------------------
// Crop tiles past the one-window path
// ---------------------------------------------------------------------------

// A crop row's weight as the weight source holds it: K_j, or band_j's bits.
template <typename W>
__device__ __forceinline__ W as_weight(int32_t v) {
  if constexpr (std::is_same_v<W, float>) {
    return __int_as_float(v);
  } else {
    return (W)v;
  }
}

// Whether a crop pass over Tin elements may mirror its rows
// (crop_row.cuh's source_row): only the float32-intermediate W pass reads
// float32, so the uint8 passes compile without the branch.
template <typename Tin>
inline constexpr bool kMirrors = std::is_same_v<Tin, float>;

// Output o of image n over its cnt taps from `first` (xp: its column at
// input row 0, rows `inner` apart), a row with more taps than the tables
// hold, for the unstaged body: each weight again from the box, as the
// table kernel computes it (crop_row.cuh), in tap order.  `rs` caches the
// row's geometry and total while the caller stays on the same row (rs_key:
// n * n_out + o).  Out of line, and given values rather than references to
// kernel parameters (whose address would move them to local memory).
template <typename P, typename Tin>
__device__ __noinline__ typename P::A wide_dot(const crop::Pass cp, long long n, int o,
                                               int first, int cnt, const Tin* xp,
                                               long long inner, int n_in, typename P::A acc,
                                               crop::RowSum& rs, long long& rs_key) {
  const long long key = n * cp.g.out_size + o;
  if (key != rs_key) {
    rs = crop::row_sum(cp.g, n, crop::source_row<kMirrors<Tin>>(cp, n, o));
    rs_key = key;
  }
  const int j0 = first - rs.r.start;
  for (int i = 0; i < cnt; ++i) {
    const int32_t v = crop::stored(__fdiv_rn(rs.r.weight(j0 + i), rs.total), cp.g.pb);
    acc = P::step(acc, as_weight<typename P::W>(v), xp[clampi(first + i, 0, n_in - 1) * inner]);
  }
  return acc;
}

// A crop tile that the one-window path cannot stage: one of its rows counts
// more taps than the tables hold (a box wider than the image), or its taps
// span more than `win` rows (a box wider than max_box_frac).  Outputs [o0,
// o0 + no) of planes [j0, j0 + nj) and columns [i0, i0 + ni), over the
// staged first taps fs and true counts cs of its block (ws, the tables'
// weights, is free for this path's own).  The block walks its outputs in
// chunks and stages each like a tile of its own:
//
//   1. each wide row's total, once: one crop::row_sum per row, a thread
//      each, into the last tile_o slots of ws;
//   2. a chunk of n outputs from o0 + c0, halved from the last chunk's size
//      until its window (least clamped first tap to greatest clamped
//      first + cnt - 1) spans at most `win` rows and its weights, n x cm
//      (cm the chunk's greatest count), fit the other tile_o * (T - 1)
//      slots of ws; every warp finds the same chunk from fs and cs;
//   3. the chunk's window by 16-byte copies into the data region, and
//      meanwhile its weights into ws, tap-major [cm][n], spread over the
//      block: a wide row's cnt weights from its box (crop::stored of
//      weight_at / total, the table kernel's code, so its bits), a row
//      within the bound its own from the tables, zeros past each count;
//   4. each output of the chunk over cm taps, tap k at clamp(first + k, 0,
//      last) for last its row's clamped first + cnt - 1: the taps past a
//      row's count weigh +0, which adds exactly in int32 and in float32, so
//      the sum in tap order is the plain version's.
//
// A row alone whose window or weights still do not fit (a box many times
// wider than the image, or tile_o = 1) reads its taps from device memory,
// its weights computed once per block in groups of the slots, its partial
// sums between groups in the data region (4 bytes per element; the region
// holds about `win` >= 4 bytes per element wherever a row's taps pass the
// window, and elements beyond its room go in further batches).  Out of
// line, and given values rather than references, as wide_dot: the staged
// body's registers are its own.
template <typename Tin, typename Tout, typename Taps, int NT, int V>
__device__ __noinline__ void crop_tile_chunked(const Tin* __restrict__ x,
                                               Tout* __restrict__ out, const Taps taps,
                                               const PlanAxis p, const crop::Pass cp,
                                               int img, long long j0, int nj, int o0, int no,
                                               long long i0, int ni) {
  using P = Acc<Taps>;
  using W = typename P::W;
  using A = typename P::A;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int isz = (int)sizeof(Tin);
  const Layout L = layout(p.tile_j, p.tile_o, p.tile_i, p.win, p.ntaps, isz, p.n_in, p.inner);
  unsigned char* D = smem + L.data;
  W* ws = (W*)(smem + L.ws);
  const int* fs = (const int*)(smem + L.fs);
  const int* cs = (const int*)(smem + L.tot);
  const int tid = threadIdx.x, lane = tid & 31;
  const int T = p.ntaps, S = p.tile_o * (T - 1);  // weight slots of a chunk
  float* tot = (float*)(ws + S);                  // [tile_o] wide rows' totals
  const Taps tp = taps.image(img);
  const A init = P::init(taps);

  // 1. each wide row's total
  for (int t = tid; t < no; t += kThreads) {
    if (cs[t] > T) {
      tot[t] = crop::row_sum(cp.g, img, crop::source_row<kMirrors<Tin>>(cp, img, o0 + t)).total;
    }
  }
  const crop::Row box = crop::box_row(cp.g, img);
  // row t's weight j (j < its count; 0 past it)
  auto weight = [&](int t, int j) -> W {
    const int cnt = cs[t];
    if (j >= cnt) return W(0);
    if (cnt <= T) return tp.row(o0 + t)(j);
    crop::Row r = box;
    r.center = box.center_of(crop::source_row<kMirrors<Tin>>(cp, img, o0 + t));
    return as_weight<W>(crop::stored(__fdiv_rn(r.weight_at(fs[t] + j), tot[t]), cp.g.pb));
  };
  const int sj = p.contig ? L.stride : 0;
  const int sr = p.contig ? (int)p.inner * isz : L.stride;

  int ch = no;
  for (int c0 = 0; c0 < no;) {
    // 2. the chunk
    int n, lo, hi, cm;
    bool fits;
    for (;;) {
      n = min(ch, no - c0);
      lo = INT_MAX, hi = INT_MIN, cm = 1;
      for (int t = c0 + lane; t < c0 + n; t += 32) {
        const int f = fs[t], c = cs[t];
        lo = min(lo, clampi(f, 0, p.n_in - 1));
        hi = max(hi, clampi(f + max(c, 1) - 1, 0, p.n_in - 1));
        cm = max(cm, c);
      }
      for (int s = 16; s > 0; s >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
        cm = max(cm, __shfl_xor_sync(0xffffffffu, cm, s));
      }
      fits = hi - lo < p.win && n * cm <= S;
      if (fits || n == 1) break;
      ch = n / 2;
    }
    __syncthreads();  // the last chunk's reads of ws and D are done; the totals landed

    if (!fits) {  // row c0 alone, from device memory
      const int t = c0, f = fs[t], cnt = cs[t], ne = nj * ni;
      // its elements in batches whose partial sums fit the data region
      // (all of them at once wherever the row's taps pass the window)
      const int cap = cnt <= S ? ne : max(1, (L.ws - L.data) / (int)sizeof(A));
      A* part = (A*)D;
      for (int e0 = 0; e0 < ne; e0 += cap) {
        const int e1 = min(ne, e0 + cap);
        for (int g = 0; g < cnt; g += S) {
          const int gn = min(S, cnt - g);
          if (g > 0 || e0 > 0) __syncthreads();
          for (int k = tid; k < gn; k += kThreads) ws[k] = weight(t, g + k);
          __syncthreads();
          for (int e = e0 + tid; e < e1; e += kThreads) {
            const int i = e % ni, jj = e / ni;
            const Tin* xp = x + (j0 + jj) * p.n_in * p.inner + i0 + i;
            A acc = g == 0 ? init : part[e - e0];
            for (int k = 0; k < gn; ++k) {
              acc = P::step(acc, ws[k], xp[clampi(f + g + k, 0, p.n_in - 1) * p.inner]);
            }
            if (g + gn < cnt) {
              part[e - e0] = acc;
            } else {
              out[((j0 + jj) * p.n_out + o0 + t) * p.inner + i0 + i] =
                  P::template put<Tout>(acc, taps);
            }
          }
        }
      }
      c0 += 1;
      continue;
    }

    // 3. the window by 16-byte copies, the weights meanwhile
    const int rows = hi - lo + 1;
    const char* g0 = (const char*)x + ((j0 * p.n_in + lo) * p.inner + i0) * isz;
    if (p.contig) {
      stage_part(g0, p.n_in * p.inner * isz, 0, nj, 0, rows * (int)p.inner * isz, D, sj);
    } else {
      stage_part(g0, p.inner * isz, 0, rows, 0, ni * isz, D, sr);
    }
    cp_async_commit();
    for (int k = tid; k < n * cm; k += kThreads) {
      const int j = k / n, t = k - j * n;
      ws[k] = weight(c0 + t, j);
    }
    cp_async_wait_n(0);
    __syncthreads();

    // 4. the chunk's outputs: rows (plane jj, output t) over the slots, G
    // lanes per row over its columns, V columns per lane, as the one-window
    // path maps them; a thread keeps its row's weights and tap offsets
    // (window row clamp(first + k, 0, last) - lo, times sr) in registers
    // while it walks the row's columns and, where the slots step by whole
    // chunks (dt == 0), the planes
    const unsigned char* base = D + ((unsigned)(uintptr_t)g0 & 15u);
    const int G = p.lanes, R = 32 / G, step = (kThreads / 32) * R;
    const int nrows = nj * n;
    int split = 1;
    while (split * 2 * nrows <= step) split *= 2;
    const int rstep = step / split;
    const int slot = (tid >> 5) * R + (tid & 31) / G;
    const int cw = G * V * split;
    const int cb = ((tid & (G - 1)) + (slot / rstep) * G) * V;
    const int dj = rstep / n, dt = rstep - dj * n;
    constexpr int K = NT > 0 ? NT : 1;
    const bool regs = NT > 0 && cm <= NT;  // else the weights from ws
    W wv[K];
    int off[K];
    int t_cur = -1, f = 0, last = 0;
    int q = slot % rstep;
    int jj = q / n, t = q - jj * n;
    auto tap = [&](Vals<A, V>& r, W w, const unsigned char* qk) {
      if constexpr (V == 1) {
        r.a[0] = P::step(r.a[0], w, *(const Tin*)qk);
      } else {
        const uint32_t xv = *(const uint32_t*)qk;
#pragma unroll
        for (int v = 0; v < V; ++v) r.a[v] = P::step_byte(r.a[v], w, (xv >> (8 * v)) & 255u);
      }
    };
    for (; q < nrows; q += rstep) {
      if (t != t_cur) {
        t_cur = t;
        f = fs[c0 + t] - lo;
        last = clampi(fs[c0 + t] + max(cs[c0 + t], 1) - 1, 0, p.n_in - 1) - lo;
        if (regs) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k < cm) {
              wv[k] = ws[k * n + t];
              off[k] = clampi(f + k, -lo, last) * sr;
            }
          }
        }
      }
      const unsigned char* plane = base + jj * sj;
      Tout* op = out + ((j0 + jj) * p.n_out + o0 + c0 + t) * p.inner + i0;
      for (int c = cb; c < ni; c += cw) {
        const unsigned char* qc = plane + c * isz;
        Vals<A, V> r;
#pragma unroll
        for (int v = 0; v < V; ++v) r.a[v] = init;
        if (regs) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k < cm) tap(r, wv[k], qc + off[k]);
          }
        } else {
          for (int k = 0; k < cm; ++k) tap(r, ws[k * n + t], qc + clampi(f + k, -lo, last) * sr);
        }
        if constexpr (V == 1) {
          op[c] = P::template put<Tout>(r.a[0], taps);
        } else {
          Tout v4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v4[u] = P::template put<Tout>(r.a[u], taps);
          store4(op + c, v4);
        }
      }
      jj += dj;
      t += dt;
      if (t >= n) {
        t -= n;
        ++jj;
      }
    }
    c0 += n;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The unstaged body (tile_o == 0): one thread per output element.  Its own
// __global__, so that its few registers, and not the tiled body's 52-80,
// set how many of its threads an SM holds (a gather through the cache
// wants them all).  cp: the crop instantiation's row source (read only
// where C).
template <typename Tin, typename Tout, typename Taps, bool C = false>
__global__ void __launch_bounds__(kThreads)
resample_axis_kernel_unstaged(const Tin* __restrict__ x, Tout* __restrict__ out,
                              Taps taps, PlanAxis p, const crop::Pass cp) {
  using P = Acc<Taps>;
  const long long total = p.outer * p.n_out * p.inner;
  const long long stride = (long long)gridDim.x * kThreads;
  [[maybe_unused]] crop::RowSum rs;
  [[maybe_unused]] long long rs_key = -1;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx % p.inner;
    const long long jo = idx / p.inner;
    const int o = (int)(jo % p.n_out);
    const long long j = jo / p.n_out;
    const Tin* xp = x + j * p.n_in * p.inner + i;
    Taps t = taps;
    if constexpr (C) t = taps.image(j / p.per_img);
    const auto row = t.row(o);
    typename P::A acc = P::init(t);
    if constexpr (C) {  // a row past the tables' bound: from its box
      const long long n = j / p.per_img;
      const int cnt = cp.cnt[n * p.n_out + o];
      if (cnt > p.ntaps) {
        acc = wide_dot<P>(cp, n, o, row.first, cnt, xp, p.inner, p.n_in, acc, rs, rs_key);
        out[idx] = P::template put<Tout>(acc, t);
        continue;
      }
    }
    for (int k = 0; k < p.ntaps; ++k) {
      acc = P::step(acc, row(k), xp[clampi(row.first + k, 0, p.n_in - 1) * p.inner]);
    }
    out[idx] = P::template put<Tout>(acc, t);
  }
}

// NT: the tap bucket (8 or 16 unrolled, 0 for a loop); V: inner columns per
// thread (4 only for uint8 input); C: the crop passes' instantiation, whose
// blocks find their windows and may read device memory instead, with its
// row source `cp` (read only where C).
template <typename Tin, typename Tout, typename Taps, int NT, int V, bool C = false>
__global__ void __launch_bounds__(kThreads, NT == 16 ? 3 : 4)
resample_axis_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                     Taps taps, PlanAxis p, const crop::Pass cp) {
  using P = Acc<Taps>;
  using W = typename P::W;
  using A = typename P::A;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int isz = (int)sizeof(Tin);
  const Layout L = layout(p.tile_j, p.tile_o, p.tile_i, p.win, p.ntaps, isz,
                          p.n_in, p.inner);
  W* ws = (W*)(smem + L.ws);  // [ntaps][tile_o]
  int* fs = (int*)(smem + L.fs);  // [tile_o] first taps
  const int tid = threadIdx.x;

  int blk = blockIdx.x;
  const int ti = blk % p.n_ti;
  blk /= p.n_ti;
  const int to = blk % p.n_to;
  blk /= p.n_to;
  // the crop's per-image tables: blocks along an image's planes, then images
  int img = 0, tj = blk;
  if constexpr (C) {
    tj = blk % p.n_tj;
    img = blk / p.n_tj;
  }
  const long long jt = (long long)tj * p.tile_j;  // first plane within the image
  const long long j0 = img * p.per_img + jt;
  const int nj = (int)min((long long)p.tile_j, p.per_img - jt);
  const Taps tp = C ? taps.image(img) : taps;
  const int o0 = to * p.tile_o;
  const int no = min(p.tile_o, p.n_out - o0);
  const long long i0 = (long long)ti * p.tile_i;
  const int ni = (int)min((long long)p.tile_i, p.inner - i0);

  // 1. the tile's input window along the axis: from the host's first row
  // of each output tile, as wide as the plan's widest (clamped to the axis)
  int r0;
  if constexpr (C) {
    // the crop's window starts at its outputs' least first tap, which the
    // boxes set: the weights, first taps and true tap counts land first
    // (the counts in the weight sources' scratch, which tables leave
    // unused), one warp reduces them, and a tile whose taps pass `win` rows,
    // or that holds a row with more taps than the tables (a box wider than
    // the image), is staged in chunks
    int* cs = (int*)(smem + L.tot);  // [tile_o] true tap counts
    __shared__ int s_r0;
    tp.stage_async(o0, no, p.tile_o, ws, fs);
    for (int t = tid; t < no; t += kThreads) {
      cp_async4(cs + t, cp.cnt + (long long)img * p.n_out + o0 + t);
    }
    cp_async_commit();
    cp_async_wait_n(0);
    __syncthreads();
    if (tid < 32) {
      int lo = INT_MAX, hi = INT_MIN, wide = 0;
      for (int t = tid; t < no; t += 32) {
        lo = min(lo, clampi(fs[t], 0, p.n_in - 1));
        hi = max(hi, clampi(fs[t] + p.ntaps - 1, 0, p.n_in - 1));
        wide |= cs[t] > p.ntaps;
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      wide = __any_sync(0xffffffffu, wide);
      if (tid == 0) s_r0 = !wide && hi - lo < p.win ? lo : -1;
    }
    __syncthreads();
    r0 = s_r0;
    if (r0 < 0) {  // past the one-window path: staged in chunks
      crop_tile_chunked<Tin, Tout, Taps, NT, V>(x, out, taps, p, cp, img, j0, nj, o0, no, i0,
                                                ni);
      return;
    }
  } else {
    r0 = p.win0[to];
  }
  const int rows = min(p.win, p.n_in - r0);

  // 2. where the window lands in shared memory, and how the threads cover
  // the tile
  const char* g0 = (const char*)x + ((j0 * p.n_in + r0) * p.inner + i0) * isz;
  unsigned char* D = smem + L.data;
  const unsigned char* base = D + ((unsigned)(uintptr_t)g0 & 15u);
  const int sj = p.contig ? L.stride : 0;  // staged bytes between planes
  const int sr = p.contig ? (int)p.inner * isz : L.stride;  // between window rows
  // rows (plane jj, output t) over the warps, G lanes per row over its
  // columns, V columns per lane; where the tile has fewer rows than a pass
  // of the block, `split` slots share a row and split its columns
  const int G = p.lanes, R = 32 / G;
  const int step = (kThreads / 32) * R;
  const int nrows = nj * p.tile_o;
  int split = 1;
  while (split * 2 * nrows <= step) split *= 2;
  const int rstep = step / split;
  const int slot = (tid >> 5) * R + (tid & 31) / G;
  const int q0 = slot % rstep;
  const int cw = G * V * split;  // columns of one pass of the slots
  const int c0 = ((tid & (G - 1)) + (slot / rstep) * G) * V;
  // up to kGroups commit groups: the planes of a contiguous tile, the
  // column chunks of a rows tile; each is computed as soon as it lands
  // while the later ones are in flight
  int ng, per;  // groups; planes or column passes per group
  if (p.contig) {
    ng = min(kGroups, nj);
    per = (nj + ng - 1) / ng;
    ng = (nj + per - 1) / per;
  } else {
    const int passes = (ni + cw - 1) / cw;
    ng = min(kGroups, passes);
    per = (passes + ng - 1) / ng;
    ng = (passes + per - 1) / per;
  }
  // 3. host tables' weights and first taps by 4-byte copies in the first
  // group, then the window's groups: one round trip for all of them
  if constexpr (kTables<Taps> && !C) tp.stage_async(o0, no, p.tile_o, ws, fs);
  for (int g = 0; g < ng; ++g) {
    if (p.contig) {
      stage_part(g0, p.n_in * p.inner * isz, g * per, min(nj, (g + 1) * per), 0,
                 rows * (int)p.inner * isz, D, sj);
    } else {
      stage_part(g0, p.inner * isz, 0, rows, g * per * cw * isz,
                 min(ni, (g + 1) * per * cw) * isz, D, sr);
    }
    cp_async_commit();
  }
  // synthesised weights: evaluated while the copies are in flight
  if constexpr (!kTables<Taps>) tp.stage(o0, no, p.tile_o, ws, fs, (float*)(smem + L.tot));

  // 4. each group as it lands: rows over the slots, a body compiled for
  // the exact tap count (where the row's window lies inside the axis)
  // the sums' constants are every image's (Pillow's pb): the kernel's
  // parameter, not the image's copy
  const A init = P::init(taps);
  Tout* const obase = out + (j0 * p.n_out + o0) * p.inner + i0;
  auto body = [&](auto taps_n) {
    constexpr int N = decltype(taps_n)::value;
    W wv[NT > 0 ? NT : 1];
    int t_cur = -1, first = 0;
    bool inside = false;
    // output t's first tap and weights into this thread's registers
    auto load_row = [&](int t) {
      if (t == t_cur) return;
      t_cur = t;
      first = fs[t];
      inside = first >= 0 && first + p.ntaps <= p.n_in;
      if (clampi(first, 0, p.n_in - 1) < r0 ||
          clampi(first + p.ntaps - 1, 0, p.n_in - 1) >= r0 + rows) {
        __trap();  // the host's window misses a tap: host and kernel disagree
      }
#pragma unroll
      for (int k = 0; k < (NT > 0 ? NT : 1); ++k) {
        if (NT > 0 && k < p.ntaps) wv[k] = ws[k * p.tile_o + t];
      }
    };
    // columns [clo, chi) of output t in plane jj, this thread's share
    auto row = [&](const unsigned char* plane, Tout* op, int t, int clo, int chi) {
      for (int c = clo + c0; c < chi; c += cw) {
        Vals<A, V> r;
        bool done = false;
        if constexpr (N > 0) {
          if (inside) {
            r = dot_exact<N, V, Tin, P>(plane + (first - r0) * sr + c * isz, sr, wv, init);
            done = true;
          }
        }
        if (!done) {
          r = dot_clamped<V, Tin, P>(plane + c * isz, sr, ws + t, p.tile_o, first, p.ntaps,
                                     p.n_in, r0, init);
        }
        if constexpr (V == 1) {
          op[c] = P::template put<Tout>(r.a[0], taps);
        } else {
          Tout v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = P::template put<Tout>(r.a[u], taps);
          store4(op + c, v);
        }
      }
    };
    const int dj = rstep / p.tile_o, dt = rstep - dj * p.tile_o;
    for (int g = 0; g < ng; ++g) {
      cp_async_wait_n(ng - 1 - g);  // group g has landed
      __syncthreads();
      int qlo = 0, qhi = nrows, clo = 0, chi = ni;
      if (p.contig) {
        qlo = g * per * p.tile_o;
        qhi = min(nj, (g + 1) * per) * p.tile_o;
      } else {
        clo = g * per * cw;
        chi = min(ni, (g + 1) * per * cw);
      }
      int q = q0 + ((qlo - q0 + rstep - 1) / rstep) * rstep;
      int jj = q / p.tile_o, t = q - jj * p.tile_o;
      if (dt == 0) {  // the same output on every pass: only the plane moves
        if (t >= no) continue;
        load_row(t);
        const unsigned char* plane = base + jj * sj;
        Tout* op = obase + ((long long)jj * p.n_out + t) * p.inner;
        const long long ostep = (long long)dj * p.n_out * p.inner;
        for (; q < qhi; q += rstep, plane += dj * sj, op += ostep) row(plane, op, t, clo, chi);
        continue;
      }
      for (; q < qhi; q += rstep) {
        if (t < no) {
          load_row(t);
          row(base + jj * sj, obase + ((long long)jj * p.n_out + t) * p.inner, t, clo, chi);
        }
        jj += dj;
        t += dt;
        if (t >= p.tile_o) {
          t -= p.tile_o;
          ++jj;
        }
      }
    }
  };
  if constexpr (NT > 0) {
    with_taps<NT == 16 ? 9 : 1, NT>(p.ntaps, body);
  } else {
    body(Int<0>{});
  }
}

// ---------------------------------------------------------------------------
// Host side: checks, launch and occupancy, dispatched on dtypes, NT and V
// ---------------------------------------------------------------------------

template <typename Taps>
struct Args {
  const void* x;
  void* out;
  Taps taps;
  PlanAxis p;
  int smem;
  unsigned blocks;
  cudaStream_t stream;
  int* occupancy;  // non-null: report resident blocks per SM, launch nothing
  crop::Pass crop;  // the crop passes' row source (every kernel takes it; C reads it)
};

template <typename Tin, typename Tout, typename Taps, int NT, int V, bool C = false>
int run(const Args<Taps>& a) {
  if (a.p.tile_o == 0 && a.occupancy == nullptr) {
    resample_axis_kernel_unstaged<Tin, Tout, Taps, C><<<a.blocks, kThreads, 0, a.stream>>>(
        (const Tin*)a.x, (Tout*)a.out, a.taps, a.p, a.crop);
    return (int)cudaGetLastError();
  }
  auto* kernel = resample_axis_kernel<Tin, Tout, Taps, NT, V, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  if (a.occupancy != nullptr) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.occupancy, kernel, kThreads, a.smem);
  }
  kernel<<<a.blocks, kThreads, a.smem, a.stream>>>((const Tin*)a.x, (Tout*)a.out,
                                                   a.taps, a.p, a.crop);
  return (int)cudaGetLastError();
}

template <typename Taps, int NT, int V>
struct Launch {
  template <typename Tin, typename Tout>
  struct Op {
    static int run(const Args<Taps>& a) { return rax::run<Tin, Tout, Taps, NT, V>(a); }
  };
};

// The float kernels for one tap bucket over the dtype pairs (V = 4: uint8
// input only).  resample_axis_{table,synth}_nt{8,16,0}.cu instantiate it,
// one source each, so nvcc compiles them in parallel.
template <typename Taps, int NT>
int launch_nt(const Args<Taps>& a, int in_dt, int out_dt, int vec) {
  if (vec == 4) {
    if (in_dt != kU8) return (int)cudaErrorInvalidValue;
    return dispatch_out<Launch<Taps, NT, 4>::template Op, uint8_t>(out_dt, a);
  }
  return dispatch_dtypes<Launch<Taps, NT, 1>::template Op>(in_dt, out_dt, a);
}

// The Pillow kernel for one tap bucket (uint8 -> uint8).
// pil_resample_axis.cu instantiates it.
template <int NT>
int launch_pil_nt(const Args<PilTaps>& a, int vec) {
  return vec == 4 ? run<uint8_t, uint8_t, PilTaps, NT, 4>(a)
                  : run<uint8_t, uint8_t, PilTaps, NT, 1>(a);
}

#ifndef IA_RAX_INSTANTIATE  // instantiated in resample_axis_*_nt*.cu
#define IA_RAX_EXTERN(TAPS, NT) \
  extern template int launch_nt<TAPS, NT>(const Args<TAPS>&, int, int, int);
IA_RAX_EXTERN(TableTaps, 8) IA_RAX_EXTERN(TableTaps, 16) IA_RAX_EXTERN(TableTaps, 0)
IA_RAX_EXTERN(SynthTaps, 8) IA_RAX_EXTERN(SynthTaps, 16) IA_RAX_EXTERN(SynthTaps, 0)
#undef IA_RAX_EXTERN
#endif
// The crop passes' kernel for one weight source and tap bucket (uint8 ->
// uint8; crop_resample.cu instantiates it).
template <typename Taps, int NT>
int launch_crop_nt(const Args<Taps>& a, int vec) {
  return vec == 4 ? run<uint8_t, uint8_t, Taps, NT, 4, true>(a)
                  : run<uint8_t, uint8_t, Taps, NT, 1, true>(a);
}

// The float32-intermediate crop passes' kernel for one tap bucket, over
// float32 tables: the H pass uint8 -> float32 (four columns per thread
// where the plan asks), the W pass float32 -> uint8.  crop_resample_f32.cu
// instantiates it, so nvcc compiles it beside crop_resample.cu.
template <int NT>
int launch_crop_f32_nt(const Args<TableTaps>& a, int in_dt, int vec) {
  if (in_dt == kU8) {
    return vec == 4 ? run<uint8_t, float, TableTaps, NT, 4, true>(a)
                    : run<uint8_t, float, TableTaps, NT, 1, true>(a);
  }
  return vec == 1 ? run<float, uint8_t, TableTaps, NT, 1, true>(a)
                  : (int)cudaErrorInvalidValue;
}

#ifndef IA_RAX_CROP_F32_INSTANTIATE  // instantiated in crop_resample_f32.cu
extern template int launch_crop_f32_nt<8>(const Args<TableTaps>&, int, int);
extern template int launch_crop_f32_nt<16>(const Args<TableTaps>&, int, int);
extern template int launch_crop_f32_nt<0>(const Args<TableTaps>&, int, int);
#endif

#ifndef IA_RAX_PIL_INSTANTIATE  // instantiated in pil_resample_axis.cu
extern template int launch_pil_nt<8>(const Args<PilTaps>&, int);
extern template int launch_pil_nt<16>(const Args<PilTaps>&, int);
extern template int launch_pil_nt<0>(const Args<PilTaps>&, int);
#endif

__host__ inline int itemsize(int dt) {
  return dt == kU8 ? 1 : dt == kF32 ? 4 : dt == kBF16 ? 2 : 0;
}

__host__ inline int tap_bucket(int ntaps) {
  return ntaps <= 8 ? 8 : ntaps <= 16 ? 16 : 0;
}

// The instantiation of a pass's tap bucket: the float kernels over the
// dtype pair, and the Pillow kernel (uint8 -> uint8).
template <typename Taps>
int dispatch_bucket(const Args<Taps>& a, int in_dt, int out_dt, int vec) {
  switch (tap_bucket(a.taps.ntaps)) {
    case 8: return launch_nt<Taps, 8>(a, in_dt, out_dt, vec);
    case 16: return launch_nt<Taps, 16>(a, in_dt, out_dt, vec);
  }
  return launch_nt<Taps, 0>(a, in_dt, out_dt, vec);
}

inline int dispatch_bucket(const Args<PilTaps>& a, int vec) {
  switch (tap_bucket(a.taps.ntaps)) {
    case 8: return launch_pil_nt<8>(a, vec);
    case 16: return launch_pil_nt<16>(a, vec);
  }
  return launch_pil_nt<0>(a, vec);
}

// Checks the plan against the kernel's layout (`smem` must equal it and fit
// a block) and fills `a`; tile_o == 0 asks for the unstaged body (smem 0).
// per_img: planes per image of per-image tables (outer, or 0 for outer:
// one table); crop: the crop passes' instantiation (no win0: the block
// finds its window).  Returns 0 or a cudaError_t.
template <typename Taps>
int make_args(Args<Taps>& a, const void* x, void* out, int in_dt,
              long long outer, int n_in, long long inner, int n_out,
              const void* win0, int tile_j, int tile_o, int tile_i, int win,
              int vec, int smem, void* stream, long long per_img = 0,
              bool crop = false) {
  const int isz = itemsize(in_dt);
  const int ntaps = a.taps.ntaps;
  if (per_img == 0) per_img = outer;
  if (isz == 0 || outer < 1 || n_in < 1 || inner < 1 || n_out < 1 || ntaps < 1 ||
      per_img < 1 || outer % per_img != 0 || outer / per_img > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  PlanAxis p{};
  p.outer = outer;
  p.inner = inner;
  p.per_img = per_img;
  p.n_in = n_in;
  p.n_out = n_out;
  p.ntaps = ntaps;
  long long blocks;
  if (tile_o == 0) {
    if (smem != 0 || vec != 1) return (int)cudaErrorInvalidValue;
    const long long total = outer * n_out * inner;
    blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxDirectBlocks) blocks = kMaxDirectBlocks;
  } else {
    if (tile_j < 1 || tile_o < 1 || tile_i < 1 || tile_i > inner || win < 1 ||
        (win0 == nullptr && !crop)) {
      return (int)cudaErrorInvalidValue;
    }
    p.contig = tile_i == inner;
    if (!p.contig && tile_j != 1) return (int)cudaErrorInvalidValue;
    if (vec == 4) {  // 4 uint8 columns per thread, every access aligned
      if (isz != 1 || inner % 4 != 0 || tile_i % 4 != 0 ||
          ((uintptr_t)x & 3) != 0 || ((uintptr_t)out & 3) != 0) {
        return (int)cudaErrorInvalidValue;
      }
    } else if (vec != 1) {
      return (int)cudaErrorInvalidValue;
    }
    const Layout L = layout(tile_j, tile_o, tile_i, win, ntaps, isz, n_in, inner);
    if (L.total != smem || smem + 64 > kSmemLimit) return (int)cudaErrorInvalidValue;
    p.win0 = (const int*)win0;
    p.tile_j = tile_j;
    p.tile_o = tile_o;
    p.tile_i = tile_i;
    p.win = win;
    p.n_tj = (int)min((per_img + tile_j - 1) / tile_j, (long long)INT_MAX);
    p.n_to = (n_out + tile_o - 1) / tile_o;
    p.n_ti = (int)((inner + tile_i - 1) / tile_i);
    // lanes per output row (cuda_resize._lanes): a row of at most 3
    // columns (NHWC's channels) is one thread's, so no lane idles
    const int cols = (tile_i + vec - 1) / vec;
    p.lanes = 1;
    while (cols > 3 && p.lanes < 32 && p.lanes < cols) p.lanes *= 2;
    blocks = outer / per_img * p.n_tj * p.n_to * p.n_ti;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  }
  a.x = x;
  a.out = out;
  a.p = p;
  a.smem = smem;
  a.blocks = (unsigned)blocks;
  a.stream = (cudaStream_t)stream;
  return 0;
}

}  // namespace rax
}  // namespace ia
