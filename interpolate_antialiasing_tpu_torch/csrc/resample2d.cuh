// Kernel A: the two-pass separable resample of [B, H, W] planes (W pass,
// then H pass), templated on the weight source and its accumulation (Acc,
// ia_taps.cuh):
//
//   * float (TableTaps, SynthTaps): uint8 / float32 / bfloat16 in and out,
//     float32 accumulation.  resample2d.cu holds the entry point over host
//     tables (ia_resample2d), resample2d_fused.cu over weights synthesised
//     in the kernel (ia_resample2d_fused); resample2d_tc{16,32,64,128}.cu
//     and resample2d_fused_tc{16,32,64,128}.cu compile its instantiations,
//     one source per column tile and weight source;
//   * Pillow (PilTaps): uint8 in and out, Pillow's 8bpc int32 sums and a
//     uint8 intermediate, byte-identical to PIL.Image.resize (the Pillow
//     two-pass kernel; entry pil_resample.cu, instantiations
//     pil_resample_tc{16,32,64,128}.cu; see there for the TPU kernels it
//     replaces).
//
// The float route:
//
// Replaces interpolate_antialiasing_tpu/ops/pallas_resize.py::_kernel_2pass
// (wrapper resize2d_onekernel, and its adjoint resize2d_onekernel_transpose
// over W^T tables) and serves the shapes of its streamed twin
// _kernel_2pass_streamed (resize2d_streamed): a block reads only the input
// rows its output tile needs, so no image is too large for it.  With the
// synthesised weights it replaces the fused_spec branch of
// _kernel_last_unrolled / _kernel_mid_unrolled (resize2d_pallas(fused=True)).
// The TPU kernels contract tile-compacted weight bands on the matrix unit in
// split-bf16; here each output is a direct windowed float32 multiply-add
// (ia_dtypes.cuh::mac, bit for bit the plain version's):
//
//   y[o] = sum_k w[o, k] * x[clamp(first[o] + k, 0, in - 1)]
//
// Taps past the window carry zero weight, so the clamp never adds signal
// (the replicate border folds its weights onto the edge tap on the host and
// relies on the same clamp).  For uint8 -> uint8 the W pass result is put on
// the uint8 lattice (floor(v + 0.5), clamped) before the H pass, as Pillow
// and the JAX package's _quant_u8grid do.  The float intermediate stays
// float32 in shared memory for every dtype; Pillow's is its clip8 byte.
//
// Design.  One block of 256 threads per output tile (plane, tile_r output
// rows, TC output columns), all on gridDim.x; TC (16, 32, 64 or 128) is a
// template parameter, so the thread -> column map is a mask and a shift.
// The host plan (ops/cuda_resize.py::_plan_rows) picks the tile from the
// batch and the card's SM count, so that a launch has at least two waves of
// two resident blocks per SM where the image allows it.  A block:
//
//   1. writes its TC columns' first W taps and weights, and its tile_r
//      rows' first H taps and weights, into shared memory, tap-major
//      ([ntaps][tile]: a warp reads them without bank conflicts).  Host
//      tables are copied; synthesised weights are evaluated once per output
//      and tap with the closed form of ia_taps.cuh (the same intrinsics in
//      the same order, so the same floats);
//   2. reduces its input row window [r0, r1) and its column span
//      [c_lo, c_hi) from those first taps, one warp each, with shuffles
//      (the host computed the widest of each the same way; a window wider
//      than the plan's traps);
//   3. streams the window through a ring of row chunks in shared memory
//      with 16-byte cp.async copies: each row's copy starts at its first
//      byte aligned down to 16 (rows of 906 float32 or 83 uint8 start
//      anywhere) and ends rounded up, so the head and tail are copied whole
//      and skipped on read.  With two stages the copy of chunk i + 1
//      overlaps the W pass of chunk i, and shared memory does not grow with
//      the downscale factor (only the intermediate [rows][TC] does); where
//      the whole window fits one chunk, as the plan prefers
//      (each chunk is a round trip the block waits for), the ring has one
//      stage and other resident blocks cover the wait;
//   4. runs the W pass from the staged rows: a thread keeps one column and
//      its weights in registers for the whole window and computes two rows
//      per step (two independent chains), each loading all its taps before
//      its multiply-add chain.  An output whose window lies inside the row,
//      as most do, runs a loop body compiled for its exact tap count (up
//      to 16, chosen once per chunk), loads at constant offsets and
//      predicates nothing; the edge outputs clamp each tap, unrolled for up
//      to 8 or 16 taps (NT, a template parameter: the bucket of the larger
//      ntaps, which also bounds the registers); beyond 16, a loop;
//   5. runs the H pass from the intermediate to the output the same way
//      (Pillow's: four adjacent columns per thread, one 32-bit load of its
//      byte intermediate per tap, pil_h4).
//
// Bounds.  BASELINE config 5 (bf16 [64, 3, 2160, 3840] -> 1080x1920) must
// move 3.19 GB in and 0.80 GB out, 1.19 ms at the H100's 3.35 TB/s, and
// does about 4.2e9 multiply-adds: about one operation per byte moved, where
// the card needs ~295 operations per byte before its tensor cores, rather
// than its memory, would be the limit.  So the kernel is bound by bytes and
// by instruction issue, not by the matrix unit: tensor cores are not used
// (a product with 5-13 nonzero taps per output would waste most of each
// MMA tile on zeros, and the plain version's rounding in tap order, which
// the kernel must equal, is not what an MMA computes).  What the design
// cuts is instructions per output: no weight work per element, 16-byte
// copies instead of one clamped global load per tap, 32-bit index math
// within a plane (64-bit plane offsets: config 5 holds 1.59e9 elements).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "ia_dtypes.cuh"
#include "ia_taps.cuh"

namespace ia {
namespace r2d {

constexpr int kThreads = 256;
// Largest shared memory one block may use on Hopper (227 KB, static and
// dynamic together).
constexpr int kSmemLimit = 232448;

struct Plan2d {
  int H, W, OH, OW;
  int quant;  // uint8 -> uint8: quantise the W pass result
  int tile_r, n_ty, n_tx;
  int rows_cap, cols_cap, chunk;  // widest row window, column span; ring rows
  int ntaps_w, ntaps_h;
};


// Byte offsets of the dynamic shared memory; ops/cuda_resize.py::_smem_bytes
// computes the same total.
struct Layout {
  int stride;  // bytes per staged input row
  int ring, inter, ww, fw, tw, wh, fh, th, total;
};

// itemsize: bytes of an input element; inter_size: of an intermediate one
// (Acc<Taps>::I: 4, or 1 for Pillow's bytes).
__host__ __device__ __forceinline__ Layout layout(int tile_r, int tile_c,
                                                  int rows_cap, int cols_cap,
                                                  int chunk, int ntaps_w,
                                                  int ntaps_h, int itemsize,
                                                  int inter_size) {
  Layout L;
  // a row's copy: up to 15 bytes of head, cols_cap elements, up to 15 of tail
  L.stride = align16(cols_cap * itemsize) + 32;
  int off = 0;
  // two stages, or one where a chunk holds the whole window
  L.ring = off;  off += (chunk < rows_cap ? 2 : 1) * chunk * L.stride;
  L.inter = off; off += align16(rows_cap * tile_c * inter_size);
  L.ww = off;    off += align16(ntaps_w * tile_c * 4);
  L.fw = off;    off += align16(tile_c * 4);
  L.tw = off;    off += align16(tile_c * 4);
  L.wh = off;    off += align16(ntaps_h * tile_r * 4);
  L.fh = off;    off += align16(tile_r * 4);
  L.th = off;    off += align16(tile_r * 4);
  L.total = off;
  return L;
}

// Byte address of element (r, c) of a plane.
template <typename Tin>
__device__ __forceinline__ const char* elem(const char* plane, int W, int r, int c) {
  return plane + ((long long)r * W + c) * (long long)sizeof(Tin);
}

// Rows [r, r + n) x columns [c_lo, c_lo + span) of a plane into `dst` (row
// stride `stride` bytes), 16 bytes per copy: one warp per row, its lanes
// over the row's 16-byte pieces.
template <typename Tin>
__device__ __forceinline__ void stage_rows(const char* plane, int W, int r, int n,
                                           int c_lo, int span, unsigned char* dst,
                                           int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < n; rr += kThreads / 32) {
    const char* a0 = elem<Tin>(plane, W, r + rr, c_lo);
    const char* a = (const char*)((uintptr_t)a0 & ~(uintptr_t)15);
    const int pieces = ((int)(a0 - a) + span * (int)sizeof(Tin) + 15) >> 4;
    for (int q = lane; q < pieces; q += 32) {
      cp_async16(dst + rr * stride + q * 16, a + q * 16);
    }
  }
}

// One W-pass output from a staged row: taps first + k, k < n, of the row's
// staged span from c_lo, summed by P (Acc<Taps>) from `init`.  NT > 0: taps
// unrolled (n <= NT), weights `wv` in registers, every load before the
// multiply-add chain; an output whose window lies inside the row (`inner`,
// most of them) loads at constant offsets, the others clamp each tap.
// NT = 0: a loop over any n, weights from shared memory (`wcol[k * TC]`).
template <int NT, int TC, typename P, typename Tin, typename Wt>
__device__ __forceinline__ typename P::A w_out(const Tin* srow, int first, int c_lo,
                                               int W, int n, bool inner,
                                               const Wt (&wv)[NT > 0 ? NT : 1],
                                               const Wt* wcol, typename P::A init) {
  typename P::A acc = init;
  if (NT == 0) {
    for (int k = 0; k < n; ++k) {
      acc = P::add(acc, wcol[k * TC], P::take(srow + clampi(first + k, 0, W - 1) - c_lo));
    }
    return acc;
  }
  typename P::X xv[NT > 0 ? NT : 1];
  if (inner) {
    const Tin* q = srow + (first - c_lo);
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < n) xv[k] = P::take(q + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < n) xv[k] = P::take(srow + clampi(first + k, 0, W - 1) - c_lo);
    }
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k < n) acc = P::add(acc, wv[k], xv[k]);
  }
  return acc;
}

// One H-pass output (row i of the tile, column c) from the intermediate,
// whose row 0 is input row r0; NT as for w_out, weights wh[k * tile_r + i]
// (one value for the warp's row: a broadcast).
template <int NT, int TC, typename P, typename I, typename Wt>
__device__ __forceinline__ typename P::A h_out(const I* inter, const Wt* wh, int tile_r,
                                               int i, int first, int n, int H, int r0,
                                               int c, typename P::A init) {
  typename P::A acc = init;
  if (NT == 0) {
    for (int k = 0; k < n; ++k) {
      acc = P::add(acc, wh[k * tile_r + i],
                   P::take(inter + (clampi(first + k, 0, H - 1) - r0) * TC + c));
    }
    return acc;
  }
  typename P::X xv[NT > 0 ? NT : 1];
  Wt wv[NT > 0 ? NT : 1];
  if (first >= 0 && first + n <= H) {
    const I* q = inter + (first - r0) * TC + c;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < n) xv[k] = P::take(q + k * TC);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < n) xv[k] = P::take(inter + (clampi(first + k, 0, H - 1) - r0) * TC + c);
    }
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k < n) wv[k] = wh[k * tile_r + i];
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k < n) acc = P::add(acc, wv[k], xv[k]);
  }
  return acc;
}

// Exactly N taps at constant offsets from q (W pass: a staged row; H pass:
// the intermediate, stride XS = TC), weights w[k * ws]: every load before
// the chain in tap order, no tap predicated.
template <int N, int XS, typename P, typename T, typename Wt>
__device__ __forceinline__ typename P::A dot_exact(const T* q, const Wt* w, int ws,
                                                   typename P::A init) {
  typename P::X xv[N];
  Wt wv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    xv[k] = P::take(q + k * XS);
    wv[k] = w[k * ws];
  }
  typename P::A acc = init;
#pragma unroll
  for (int k = 0; k < N; ++k) acc = P::add(acc, wv[k], xv[k]);
  return acc;
}

// h_out for the rows at the image's top and bottom edges, out of line: one
// copy rather than one per exact tap count.
template <int NT, int TC, typename P, typename I, typename Wt>
__device__ __noinline__ typename P::A h_edge(const I* inter, const Wt* wh, int tile_r,
                                             int i, int first, int n, int H, int r0,
                                             int c, typename P::A init) {
  return h_out<NT, TC, P>(inter, wh, tile_r, i, first, n, H, r0, c, init);
}

// ---------------------------------------------------------------------------
// Pillow's H pass (PilTaps): four bytes per shared-memory load
// ---------------------------------------------------------------------------

// Pillow's H pass for four adjacent columns (cq..cq+3) of tile row i from
// the uint8 intermediate: one 32-bit load per tap, its bytes summed in
// four int32 chains.  N > 0: exactly N taps from row `first` (inside the
// image); N == 0: n taps, each row clamped to the image.
template <int N, int TC>
__device__ __forceinline__ void pil_h4(const uint8_t* inter, const int* wh, int tile_r, int i,
                                       int first, int n, int H, int r0, int cq,
                                       int (&acc)[4]) {
  if constexpr (N > 0) {
    uint32_t xv[N];
    int wv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      xv[k] = *(const uint32_t*)(inter + (first - r0 + k) * TC + cq);
      wv[k] = wh[k * tile_r + i];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] += wv[k] * (int)((xv[k] >> (8 * v)) & 255u);
    }
  } else {
    for (int k = 0; k < n; ++k) {
      const uint32_t x =
          *(const uint32_t*)(inter + (clampi(first + k, 0, H - 1) - r0) * TC + cq);
      const int w = wh[k * tile_r + i];
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] += w * (int)((x >> (8 * v)) & 255u);
    }
  }
}

// pil_h4's clamped edge rows, out of line
template <int TC>
__device__ __noinline__ void pil_h4_edge(const uint8_t* inter, const int* wh, int tile_r, int i,
                                         int first, int n, int H, int r0, int cq,
                                         int (&acc)[4]) {
  pil_h4<0, TC>(inter, wh, tile_r, i, first, n, H, r0, cq, acc);
}

// TC output columns per block; NT: the tap bucket of both passes (8 or 16
// unrolled, 0 for a loop), the host's bucket of max(ntaps_w, ntaps_h).
template <typename Tin, typename Tout, typename Taps, int TC, int NT>
__global__ void __launch_bounds__(kThreads, NT == 16 ? 3 : 4)
resample2d_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                  Taps taps_w, Taps taps_h, Plan2d p) {
  using P = Acc<Taps>;
  // Pillow's H pass reads its uint8 intermediate four columns per thread
  // (pil_h4)
  constexpr bool kPil = std::is_same_v<Taps, PilTaps>;
  using Wt = typename P::W;
  using I = typename P::I;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_win[4];  // r0, r1, c_lo, c_hi
  const Layout L = layout(p.tile_r, TC, p.rows_cap, p.cols_cap, p.chunk,
                          p.ntaps_w, p.ntaps_h, (int)sizeof(Tin), (int)sizeof(I));
  unsigned char* ring = smem + L.ring;  // [stages][chunk][stride] input rows
  I* inter = (I*)(smem + L.inter);      // [rows_cap][TC] W-pass result
  Wt* ww = (Wt*)(smem + L.ww);          // [ntaps_w][TC]
  int* fw = (int*)(smem + L.fw);        // [TC] first W tap
  Wt* wh = (Wt*)(smem + L.wh);          // [ntaps_h][tile_r]
  int* fh = (int*)(smem + L.fh);        // [tile_r] first H tap

  const int blk = blockIdx.x;
  const int tx = blk % p.n_tx;
  const int rest = blk / p.n_tx;
  const int ty = rest % p.n_ty;
  const int b = rest / p.n_ty;
  const int oy0 = ty * p.tile_r;
  const int ox0 = tx * TC;
  const int th = min(p.tile_r, p.OH - oy0);  // ragged bottom edge
  const int tw = min(TC, p.OW - ox0);        // ragged right edge
  const int tid = threadIdx.x;

  // 1. the block's weights
  taps_w.stage(ox0, tw, TC, ww, fw, (float*)(smem + L.tw));
  taps_h.stage(oy0, th, p.tile_r, wh, fh, (float*)(smem + L.th));
  __syncthreads();

  // 2. the input row window (warp 0) and column span (warp 1)
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const int* f = warp == 0 ? fh : fw;
    const int n = warp == 0 ? th : tw;
    const int nt = warp == 0 ? p.ntaps_h : p.ntaps_w;
    const int last = (warp == 0 ? p.H : p.W) - 1;
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = lane; i < n; i += 32) {
      lo = min(lo, clampi(f[i], 0, last));
      hi = max(hi, clampi(f[i] + nt - 1, 0, last) + 1);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_win[2 * warp] = lo;
      s_win[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const int r0 = s_win[0], rows = s_win[1] - s_win[0];
  const int c_lo = s_win[2], span = s_win[3] - s_win[2];
  if (rows > p.rows_cap || span > p.cols_cap) __trap();  // host and kernel disagree

  // this thread's column and its W weights, kept for the whole window
  constexpr int kRowStep = kThreads / TC;
  const int c = tid & (TC - 1);
  const int row0 = tid / TC;
  const int nw = p.ntaps_w, nh = p.ntaps_h;
  Wt wv[NT > 0 ? NT : 1];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k < nw) wv[k] = ww[k * TC + c];
  }
  const int first_w = fw[c];
  const bool inner_w = first_w >= 0 && first_w + nw <= p.W;
  const typename P::A init_w = P::init(taps_w), init_h = P::init(taps_h);

  // 3-4. the row window through the ring, W pass per chunk, two rows per
  // step (independent chains)
  const char* plane = (const char*)(x + (long long)b * p.H * p.W);
  // a staged row's head is its first byte's address mod 16 (32-bit
  // arithmetic wraps by a multiple of 16)
  const unsigned row_bytes = (unsigned)p.W * sizeof(Tin);
  const unsigned head0 = (unsigned)(uintptr_t)plane + (unsigned)r0 * row_bytes +
                         (unsigned)c_lo * sizeof(Tin);
  const int S = L.stride;
  const int nchunks = (rows + p.chunk - 1) / p.chunk;
  stage_rows<Tin>(plane, p.W, r0, min(p.chunk, rows), c_lo, span, ring, S);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int cr0 = ch * p.chunk;
    if (ch + 1 < nchunks) {
      stage_rows<Tin>(plane, p.W, r0 + cr0 + p.chunk,
                      min(p.chunk, rows - cr0 - p.chunk), c_lo, span,
                      ring + ((ch + 1) & 1) * p.chunk * S, S);
    }
    cp_async_commit();
    cp_async_wait_1();  // chunk ch has landed
    __syncthreads();
    const int nr = min(p.chunk, rows - cr0);
    const unsigned char* st = ring + (ch & 1) * p.chunk * S;
    auto w_rows = [&](auto taps) {
      constexpr int N = decltype(taps)::value;
      for (int rr = row0; rr < nr; rr += 2 * kRowStep) {
        const int rr1 = rr + kRowStep;
        const unsigned h = head0 + (unsigned)(cr0 + rr) * row_bytes;
        const Tin* s0 = (const Tin*)(st + rr * S + (h & 15));
        const Tin* s1 = (const Tin*)(st + rr1 * S + ((h + kRowStep * row_bytes) & 15));
        typename P::A a0, a1 = init_w;
        if constexpr (N > 0) {
          a0 = dot_exact<N, 1, P>(s0 + (first_w - c_lo), wv, 1, init_w);
          if (rr1 < nr) a1 = dot_exact<N, 1, P>(s1 + (first_w - c_lo), wv, 1, init_w);
        } else {
          a0 = w_out<NT, TC, P>(s0, first_w, c_lo, p.W, nw, inner_w, wv, ww + c, init_w);
          if (rr1 < nr) {
            a1 = w_out<NT, TC, P>(s1, first_w, c_lo, p.W, nw, inner_w, wv, ww + c, init_w);
          }
        }
        inter[(cr0 + rr) * TC + c] = P::mid(a0, taps_w, p.quant);
        if (rr1 < nr) inter[(cr0 + rr1) * TC + c] = P::mid(a1, taps_w, p.quant);
      }
    };
    if (c < tw) {
      if (inner_w && NT > 0) {
        with_taps<NT == 16 ? 9 : 1, NT>(nw, w_rows);
      } else {
        w_rows(Int<0>{});
      }
    }
    __syncthreads();  // the stage is free for chunk ch + 2
  }

  // 5. H pass: shared memory -> output rows [oy0, oy0 + th), two per step
  // (Pillow's: four columns per thread, a row per step)
  if constexpr (kPil) {
    constexpr int kQ = TC / 4;  // threads per row
    const int cq = (tid % kQ) * 4;
    if (cq >= tw) return;
    uint8_t* ob = (uint8_t*)out + (long long)b * p.OH * p.OW + ox0 + cq;
    const int nv = min(4, tw - cq);
    const bool whole = nv == 4 && (p.OW & 3) == 0 && ((uintptr_t)out & 3) == 0;
    auto h_rows4 = [&](auto taps) {
      constexpr int N = decltype(taps)::value;
      for (int i = tid / kQ; i < th; i += kThreads / kQ) {
        const int f = fh[i];
        int a[4] = {init_h, init_h, init_h, init_h};
        if (N > 0 && f >= 0 && f + N <= p.H) {
          pil_h4<N, TC>((const uint8_t*)inter, (const int*)wh, p.tile_r, i, f, N, p.H, r0, cq, a);
        } else {
          pil_h4_edge<TC>((const uint8_t*)inter, (const int*)wh, p.tile_r, i, f, nh, p.H, r0,
                          cq, a);
        }
        uint8_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = P::template put<uint8_t>(a[u], taps_h);
        uint8_t* o = ob + (long long)(oy0 + i) * p.OW;
        if (whole) {
          *(uint32_t*)o = (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
                          ((uint32_t)v[3] << 24);
        } else {
          for (int u = 0; u < nv; ++u) o[u] = v[u];
        }
      }
    };
    if (NT > 0) {
      with_taps<NT == 16 ? 9 : 1, NT>(nh, h_rows4);
    } else {
      h_rows4(Int<0>{});
    }
    return;
  }
  if (c >= tw) return;
  Tout* ob = out + (long long)b * p.OH * p.OW + ox0 + c;
  auto h_rows = [&](auto taps) {
    constexpr int N = decltype(taps)::value;
    // row i of the tile: exactly N taps where its window lies inside the
    // image (most rows), the clamped bucket path at the edges
    auto one = [&](int i) {
      const int f = fh[i];
      if constexpr (N > 0) {
        if (f >= 0 && f + N <= p.H) {
          return dot_exact<N, TC, P>(inter + (f - r0) * TC + c, wh + i, p.tile_r, init_h);
        }
        return h_edge<NT, TC, P>(inter, wh, p.tile_r, i, f, nh, p.H, r0, c, init_h);
      }
      return h_out<NT, TC, P>(inter, wh, p.tile_r, i, f, nh, p.H, r0, c, init_h);
    };
    for (int i = row0; i < th; i += 2 * kRowStep) {
      const int i1 = i + kRowStep;
      const typename P::A a0 = one(i);
      const typename P::A a1 = i1 < th ? one(i1) : init_h;
      ob[(long long)(oy0 + i) * p.OW] = P::template put<Tout>(a0, taps_h);
      if (i1 < th) ob[(long long)(oy0 + i1) * p.OW] = P::template put<Tout>(a1, taps_h);
    }
  };
  if (NT > 0) {
    with_taps<NT == 16 ? 9 : 1, NT>(nh, h_rows);
  } else {
    h_rows(Int<0>{});
  }
}

// ---------------------------------------------------------------------------
// Host side: launch and occupancy, dispatched on dtypes, TC and NT
// ---------------------------------------------------------------------------

template <typename Taps>
struct Args2d {
  const void* x;
  void* out;
  Taps taps_w, taps_h;
  Plan2d p;
  int tile_c;
  int smem;
  cudaStream_t stream;
  unsigned blocks;
  int* occupancy;  // non-null: report resident blocks per SM, launch nothing
};

template <typename Tin, typename Tout, typename Taps, int TC, int NT>
int run_tc(const Args2d<Taps>& a) {
  auto* kernel = resample2d_kernel<Tin, Tout, Taps, TC, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  if (a.occupancy != nullptr) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.occupancy, kernel, kThreads, a.smem);
  }
  kernel<<<a.blocks, kThreads, a.smem, a.stream>>>(
      (const Tin*)a.x, (Tout*)a.out, a.taps_w, a.taps_h, a.p);
  return (int)cudaGetLastError();
}

// The kernel for one TC, its tap bucket (NT) from the larger ntaps, over
// the dtype pair (Pillow's: uint8 -> uint8 only).  resample2d_tc<TC>.cu
// (tables), resample2d_fused_tc<TC>.cu (synthesised weights) and
// pil_resample_tc<TC>.cu (Pillow's tables) instantiate it, one source each,
// so nvcc compiles them in parallel; the entry points (resample2d.cu,
// resample2d_fused.cu, pil_resample.cu) only declare it.
template <typename Taps, int TC>
struct LaunchTc {
  template <typename Tin, typename Tout>
  struct Op {
    static int run(const Args2d<Taps>& a) {
      const int n = max(a.p.ntaps_w, a.p.ntaps_h);
      if (n <= 8) return run_tc<Tin, Tout, Taps, TC, 8>(a);
      if (n <= 16) return run_tc<Tin, Tout, Taps, TC, 16>(a);
      return run_tc<Tin, Tout, Taps, TC, 0>(a);
    }
  };
};

template <typename Taps, int TC>
int launch_tc(const Args2d<Taps>& a, int in_dt, int out_dt) {
  if constexpr (std::is_same_v<Taps, PilTaps>) {
    if (in_dt != kU8 || out_dt != kU8) return (int)cudaErrorInvalidValue;
    return LaunchTc<Taps, TC>::template Op<uint8_t, uint8_t>::run(a);
  } else {
    return dispatch_dtypes<LaunchTc<Taps, TC>::template Op>(in_dt, out_dt, a);
  }
}

#ifndef IA_R2D_TC  // the entry points: instantiated in resample2d*_tc<TC>.cu
#define IA_R2D_EXTERN(TAPS, TC) \
  extern template int launch_tc<TAPS, TC>(const Args2d<TAPS>&, int, int);
IA_R2D_EXTERN(TableTaps, 16) IA_R2D_EXTERN(TableTaps, 32)
IA_R2D_EXTERN(TableTaps, 64) IA_R2D_EXTERN(TableTaps, 128)
IA_R2D_EXTERN(SynthTaps, 16) IA_R2D_EXTERN(SynthTaps, 32)
IA_R2D_EXTERN(SynthTaps, 64) IA_R2D_EXTERN(SynthTaps, 128)
IA_R2D_EXTERN(PilTaps, 16) IA_R2D_EXTERN(PilTaps, 32)
IA_R2D_EXTERN(PilTaps, 64) IA_R2D_EXTERN(PilTaps, 128)
#undef IA_R2D_EXTERN
#endif

__host__ inline int itemsize(int dt) {
  return dt == kU8 ? 1 : dt == kF32 ? 4 : dt == kBF16 ? 2 : 0;
}

// Checks the plan against the kernel's own layout (`smem` must equal it and
// fit a block), then launches on `stream`, or, with `occupancy` non-null,
// writes the resident blocks per SM there instead.
template <typename Taps>
int launch_2d(const void* x, void* out, int in_dt, int out_dt, int B, int H,
              int W, int OH, int OW, const Taps& taps_w, const Taps& taps_h,
              int quant, int tile_r, int tile_c, int rows_cap, int cols_cap,
              int chunk, int smem, void* stream, int* occupancy) {
  const int isz = itemsize(in_dt);
  if (isz == 0 || tile_r < 1 || rows_cap < 1 || cols_cap < 1 || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(tile_r, tile_c, rows_cap, cols_cap, chunk, taps_w.ntaps,
                          taps_h.ntaps, isz, (int)sizeof(typename Acc<Taps>::I));
  if (L.total != smem || smem + 64 > kSmemLimit) return (int)cudaErrorInvalidValue;
  const Plan2d p{H, W, OH, OW, quant, tile_r, (OH + tile_r - 1) / tile_r,
                 (OW + tile_c - 1) / tile_c, rows_cap, cols_cap, chunk,
                 taps_w.ntaps, taps_h.ntaps};
  const long long blocks = (long long)B * p.n_ty * p.n_tx;
  if (B < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const Args2d<Taps> a{x, out, taps_w, taps_h, p, tile_c, smem,
                       (cudaStream_t)stream, (unsigned)blocks, occupancy};
  switch (tile_c) {
    case 16: return launch_tc<Taps, 16>(a, in_dt, out_dt);
    case 32: return launch_tc<Taps, 32>(a, in_dt, out_dt);
    case 64: return launch_tc<Taps, 64>(a, in_dt, out_dt);
    case 128: return launch_tc<Taps, 128>(a, in_dt, out_dt);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace r2d
}  // namespace ia
