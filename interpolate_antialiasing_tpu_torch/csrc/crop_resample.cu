// One pass of the windowed crop-and-resize with per-image boxes: uint8
// x viewed as [N, R, n_in, inner] -> uint8 out [N, R, n_out, inner], each
// output row o of image n reading its own taps:
//
//   out[n, r, o, i] = q( sum_{j < T} w[n, o, j] * x[n, r, min(first[n, o] + j, n_in - 1), i] )
//
// Replaces interpolate_antialiasing_tpu/ops/crop_pallas.py::_kernel_crop_mid_dig
// and ::_kernel_crop_last_dig (integer weights), and serves ::_kernel_crop_mid
// and ::_kernel_crop_last (float weights, precision="split").  The host
// (ops/crop_cuda.py) launches it twice: the H pass (R = C, inner = W, the
// image's rows) into a uint8 intermediate, then the W pass (R = C * OH rows,
// inner = 1) into the output.
//
// The TPU kernels contract a [K, 128] band per (image, 128-row tile) on the
// matrix unit: K window pixels for every output, most of them at zero
// weight, with int8 digit planes and pixels re-centred by -128 for its int8
// unit.  Here each output runs a direct multiply-add over T taps from the
// first nonzero one (the host compacts each band column to first / w,
// T >= the nonzero count of every row of a box no wider than the image:
// crop_cuda._tap_bound), so the work is T, not K, per output; the digit
// split and the -128 bias cancel exactly, so the int32 sum gives the TPU
// kernels' bytes:
//
//   integer (pb >= 0): int32 weights, S = sum w * x exact in int32 (the
//     host bounds 255 * row sum + 2^(pb-1) below 2^31 before the launch),
//     q(S) = (S + 2^(pb-1)) >> pb: PilTaps' sum from the bias;
//   float (pb < 0): float32 weights, each product and sum rounded in tap
//     order (ia_dtypes.cuh::mac, bit for bit the plain version's),
//     q(v) = floor(v + 0.5): TableTaps' chain stored as uint8.
//
// Both clamp to [0, 255], a no-op where admission's clip-free bound holds.
// Taps past a row's count weigh 0: the int32 sum is exact, and the float
// chain adds +0 to a non-negative sum (admission keeps only non-negative
// filters), so summing T taps equals the plain version's.
//
// A box wider than the image (a zoom-out) can give a row more than T taps.
// The tables keep its true count cnt and its first T weights; the pass
// computes all cnt weights of such a row again from its box and output
// index (crop_row.cuh, the table kernel's own code, so the same bits) once
// per block into shared memory, and stages the tile in chunks of its
// outputs whose window and weights fit the plan's (resample_axis.cuh's
// crop_tile_chunked): one row_sum per wide row and cnt divisions per row
// and block, not per output element.  Rows within the bound run as before.
// The kernel B unstaged body, which only small passes run, still computes
// a wide row's weights per element (wide_dot).
//
// Design: each pass is kernel B (resample_axis.cuh) with one table per
// image (TableTaps / PilTaps image(n)), in its own instantiation (C = true)
// compiled here: a block stages its window of input rows and its outputs'
// weights in shared memory and computes from there; its planes lie in one
// image (tiles along N * R are cut at each image's R planes).  A tile's
// window starts at its outputs' least first tap, which depends on the
// boxes: the block stages its first taps and weights, one warp reduces
// them, then it stages the window, sized on the host from the static
// geometry (crop_cuda._crop_windows: the tile's outputs' centres at the
// bound's scale, both supports and T).  A box wider than max_box_frac
// renormalises over its truncated window and may need more rows: such a
// tile is staged in chunks too.  Small passes run kernel B's unstaged
// body, as the plan decides for kernel B.  T >= 2 (the host's bound is at
// least 3): a chunk's weights take T - 1 slots per output, the tile's
// totals the last one.
//
// The float32-intermediate variant (pb < 0, in_dt or out_dt float32) is
// the dense route's arithmetic (float32 weights, float32 products and
// sums, a float32 intermediate, one rounding) over each output row's
// nonzero taps only:
//
//   H pass: inter[n, c, o, w] = sum_{j < T} w_h[n, o, j] * x[n, c, first_h[n, o] + j, w]
//   W pass: y[n, c, o, u]     = q( sum_{j < T} w_w[n, u, j] * inter[n, c, o, first_w[n, u] + j] )
//
// each product and sum rounded to float32 in tap order (ia_dtypes.cuh::mac,
// bit for bit the plain version's), the intermediate stored unrounded, and
// q(v) = floor(v + 0.5) clamped to [0, 255] once, at the end
// (ops/resize.py::_finalize_dtype's rule).  Its tables are crop_tables.cu's
// float32 tables over one window of the whole axis, so no row is
// renormalised over a truncated window; a horizontal flip is folded into
// the W tables (output o of a mirrored image holds row out_size - 1 - o's
// taps), and rows past T of a mirrored image take the mirrored row's
// weights (crop_row.cuh's source_row, compiled only into the float32 ->
// uint8 instantiation).  It replaces, on a uint8 call with flips on the
// card, the dense route's per-image matrices (ops/crop.py::_axis_matrix,
// ~100 aten kernels) and its two float32 matrix products, which multiply
// every weight of a dense [OH, H] and [OW, W] row, nearly all of them
// zero.  The JAX package has no such kernel: its flipped calls take the
// dense route everywhere.  Its instantiations (uint8 -> float32 for the H
// pass, float32 -> uint8 for the W pass, over TableTaps) are compiled in
// crop_resample_f32.cu.
//
// Bounds: at the train shape (u8 [64, 3, 438, 906] -> 224x224) the two
// passes read the image (76 MB) and write the output (9.6 MB) once, 0.0258
// ms at 3.35 TB/s; the 39 MB uint8 intermediate written and read again
// makes the two launches' floor about 0.049 ms, the 156 MB float32 one
// about 0.12 ms.  A few operations per byte:
// device memory bounds it, so the design cuts bytes and instructions per
// output (16-byte staged copies, weights read once per block).

#include "resample_axis.cuh"

using namespace ia;
using namespace ia::rax;

namespace {

// The crop instantiation (resample_axis.cuh: C = true) of the pass's tap
// bucket.
template <typename Taps>
int dispatch_crop(const Args<Taps>& a, int vec) {
  switch (tap_bucket(a.taps.ntaps)) {
    case 8: return launch_crop_nt<Taps, 8>(a, vec);
    case 16: return launch_crop_nt<Taps, 16>(a, vec);
  }
  return launch_crop_nt<Taps, 0>(a, vec);
}

}  // namespace

extern "C" {

// x[N, R, n_in, inner] -> out[N, R, n_out, inner] (device pointers) on
// `stream`, elements of in_dt and out_dt (ia_dtypes.cuh: uint8 -> uint8,
// or the float32-intermediate variant's uint8 -> float32 and float32 ->
// uint8); first int32 [N, n_out], w [N, n_out, T]: int32 when pb >= 0,
// float32 when pb < 0 (the float32-intermediate variant's only form); cnt
// int32 [N, n_out], each row's true tap count (more than T for a box wider
// than the image), and what its weights need: the boxes [N, 4] (float32),
// the axis (0: H, 1: W), the filter code, support and antialias, and the
// axis's window k, alignment and largest start (crop_tables.cu's
// arguments); flip: [N] bool (device), the images a float32 -> uint8 pass
// mirrors, or null.  The plan (tile_j, tile_o, tile_i, win, vec, smem) is
// crop_cuda._crop_plan's (cuda_resize._plan_axis' tiles with the crop's
// windows); each block finds its tile's first input row from the first
// taps; tile_o = 0 (smem 0, vec 1) runs the unstaged body.  Returns the
// cudaError_t of the launch (0 on success).
int ia_crop_pass(const void* x, void* out, int in_dt, int out_dt, int N, long long R,
                 int n_in, long long inner, int n_out, const void* first, const void* w,
                 int T, int pb, const void* cnt, const void* boxes, int axis, int filter,
                 float support, int antialias, int k, int align, int hi_start,
                 const void* flip, int tile_j, int tile_o, int tile_i, int win, int vec,
                 int smem, void* stream) {
  const bool u8 = in_dt == kU8 && out_dt == kU8;
  const bool f32 = pb < 0 && ((in_dt == kU8 && out_dt == kF32) || (in_dt == kF32 && out_dt == kU8));
  if (N < 1 || R < 1 || T < 2 || pb > 30 || pb == 0 || !(u8 || f32) || cnt == nullptr ||
      boxes == nullptr || (axis != 0 && axis != 1) || k < 1 || align < 1 || hi_start < 0 ||
      (flip != nullptr && in_dt != kF32) ||
      (vec == 4 && (in_dt != kU8 || (f32 && ((uintptr_t)out & 15) != 0))))
    return (int)cudaErrorInvalidValue;
  const long long outer = (long long)N * R;
  const crop::Pass cp{crop::Geom{(const float*)boxes, axis, n_in, n_out, k, align, hi_start,
                                 pb > 0 ? pb : -1, filter, antialias, support},
                      (const int*)cnt, (const uint8_t*)flip};
  if (pb > 0) {
    Args<PilTaps> a{};
    a.taps = PilTaps{(const int*)first, (const int*)w, T, pb, n_out};
    a.crop = cp;
    const int err = make_args(a, x, out, kU8, outer, n_in, inner, n_out, nullptr, tile_j,
                              tile_o, tile_i, win, vec, smem, stream, R, true);
    return err != 0 ? err : dispatch_crop(a, vec);
  }
  Args<TableTaps> a{};
  a.taps = TableTaps{(const int*)first, (const float*)w, T, n_out};
  a.crop = cp;
  const int err = make_args(a, x, out, in_dt, outer, n_in, inner, n_out, nullptr, tile_j,
                            tile_o, tile_i, win, vec, smem, stream, R, true);
  if (err != 0) return err;
  if (u8) return dispatch_crop(a, vec);
  switch (tap_bucket(T)) {
    case 8: return launch_crop_f32_nt<8>(a, in_dt, vec);
    case 16: return launch_crop_f32_nt<16>(a, in_dt, vec);
  }
  return launch_crop_f32_nt<0>(a, in_dt, vec);
}

}  // extern "C"
