// Pillow's 8bpc two-pass resample (ImagingResample: horizontal pass, uint8
// intermediate, vertical pass), byte-identical to PIL.Image.resize: the C
// entry points of kernel A (resample2d.cuh) over Pillow's int32 tables
// (PilTaps, ia_taps.cuh); pil_resample_tc{16,32,64,128}.cu compile its
// instantiations, one source per column tile.
//
// Replaces interpolate_antialiasing_tpu/ops/pil_exact.py::_kernel_2pass_pil
// (and serves the shapes of its streamed twin _kernel_2pass_pil_streamed:
// a block stages only the input rows its output tile needs, so no image is
// too large for it).  The TPU kernel splits each int32 coefficient into int8
// digits because its matrix unit wants static int8 matmuls; here each pass is
// a direct windowed int32 multiply-accumulate over Pillow's compact tables
// (xmin[out], Wb[out, ntaps]), which gives the same bytes:
//
//   acc = (1 << (pb-1)) + sum_k Wb[o,k] * x[clamp(xmin[o]+k, 0, in-1)]
//   out = clip(acc >> pb, 0, 255)          (arithmetic shift, then clip8)
//
// The host wrapper checks 255 * max_row sum|Wb| + 2^(pb-1) < 2^31 for both
// axes, so the int32 accumulator cannot overflow (Pillow's `ss` is int32 too).
//
// Design: kernel A's (resample2d.cuh): one block per (plane, tile_r output
// rows, TC output columns), the tile from the host plan
// (ops/cuda_resize.py::_plan_rows with one-byte elements and a one-byte
// intermediate); the block stages its weights and first taps in shared
// memory, its input row window by 16-byte cp.async copies, runs the W pass
// into a uint8 intermediate [rows][TC] in shared memory (Pillow's clip8
// byte: a quarter of the float kernels' buffer; an int32 one measured 8%
// slower) and the H pass from there, four columns per thread (one 32-bit
// load per tap), with a body compiled for each exact tap count.  Where no
// tile fits a block's shared memory (heavy lanczos downscales), the host
// runs two pil_resample_axis passes instead (the same int32 sums,
// byte-equal).
//
// Bounds: at the bench shape (uint8 [64,3,438,906] -> [64,3,196,320],
// bilinear) the kernel must move about 88 MB (76 MB in, 12 MB out) and do
// about 0.27 G int32 multiply-adds, 3 per byte moved: device memory sets the
// floor (0.0263 ms at 3.35 TB/s).  On the H100 the W pass's instructions
// per output (a byte load and a multiply-add per tap, its addressing and
// store) and the staging of the blocks' row windows (about 118 MB with
// their halos and 16-byte ends) each take about half of the kernel's time
// (PERF.md); summing four taps per dp4a over the weights' byte digits
// measured slower.

#include "resample2d.cuh"

extern "C" {

// uint8 x[B, H, W] -> uint8 out[B, OH, OW] on `stream`.  All pointers are
// device pointers; tables are int32, Wb row-major [out, ntaps].  The plan
// (tile_r, tile_c in {16, 32, 64, 128}, rows_cap, cols_cap, chunk, smem) is
// ops/cuda_resize.py::_plan_rows' for one-byte elements and intermediate;
// smem must equal the kernel's own layout of it.  Returns the cudaError_t
// of the launch (0 on success).
int ia_pil_resample_2pass(const void* x, void* out, int B, int H, int W,
                          int OH, int OW, const void* xmin_w, const void* wb_w,
                          int ntaps_w, const void* ymin_h, const void* wb_h,
                          int ntaps_h, int pb, int tile_r, int tile_c,
                          int rows_cap, int cols_cap, int chunk, int smem,
                          void* stream) {
  if (pb < 1 || pb > 30) return (int)cudaErrorInvalidValue;
  const ia::PilTaps taps_w{(const int*)xmin_w, (const int*)wb_w, ntaps_w, pb, 0};
  const ia::PilTaps taps_h{(const int*)ymin_h, (const int*)wb_h, ntaps_h, pb, 0};
  return ia::r2d::launch_2d(x, out, ia::kU8, ia::kU8, B, H, W, OH, OW, taps_w,
                            taps_h, 0, tile_r, tile_c, rows_cap, cols_cap, chunk,
                            smem, stream, nullptr);
}

// Resident blocks per SM of ia_pil_resample_2pass' kernel for this plan
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; launches
// nothing.
int ia_pil_resample_2pass_occupancy(int ntaps_w, int ntaps_h, int tile_r,
                                    int tile_c, int rows_cap, int cols_cap,
                                    int chunk, int smem, int* blocks) {
  const ia::PilTaps taps_w{nullptr, nullptr, ntaps_w, 22, 0};
  const ia::PilTaps taps_h{nullptr, nullptr, ntaps_h, 22, 0};
  return ia::r2d::launch_2d(nullptr, nullptr, ia::kU8, ia::kU8, 1, 1, 1, 1, 1,
                            taps_w, taps_h, 0, tile_r, tile_c, rows_cap,
                            cols_cap, chunk, smem, nullptr, blocks);
}

}  // extern "C"
