// Kernel A over host tables: the C entry points of resample2d.cuh's kernel
// with TableTaps (xmin int32 [out], w float32 [out, ntaps] per pass: a
// forward spec's tables, W^T's for the adjoint, or an affine spec's).  The
// design, the TPU kernels it replaces and its bounds are in resample2d.cuh.

#include "resample2d.cuh"

extern "C" {

// x[B, H, W] -> out[B, OH, OW] on `stream`, element types by dtype code
// (0 uint8, 1 float32, 2 bfloat16).  All pointers are device pointers;
// xmin/ymin are int32 [out], w_w/w_h float32 row-major [out, ntaps].  The
// plan (tile_r, tile_c in {16, 32, 64, 128}, rows_cap, cols_cap, chunk,
// smem) is ops/cuda_resize.py::_plan_rows'; smem must equal the kernel's
// own layout of it.  The host keeps B * ceil(OH/tile_r) * ceil(OW/tile_c)
// <= INT_MAX (it splits larger batches into several launches).  Returns the
// cudaError_t of the launch (0 on success).
int ia_resample2d(const void* x, void* out, int in_dt, int out_dt, int B,
                  int H, int W, int OH, int OW, const void* xmin_w,
                  const void* w_w, int ntaps_w, const void* ymin_h,
                  const void* w_h, int ntaps_h, int quant, int tile_r,
                  int tile_c, int rows_cap, int cols_cap, int chunk, int smem,
                  void* stream) {
  const ia::TableTaps taps_w{(const int*)xmin_w, (const float*)w_w, ntaps_w};
  const ia::TableTaps taps_h{(const int*)ymin_h, (const float*)w_h, ntaps_h};
  return ia::r2d::launch_2d(x, out, in_dt, out_dt, B, H, W, OH, OW, taps_w,
                            taps_h, quant, tile_r, tile_c, rows_cap, cols_cap,
                            chunk, smem, stream, nullptr);
}

// Resident blocks per SM of ia_resample2d's kernel for these dtypes, tile_c
// and dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *blocks; the plan's other arguments as for ia_resample2d (no launch).
int ia_resample2d_occupancy(int in_dt, int out_dt, int ntaps_w, int ntaps_h,
                            int tile_r, int tile_c, int rows_cap, int cols_cap,
                            int chunk, int smem, int* blocks) {
  const ia::TableTaps taps_w{nullptr, nullptr, ntaps_w};
  const ia::TableTaps taps_h{nullptr, nullptr, ntaps_h};
  return ia::r2d::launch_2d(nullptr, nullptr, in_dt, out_dt, 1, 1, 1, 1, 1,
                            taps_w, taps_h, 0, tile_r, tile_c, rows_cap,
                            cols_cap, chunk, smem, nullptr, blocks);
}

}  // extern "C"
