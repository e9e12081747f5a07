// Kernel A with each pass's weights synthesised in the kernel from its
// closed form (SynthTaps, ia_taps.cuh): the C entry points of
// resample2d.cuh's kernel for resize2d(fused=True), the counterpart of the
// fused_spec branch of the JAX package's _kernel_last_unrolled /
// _kernel_mid_unrolled (resize2d_pallas(fused=True)).  Each block
// synthesises the W weights of its columns and the H weights of its rows
// once, into shared memory; no weight crosses device memory.  The design
// and its bounds are in resample2d.cuh.

#include "resample2d.cuh"

extern "C" {

// As ia_resample2d, with each pass's weights synthesised from `*spec_w` and
// `*spec_h` (host pointers, read before the launch; their in_size is W and
// H).  The host plans rows_cap and cols_cap over the synthesised first
// taps, computed in float32 as the kernel computes them.
int ia_resample2d_fused(const void* x, void* out, int in_dt, int out_dt,
                        int B, int H, int W, int OH, int OW,
                        const ia::Synth* spec_w, const ia::Synth* spec_h,
                        int quant, int tile_r, int tile_c, int rows_cap,
                        int cols_cap, int chunk, int smem, void* stream) {
  if (spec_w->in_size != W || spec_h->in_size != H) {
    return (int)cudaErrorInvalidValue;
  }
  return ia::r2d::launch_2d(x, out, in_dt, out_dt, B, H, W, OH, OW,
                            ia::synth_taps(*spec_w), ia::synth_taps(*spec_h),
                            quant, tile_r, tile_c, rows_cap, cols_cap, chunk,
                            smem, stream, nullptr);
}

// As ia_resample2d_occupancy, for ia_resample2d_fused's kernel.
int ia_resample2d_fused_occupancy(int in_dt, int out_dt, int ntaps_w,
                                  int ntaps_h, int tile_r, int tile_c,
                                  int rows_cap, int cols_cap, int chunk,
                                  int smem, int* blocks) {
  ia::Synth s{};
  s.ntaps = ntaps_w;
  const ia::SynthTaps taps_w = ia::synth_taps(s);
  s.ntaps = ntaps_h;
  const ia::SynthTaps taps_h = ia::synth_taps(s);
  return ia::r2d::launch_2d(nullptr, nullptr, in_dt, out_dt, 1, 1, 1, 1, 1,
                            taps_w, taps_h, 0, tile_r, tile_c, rows_cap,
                            cols_cap, chunk, smem, nullptr, blocks);
}

}  // extern "C"
