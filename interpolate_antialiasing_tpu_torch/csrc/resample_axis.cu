// Kernel B: the C entry points of resample_axis.cuh's kernel over float32
// host tables (ia_resample_axis: a forward spec's tables, W^T's for the
// adjoint, or a shard's) and over weights synthesised in the kernel from
// the pass's closed form (ia_resample_axis_fused, resize_axis(fused=True)).
// resample_axis_{table,synth}_nt{8,16,0}.cu compile the instantiations, one
// source per weight source and tap bucket.  The design, the TPU kernels it
// replaces and its bounds are in resample_axis.cuh.

#include "resample_axis.cuh"

namespace {

using namespace ia;
using namespace ia::rax;

template <typename Taps>
int launch(const Taps& taps, const void* x, void* out, int in_dt, int out_dt,
           long long outer, int n_in, long long inner, int n_out,
           const void* win0, int tile_j, int tile_o, int tile_i, int win, int vec,
           int smem, void* stream) {
  Args<Taps> a{};
  a.taps = taps;
  const int err = make_args(a, x, out, in_dt, outer, n_in, inner, n_out, win0,
                            tile_j, tile_o, tile_i, win, vec, smem, stream);
  return err != 0 ? err : dispatch_bucket(a, in_dt, out_dt, vec);
}

}  // namespace

extern "C" {

// x[outer, n_in, inner] -> out[outer, n_out, inner] on `stream`, element
// types by dtype code (0 uint8, 1 float32, 2 bfloat16).  All pointers are
// device pointers; xmin is int32 [n_out], w float32 row-major [n_out,
// ntaps].  The plan (tile_j, tile_o, tile_i, win, vec, smem) is
// ops/cuda_resize.py::_plan_axis'; smem must equal the kernel's own layout
// of it; win0 is int32 [ceil(n_out / tile_o)] on the device, each output
// tile's first input row (cuda_resize._win0); tile_o = 0 (with smem 0, vec
// 1, win0 unused) runs the unstaged body.  Returns the cudaError_t of the
// launch (0 on success).
int ia_resample_axis(const void* x, void* out, int in_dt, int out_dt,
                     long long outer, int n_in, long long inner, int n_out,
                     const void* xmin, const void* w, int ntaps,
                     const void* win0, int tile_j, int tile_o, int tile_i,
                     int win, int vec, int smem, void* stream) {
  const TableTaps taps{(const int*)xmin, (const float*)w, ntaps, 0};
  return launch(taps, x, out, in_dt, out_dt, outer, n_in, inner, n_out, win0,
                tile_j, tile_o, tile_i, win, vec, smem, stream);
}

// The same pass with each output's weights synthesised in the kernel from
// `*spec` (a host pointer, read before the launch; spec->in_size == n_in).
// The host plans the windows over the synthesised first taps, computed in
// float32 as the kernel computes them.
int ia_resample_axis_fused(const void* x, void* out, int in_dt, int out_dt,
                           long long outer, int n_in, long long inner,
                           int n_out, const Synth* spec, const void* win0,
                           int tile_j, int tile_o, int tile_i, int win, int vec,
                           int smem, void* stream) {
  if (spec->in_size != n_in) return (int)cudaErrorInvalidValue;
  return launch(synth_taps(*spec), x, out, in_dt, out_dt, outer, n_in, inner,
                n_out, win0, tile_j, tile_o, tile_i, win, vec, smem, stream);
}

// Resident blocks per SM of the kernel (fused: the synthesising one) for
// these dtypes, tap count, vec and dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; launches
// nothing.
int ia_resample_axis_occupancy(int fused, int in_dt, int out_dt, int ntaps,
                               int vec, int smem, int* blocks) {
  if (ntaps < 1 || smem < 0 || smem + 64 > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (fused) {
    Synth s{};
    s.ntaps = ntaps;
    Args<SynthTaps> a{};
    a.taps = synth_taps(s);
    a.smem = smem;
    a.occupancy = blocks;
    return dispatch_bucket(a, in_dt, out_dt, vec);
  }
  Args<TableTaps> a{};
  a.taps = TableTaps{nullptr, nullptr, ntaps, 0};
  a.smem = smem;
  a.occupancy = blocks;
  return dispatch_bucket(a, in_dt, out_dt, vec);
}

}  // extern "C"
