// pil_resample_axis: the C entry points of resample_axis.cuh's kernel over
// Pillow's int32 tables (PilTaps), with its instantiations: one Pillow 8bpc
// fixed-point pass over one axis, uint8 x[outer, n_in, inner] -> uint8
// out[outer, n_out, inner], the sharded byte-exact route's shard-local H
// and W passes, and the Pillow two-pass kernel's two-pass route where no
// kernel A tile fits.  The crop passes' integer variant (crop_resample.cu)
// runs the same instantiations.  The design, the TPU kernel it replaces
// (pil_exact.py::_kernel_mid_digit) and its bounds are in resample_axis.cuh.

#define IA_RAX_PIL_INSTANTIATE
#include "resample_axis.cuh"

namespace ia {
namespace rax {

template int launch_pil_nt<8>(const Args<PilTaps>&, int);
template int launch_pil_nt<16>(const Args<PilTaps>&, int);
template int launch_pil_nt<0>(const Args<PilTaps>&, int);

}  // namespace rax
}  // namespace ia

using namespace ia;
using namespace ia::rax;

extern "C" {

// uint8 x[outer, n_in, inner] -> uint8 out[outer, n_out, inner] on `stream`.
// All pointers are device pointers; xmin is int32 [n_out], wb int32
// row-major [n_out, ntaps], pb the precision bits.  The plan (tile_j,
// tile_o, tile_i, win, vec, smem) and win0 are as for ia_resample_axis
// (ops/cuda_resize.py::_plan_axis; the wrapper,
// ops/pil_exact.py::_resample_axis_cuda, calls it).  Returns the cudaError_t of the launch (0 on success).
int ia_pil_resample_axis(const void* x, void* out, long long outer, int n_in,
                         long long inner, int n_out, const void* xmin,
                         const void* wb, int ntaps, int pb, const void* win0,
                         int tile_j, int tile_o, int tile_i, int win, int vec,
                         int smem, void* stream) {
  if (pb < 1 || pb > 30) return (int)cudaErrorInvalidValue;
  Args<PilTaps> a{};
  a.taps = PilTaps{(const int*)xmin, (const int*)wb, ntaps, pb, 0};
  const int err = make_args(a, x, out, kU8, outer, n_in, inner, n_out, win0,
                            tile_j, tile_o, tile_i, win, vec, smem, stream);
  return err != 0 ? err : dispatch_bucket(a, vec);
}

// Resident blocks per SM of the kernel for this tap count, vec and dynamic
// shared memory into *blocks; launches nothing.
int ia_pil_resample_axis_occupancy(int ntaps, int vec, int smem, int* blocks) {
  if (ntaps < 1 || smem < 0 || smem + 64 > kSmemLimit) return (int)cudaErrorInvalidValue;
  Args<PilTaps> a{};
  a.taps = PilTaps{nullptr, nullptr, ntaps, 22, 0};
  a.smem = smem;
  a.occupancy = blocks;
  return dispatch_bucket(a, vec);
}

}  // extern "C"
