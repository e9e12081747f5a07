// crop_resample_f32: the instantiations of the windowed crop's
// float32-intermediate passes (resample_axis.cuh's launch_crop_f32_nt:
// kernel B's crop instantiation over float32 TableTaps, uint8 -> float32
// for the H pass, float32 -> uint8 for the W pass), compiled in a source of
// their own so that nvcc builds them beside crop_resample.cu, whose
// ia_crop_pass launches them.  The arithmetic, the TPU kernels the crop
// passes replace, the route they replace and their bounds are in
// crop_resample.cu.

#define IA_RAX_CROP_F32_INSTANTIATE
#include "resample_axis.cuh"

namespace ia {
namespace rax {

template int launch_crop_f32_nt<8>(const Args<TableTaps>&, int, int);
template int launch_crop_f32_nt<16>(const Args<TableTaps>&, int, int);
template int launch_crop_f32_nt<0>(const Args<TableTaps>&, int, int);

}  // namespace rax
}  // namespace ia
