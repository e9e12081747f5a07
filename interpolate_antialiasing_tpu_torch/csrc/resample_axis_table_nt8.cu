// Kernel B's instantiations over host tables for the 8-tap bucket
// (resample_axis.cuh): every dtype pair, one and four uint8 columns per
// thread.  One source per weight source and tap bucket, so nvcc builds them
// in parallel.

#define IA_RAX_INSTANTIATE
#include "resample_axis.cuh"

namespace ia {
namespace rax {

template int launch_nt<TableTaps, 8>(const Args<TableTaps>&, int, int, int);

}  // namespace rax
}  // namespace ia
