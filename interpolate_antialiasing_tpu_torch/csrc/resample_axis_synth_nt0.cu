// Kernel B's instantiations over synthesised weights for the loop bucket
// (more than 16 taps) (resample_axis.cuh): every dtype pair, one and four
// uint8 columns per thread.  One source per weight source and tap bucket, so
// nvcc builds them in parallel.

#define IA_RAX_INSTANTIATE
#include "resample_axis.cuh"

namespace ia {
namespace rax {

template int launch_nt<SynthTaps, 0>(const Args<SynthTaps>&, int, int, int);

}  // namespace rax
}  // namespace ia
