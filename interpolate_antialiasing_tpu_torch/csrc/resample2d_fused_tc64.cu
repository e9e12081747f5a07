// Kernel A's instantiations for 64-column tiles over synthesised weights
// (resample2d.cuh): every dtype pair and tap bucket.  One source per column
// tile and weight source, so nvcc builds them in parallel.

#define IA_R2D_TC 64
#include "resample2d.cuh"

namespace ia {
namespace r2d {

template int launch_tc<SynthTaps, IA_R2D_TC>(const Args2d<SynthTaps>&, int, int);

}  // namespace r2d
}  // namespace ia
