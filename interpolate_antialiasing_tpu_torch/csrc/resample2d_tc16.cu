// Kernel A's instantiations for 16-column tiles over host tables
// (resample2d.cuh): every dtype pair and tap bucket.  One source per column
// tile and weight source, so nvcc builds them in parallel.

#define IA_R2D_TC 16
#include "resample2d.cuh"

namespace ia {
namespace r2d {

template int launch_tc<TableTaps, IA_R2D_TC>(const Args2d<TableTaps>&, int, int);

}  // namespace r2d
}  // namespace ia
