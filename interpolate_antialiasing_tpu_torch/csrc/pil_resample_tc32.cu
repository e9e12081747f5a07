// Kernel A's instantiations for 32-column tiles over Pillow's int32 tables
// (resample2d.cuh with PilTaps): uint8 -> uint8, every tap bucket.  One
// source per column tile, so nvcc builds them in parallel.

#define IA_R2D_TC 32
#include "resample2d.cuh"

namespace ia {
namespace r2d {

template int launch_tc<PilTaps, IA_R2D_TC>(const Args2d<PilTaps>&, int, int);

}  // namespace r2d
}  // namespace ia
