// The windowed crop's per-image tables, both axes in one launch: for every
// image n and output row o of a pass, the row's first input index, its
// count of nonzero taps and its weights, compacted to the pass's static tap
// bound T (crop_cuda._compact's layout), from the boxes on the device.
//
// Replaces the band build that feeds the JAX package's crop kernels:
// interpolate_antialiasing_tpu/ops/crop_pallas.py::_windowed_band and
// ::_digitize_band, called inside crop_and_resize_windowed, where XLA fuses
// the elementwise chain into the programs that feed the two pallas_calls.
// The port's plain version (ops/crop_cuda.py::_windowed_tables_plain)
// builds dense [N, nt, k, 128] bands and their masks in eager torch and
// compacts them; this kernel computes only the compact tables.
//
// One thread per (axis, image, output row), blockIdx.y the axis (0: H from
// box columns 0 and 2, 1: W from columns 1 and 3).  The row's weights and
// their total come from crop_row.cuh (row_sum, Row::weight, stored), which
// the crop passes share for rows past the bound T, in the plain version's
// float32 steps (crop_cuda._windowed_band; the header lists them); a row
// whose total is 0 (a sub-pixel box) takes the one-hot at clamp(rint(center
// - 0.5), 0, in_size - 1) (half to even, as torch.round).  Then the
// compaction: j0, j1 the first and one-past-last nonzero value (K_j, or
// band_j for float weights), first = start + j0, cnt = j1 - j0 (0, with j0
// = 0, for a row without one), w[i] = value_{j0 + i} for i < min(cnt, T)
// and 0 up to T.  A row of a box wider than the image can count more than
// T taps: its cnt is the true count, w holds its first T weights, and the
// crop pass computes the others again from the box (resample_axis.cuh).
//
// Bounds: at the train batch (b64 u8 [64, 3, 438, 906] -> 224^2) it writes
// 64 * 224 * (2 + 5 + 2 + 10) * 4 bytes, about 1.1 MB (0.0003 ms at 3.35
// TB/s), and evaluates about 14 filter taps per row twice: 28,672 threads
// of a few hundred instructions each.  Launch latency bounds it; it needs
// neither shared memory nor tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crop_row.cuh"

namespace {

using namespace ia::crop;

constexpr int kThreads = 128;

struct Axis {
  Geom g;
  int T;
  int* first;
  int* cnt;
  void* w;  // int32 when g.pb >= 0, else float32
};

struct Params {
  int N;
  Axis ax[2];
};

__global__ void __launch_bounds__(kThreads) crop_tables_kernel(Params p) {
  const Axis& ax = p.ax[blockIdx.y];
  const int out_size = ax.g.out_size;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)p.N * out_size) return;
  const int n = (int)(idx / out_size), o = (int)(idx % out_size);

  const RowSum s = row_sum(ax.g, n, o);
  const Row& r = s.r;
  const long long row = (long long)n * out_size + o;
  int32_t* w = (int32_t*)ax.w + row * ax.T;
  const int T = ax.T, pb = ax.g.pb;
  int j0 = -1, j1 = 0;
  if (s.total > 0.0f) {
    for (int j = s.j_lo; j < s.j_hi; ++j) {
      const int32_t v = stored(__fdiv_rn(r.weight(j), s.total), pb);
      if (nonzero(v, pb)) {
        if (j0 < 0) j0 = j;
        j1 = j + 1;
      }
      if (j0 >= 0 && j - j0 < T) w[j - j0] = v;
    }
  } else {  // a sub-pixel box: the one-hot at the nearest input, if in the window
    const float jn = fminf(fmaxf(rintf(__fsub_rn(r.center, 0.5f)), 0.0f), r.in_last) -
                     (float)r.start;
    if (jn >= 0.0f && jn < (float)ax.g.k) {
      j0 = (int)jn;
      j1 = j0 + 1;
      w[0] = stored(1.0f, pb);
    }
  }
  const int cnt = j0 < 0 ? 0 : j1 - j0;
  for (int i = cnt; i < T; ++i) w[i] = 0;
  ax.first[row] = r.start + (j0 < 0 ? 0 : j0);
  ax.cnt[row] = cnt;
}

bool bad_axis(int in_size, int out_size, int k, int align, int hi_start, int T, int pb) {
  return in_size < 1 || out_size < 0 || k < 1 || align < 1 || hi_start < 0 || T < 1 ||
         pb > 30 || pb == 0 || pb < -1;
}

}  // namespace

extern "C" {

// Both passes' tables from boxes [N, 4] (float32, device) on `stream`; per
// axis (H, then W): in_size, out_size, the window k, its start alignment,
// its largest start hi_start, the tap bound T, pb (-1: float32 weights),
// then first [N, out] int32, cnt [N, out] int32, w [N, out, T] (int32 when
// pb >= 0, else float32), device pointers.  filter: 0 triangle, 2 Hamming,
// 4 box (crop_cuda._TABLE_FILTERS); support: its unwidened support.
// Returns the cudaError_t of the launch (0 on success).
int ia_crop_tables(const void* boxes, int N, int filter, float support, int antialias,
                   int in_h, int out_h, int k_h, int align_h, int hi_start_h, int T_h,
                   int pb_h, void* first_h, void* cnt_h, void* w_h, int in_w, int out_w,
                   int k_w, int align_w, int hi_start_w, int T_w, int pb_w, void* first_w,
                   void* cnt_w, void* w_w, void* stream) {
  if (N < 1 || (filter != ia::kTriangle && filter != ia::kHamming && filter != kBox) ||
      bad_axis(in_h, out_h, k_h, align_h, hi_start_h, T_h, pb_h) ||
      bad_axis(in_w, out_w, k_w, align_w, hi_start_w, T_w, pb_w))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.N = N;
  const float* b = (const float*)boxes;
  p.ax[0] = Axis{Geom{b, 0, in_h, out_h, k_h, align_h, hi_start_h, pb_h, filter, antialias,
                      support},
                 T_h, (int*)first_h, (int*)cnt_h, w_h};
  p.ax[1] = Axis{Geom{b, 1, in_w, out_w, k_w, align_w, hi_start_w, pb_w, filter, antialias,
                      support},
                 T_w, (int*)first_w, (int*)cnt_w, w_w};
  const long long rows = (long long)N * (out_h > out_w ? out_h : out_w);
  if (rows == 0) return 0;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), 2);
  crop_tables_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
