// Float two-pass separable resample of [B, H, W] planes (W pass, then H
// pass), uint8 / float32 / bfloat16 in and out, float32 accumulation.
//
// Replaces interpolate_antialiasing_tpu/ops/pallas_resize.py::_kernel_2pass
// (wrapper resize2d_onekernel) and serves the shapes of its streamed twin
// _kernel_2pass_streamed (wrapper resize2d_streamed): a block reads only the
// input rows its output tile needs, so no image is too large for it and one
// kernel covers both TPU kernels.  The TPU kernels contract tile-compacted
// weight bands on the matrix unit in split-bf16; here each output is a
// direct windowed float32 multiply-add (ia_dtypes.cuh::mac, bit for bit the
// plain version's) over the compact tables of weights.py::compute_tables
// (xmin[out], w[out, ntaps]):
//
//   y[o] = sum_k w[o, k] * x[clamp(xmin[o] + k, 0, in - 1)]
//
// Taps past the window carry zero weight, so the clamp never adds signal
// (the replicate border of antialias=False folds its weights onto the edge
// tap on the host and relies on the same clamp).  For uint8 -> uint8 the W
// pass result is put on the uint8 lattice (floor(v + 0.5), clamped) before
// the H pass, as Pillow and the JAX package's _quant_u8grid do.  The
// intermediate stays float32 in shared memory for every dtype (the JAX
// streamed route rounds it to bfloat16 for bfloat16 input; this is more
// precise).
//
// The weights come from host tables (ia_resample2d) or are synthesised from
// each pass's closed form in the kernel (ia_resample2d_fused, the
// counterpart of the fused_spec branch of _kernel_last_unrolled /
// _kernel_mid_unrolled in resize2d_pallas(fused=True)): each block
// synthesises the W weights of its columns and the H weights of its rows,
// and no weight crosses device memory.  The kernel is templated on the
// weight source (ia_taps.cuh) and keeps one multiply-add loop per pass.
//
// Design: one block per (plane, tile_r output rows, tile_c output columns),
// all on gridDim.x (planes on .z would cap a launch at 65,535 planes).  The
// block runs the W pass for every input row its output rows read (the
// tile's row window, clamped to the image) and its tile_c columns into
// shared memory, syncs, then runs the H pass from shared memory to the
// output.  The host (cuda_resize.py::_plan2d) computes the widest window
// over all row tiles exactly as the kernel does and picks tile_r and tile_c
// so that rows_cap * tile_c floats fit in 227 KB; an extreme downscale
// (2160 -> 8 lanczos3 reads ~1,600 rows per output row) gets a narrower
// column tile.  Every global offset is 64-bit: BASELINE config 5
// ([64, 3, 2160, 3840] bfloat16) holds 1.59e9 elements.
//
// Bounds: config 5 must move 3.19 GB in and 0.80 GB out, about 1.2 ms at
// the H100's 3.35 TB/s, and does about 4.2e9 multiply-adds; each one here
// also clamps an index, computes an address and loads an element, so this
// first version may be bound by instruction issue above the memory floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "ia_dtypes.cuh"
#include "ia_taps.cuh"

namespace {

using namespace ia;

constexpr int kThreads = 256;

struct Plan2d {
  int H, W, OH, OW;
  int quant;  // uint8 -> uint8: quantise the W pass result
  int tile_r, tile_c, n_ty, n_tx, rows_cap;
};

template <typename Tin, typename Tout, typename Taps>
__global__ void __launch_bounds__(kThreads)
resample2d_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                  Taps taps_w, Taps taps_h, Plan2d p) {
  extern __shared__ float inter[];  // [rows_cap][tile_c] W-pass result
  __shared__ int s_r0, s_r1;

  const long long blk = blockIdx.x;
  const int tx = (int)(blk % p.n_tx);
  const long long rest = blk / p.n_tx;
  const int ty = (int)(rest % p.n_ty);
  const long long b = rest / p.n_ty;
  const int oy0 = ty * p.tile_r;
  const int ox0 = tx * p.tile_c;
  const int th = min(p.tile_r, p.OH - oy0);  // ragged bottom edge
  const int tw = min(p.tile_c, p.OW - ox0);  // ragged right edge
  const int tid = threadIdx.x;

  // The tile's input row window; the host computed the widest one the same
  // way to size shared memory.
  if (tid == 0) {
    int r0 = p.H, r1 = 0;
    for (int i = 0; i < th; ++i) {
      const int y = taps_h.first(oy0 + i);
      r0 = min(r0, clampi(y, 0, p.H - 1));
      r1 = max(r1, clampi(y + taps_h.ntaps - 1, 0, p.H - 1) + 1);
    }
    s_r0 = r0;
    s_r1 = r1;
  }
  __syncthreads();
  const int r0 = s_r0;
  const int rows = s_r1 - s_r0;
  if (rows > p.rows_cap) __trap();  // host and kernel disagree on the window

  const Tin* xb = x + b * (long long)p.H * p.W;

  // W pass: rows [r0, r0+rows) x columns [ox0, ox0+tw) -> shared memory.
  // Neighbouring threads take neighbouring output columns.
  for (int i = tid; i < rows * p.tile_c; i += kThreads) {
    const int c = i % p.tile_c;
    if (c >= tw) continue;
    const int rr = i / p.tile_c;
    const Tin* row = xb + (long long)(r0 + rr) * p.W;
    const auto wk = taps_w.row(ox0 + c);
    float acc = 0.0f;
    for (int k = 0; k < taps_w.ntaps; ++k) {
      acc = mac(acc, wk(k), load_f32(row + clampi(wk.first + k, 0, p.W - 1)));
    }
    inter[rr * p.tile_c + c] = p.quant ? quant_u8(acc) : acc;
  }
  __syncthreads();

  // H pass: shared memory -> output rows [oy0, oy0+th).
  Tout* ob = out + b * (long long)p.OH * p.OW;
  for (int i = tid; i < th * p.tile_c; i += kThreads) {
    const int c = i % p.tile_c;
    if (c >= tw) continue;
    const int oy = oy0 + i / p.tile_c;
    const auto wk = taps_h.row(oy);
    float acc = 0.0f;
    for (int k = 0; k < taps_h.ntaps; ++k) {
      const int r = clampi(wk.first + k, 0, p.H - 1) - r0;
      acc = mac(acc, wk(k), inter[r * p.tile_c + c]);
    }
    store_f32(ob + (long long)oy * p.OW + ox0 + c, acc);
  }
}

template <typename Taps>
struct Args2d {
  const void* x;
  void* out;
  Taps taps_w, taps_h;
  Plan2d p;
  unsigned blocks;
  int smem;
  cudaStream_t stream;
};

template <typename Taps>
struct Launch2d {
  template <typename Tin, typename Tout>
  struct Op {
    static int run(const Args2d<Taps>& a) {
      cudaError_t err = cudaFuncSetAttribute(
          resample2d_kernel<Tin, Tout, Taps>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
      if (err != cudaSuccess) return (int)err;
      resample2d_kernel<Tin, Tout, Taps><<<a.blocks, kThreads, a.smem, a.stream>>>(
          (const Tin*)a.x, (Tout*)a.out, a.taps_w, a.taps_h, a.p);
      return (int)cudaGetLastError();
    }
  };
};

template <typename Taps>
int launch_2d(const void* x, void* out, int in_dt, int out_dt, int B, int H,
              int W, int OH, int OW, const Taps& taps_w, const Taps& taps_h,
              int quant, int tile_r, int tile_c, int rows_cap, void* stream) {
  Plan2d p{H, W, OH, OW, quant, tile_r, tile_c,
           (OH + tile_r - 1) / tile_r, (OW + tile_c - 1) / tile_c, rows_cap};
  const long long blocks = (long long)B * p.n_ty * p.n_tx;
  if (B < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const Args2d<Taps> a{x, out, taps_w, taps_h, p, (unsigned)blocks,
                       rows_cap * tile_c * (int)sizeof(float), (cudaStream_t)stream};
  return ia::dispatch_dtypes<Launch2d<Taps>::template Op>(in_dt, out_dt, a);
}

}  // namespace

extern "C" {

// x[B, H, W] -> out[B, OH, OW] on `stream`, element types by dtype code
// (0 uint8, 1 float32, 2 bfloat16).  All pointers are device pointers;
// xmin/ymin are int32 [out], w_w/w_h float32 row-major [out, ntaps].  The
// host keeps B * ceil(OH/tile_r) * ceil(OW/tile_c) <= INT_MAX (it splits
// larger batches into several launches).  Returns the cudaError_t of the
// launch (0 on success).
int ia_resample2d(const void* x, void* out, int in_dt, int out_dt, int B,
                  int H, int W, int OH, int OW, const void* xmin_w,
                  const void* w_w, int ntaps_w, const void* ymin_h,
                  const void* w_h, int ntaps_h, int quant, int tile_r,
                  int tile_c, int rows_cap, void* stream) {
  const ia::TableTaps taps_w{(const int*)xmin_w, (const float*)w_w, ntaps_w};
  const ia::TableTaps taps_h{(const int*)ymin_h, (const float*)w_h, ntaps_h};
  return launch_2d(x, out, in_dt, out_dt, B, H, W, OH, OW, taps_w, taps_h,
                   quant, tile_r, tile_c, rows_cap, stream);
}

// The same with each pass's weights synthesised in the kernel from
// `*spec_w` and `*spec_h` (host pointers, read before the launch; their
// in_size is W and H).  The host plans rows_cap over the H windows of the
// synthesised first taps, computed in float32 as the kernel computes them.
int ia_resample2d_fused(const void* x, void* out, int in_dt, int out_dt,
                        int B, int H, int W, int OH, int OW,
                        const ia::Synth* spec_w, const ia::Synth* spec_h,
                        int quant, int tile_r, int tile_c, int rows_cap,
                        void* stream) {
  if (spec_w->in_size != W || spec_h->in_size != H) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_2d(x, out, in_dt, out_dt, B, H, W, OH, OW,
                   ia::synth_taps(*spec_w), ia::synth_taps(*spec_h), quant,
                   tile_r, tile_c, rows_cap, stream);
}

}  // extern "C"
