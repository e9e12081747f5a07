// Pillow's 8bpc two-pass resample (ImagingResample: horizontal pass, uint8
// intermediate, vertical pass), byte-identical to PIL.Image.resize.
//
// Replaces interpolate_antialiasing_tpu/ops/pil_exact.py::_kernel_2pass_pil
// (and serves the shapes of its streamed twin _kernel_2pass_pil_streamed:
// this kernel has no whole-image fast-memory ceiling, so one kernel covers
// every image size).  The TPU kernel splits each int32 coefficient into int8
// digits because its matrix unit wants static int8 matmuls; here each pass is
// a direct windowed int32 multiply-accumulate over Pillow's compact tables
// (xmin[out], Wb[out, ntaps]), which gives the same bytes:
//
//   acc = (1 << (pb-1)) + sum_k Wb[o,k] * x[clamp(xmin[o]+k, 0, in-1)]
//   out = clip(acc >> pb, 0, 255)          (arithmetic shift, then clip8)
//
// The host wrapper checks 255 * max_row sum|Wb| + 2^(pb-1) < 2^31 for both
// axes, so the int32 accumulator cannot overflow (Pillow's `ss` is int32 too).
//
// Design: one block per (plane b, TH output rows, kTileW output columns).
// The block runs the W pass for every input row its TH output rows read
// (rows [min ymin, max ymin+ntaps) of the tile, clamped to the image) and its
// kTileW columns into a uint8 buffer in shared memory, syncs, then runs the H
// pass from shared memory to the uint8 output.  Halo rows shared by two row
// tiles are computed twice; that is deterministic integer math, so the bytes
// do not change.  The host sizes dynamic shared memory from the widest row
// window over all tiles and picks a smaller TH when it would not fit.
//
// Bounds: at the bench shape (uint8 [64,3,438,906] -> [64,3,196,320],
// bilinear) the kernel must move about 88 MB (76 MB in, 12 MB out) and do
// about 0.27 G int32 MACs, 3 per byte moved; device-memory bytes set the
// floor.  This first version spends several instructions per MAC (clamp,
// address, byte load) and reads weights through the cache on every MAC, so it
// may issue-bound above that floor; staging input rows and weights in shared
// memory is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;     // output columns per block
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ uint8_t clip8(int acc, int pb) {
  // signed shift: bicubic/lanczos accumulators can be negative
  return (uint8_t)clampi(acc >> pb, 0, 255);
}

__global__ void __launch_bounds__(kThreads)
pil_resample_2pass_kernel(const uint8_t* __restrict__ x,
                          uint8_t* __restrict__ out,
                          int H, int W, int OH, int OW,
                          const int* __restrict__ xmin_w,
                          const int* __restrict__ wb_w, int ntaps_w,
                          const int* __restrict__ ymin_h,
                          const int* __restrict__ wb_h, int ntaps_h,
                          int pb, int tile_h, int rows_cap) {
  extern __shared__ uint8_t inter[];  // [rows_cap][kTileW] W-pass result
  __shared__ int s_r0, s_r1;

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * kTileW;
  const int th = min(tile_h, OH - oy0);  // ragged bottom edge
  const int tw = min(kTileW, OW - ox0);  // ragged right edge
  const int tid = threadIdx.x;

  // The tile's input row window; the host computed the widest one the same
  // way to size shared memory.
  if (tid == 0) {
    int r0 = H, r1 = 0;
    for (int i = 0; i < th; ++i) {
      const int y = ymin_h[oy0 + i];
      r0 = min(r0, clampi(y, 0, H - 1));
      r1 = max(r1, clampi(y + ntaps_h - 1, 0, H - 1) + 1);
    }
    s_r0 = r0;
    s_r1 = r1;
  }
  __syncthreads();
  const int r0 = s_r0;
  const int rows = s_r1 - s_r0;
  if (rows > rows_cap) __trap();  // host and kernel disagree on the window

  const int bias = 1 << (pb - 1);
  const uint8_t* xb = x + (size_t)b * H * W;

  // W pass: rows [r0, r0+rows) x columns [ox0, ox0+tw) -> shared memory.
  // Neighbouring threads take neighbouring output columns, so a warp's loads
  // for one tap fall on a short run of neighbouring input bytes.
  for (int i = tid; i < rows * kTileW; i += kThreads) {
    const int c = i % kTileW;
    if (c >= tw) continue;
    const int rr = i / kTileW;
    const int ox = ox0 + c;
    const uint8_t* row = xb + (size_t)(r0 + rr) * W;
    const int xm = xmin_w[ox];
    const int* wk = wb_w + (size_t)ox * ntaps_w;
    int acc = bias;
    for (int k = 0; k < ntaps_w; ++k) {
      acc += wk[k] * (int)row[clampi(xm + k, 0, W - 1)];
    }
    inter[rr * kTileW + c] = clip8(acc, pb);
  }
  __syncthreads();

  // H pass: shared memory -> output rows [oy0, oy0+th).
  uint8_t* ob = out + (size_t)b * OH * OW;
  for (int i = tid; i < th * kTileW; i += kThreads) {
    const int c = i % kTileW;
    if (c >= tw) continue;
    const int oy = oy0 + i / kTileW;
    const int ym = ymin_h[oy];
    const int* wk = wb_h + (size_t)oy * ntaps_h;
    int acc = bias;
    for (int k = 0; k < ntaps_h; ++k) {
      const int r = clampi(ym + k, 0, H - 1) - r0;
      acc += wk[k] * (int)inter[r * kTileW + c];
    }
    ob[(size_t)oy * OW + ox0 + c] = clip8(acc, pb);
  }
}

}  // namespace

extern "C" {

int ia_pil_resample_tile_w() { return kTileW; }

// uint8 x[B, H, W] -> uint8 out[B, OH, OW] on `stream`.  All pointers are
// device pointers; tables are int32, Wb row-major [out, ntaps].  Returns the
// cudaError_t of the launch (0 on success).
int ia_pil_resample_2pass(const void* x, void* out, int B, int H, int W,
                          int OH, int OW, const void* xmin_w, const void* wb_w,
                          int ntaps_w, const void* ymin_h, const void* wb_h,
                          int ntaps_h, int pb, int tile_h, int rows_cap,
                          void* stream) {
  const int smem = rows_cap * kTileW;
  cudaError_t err = cudaFuncSetAttribute(
      pil_resample_2pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((OW + kTileW - 1) / kTileW, (OH + tile_h - 1) / tile_h, B);
  pil_resample_2pass_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, H, W, OH, OW, (const int*)xmin_w,
      (const int*)wb_w, ntaps_w, (const int*)ymin_h, (const int*)wb_h, ntaps_h,
      pb, tile_h, rows_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
