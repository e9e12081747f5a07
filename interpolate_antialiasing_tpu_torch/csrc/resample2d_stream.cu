// Kernel A's float route on long launches: the two-pass separable resample
// of [B, H, W] planes over host tables (TableTaps, float32 sums), W pass then
// H pass, as warps walking down column strips.  The host plan
// (ops/cuda_resize.py::_plan_stream) takes it where strips are tall and
// there are many of them (4K frames by the batch) and the strip's
// constraints hold; every other shape keeps the tile kernel
// (resample2d.cuh).
//
// Serves interpolate_antialiasing_tpu/ops/pallas_resize.py:1475
// _kernel_2pass_streamed (resize2d_streamed) at the sizes it exists for: the
// TPU kernel streams a plane's rows through VMEM with async copies while it
// contracts each row band on the matrix unit.  Here each output is the same
// float32 multiply-add chain as the tile kernel's and the plain version's
// (ia_dtypes.cuh::mac in tap order from 0, a float32 intermediate, the
// stores of ia_dtypes.cuh), so the card's bits equal _resample2d_plain's.
//
// Bounds.  BASELINE config 5 (bf16 [64, 3, 2160, 3840] -> 1080x1920) must
// read 3.19 GB and write 0.80 GB: 1.1885 ms at the H100's 3.35 TB/s.  The
// tile kernel ran it in 2.68 ms; compiled without its math it took 1.24 ms
// and without its copies 2.33 ms (tools/time_kernel_a_stream.py, PERF.md
// section 5): its shared-memory traffic, stalls and instructions, not its
// copies, set the pace.  Each of its outputs costs ~24 shared-memory
// wavefronts per warp of 32 (every tap one load, the float32 intermediate
// written and read back, the H weights loaded per output), two block
// barriers per tile, and 5 taps where 4 carry weight.  This design keeps
// the copies in flight behind the math and takes the intermediate and the
// barriers away:
//
//   1. A warp owns one plane x (32 V) output columns x a segment of the
//      plane's output rows (the plan picks the segment so that the grid's
//      last wave is small), and walks down it on its own: its input rows
//      arrive through a ring of `stages` stages of NT rows in its own slice
//      of shared memory (16-byte cp.async copies, each row's head and tail
//      aligned as resample2d.cuh's stage_rows copies them), waited for with
//      the warp's own cp.async groups and __syncwarp, never a block barrier;
//      the W pass of one stage runs while the next stages - 1 are in flight.
//   2. Each input row is copied and W-resampled once.  A lane owns V
//      columns (lane + 32 v: a warp's taps of one column are 32 consecutive
//      elements, no bank conflict) and keeps each column's first tap and
//      weights in registers for the whole strip, and the last NT W-pass
//      results of each column in registers too (slot = row mod NT, so no
//      value moves), so the H pass reads no shared memory: when a row
//      completes an output row's window, the lane sums that window in tap
//      order with the output row's weights (loaded once per row, a
//      broadcast).
//   3. The tables are the host's in-axis form (ops/cuda_resize.py::
//      _stream_tables): both passes take NT taps per output, the bucket (4
//      or 8) that holds their effective taps (one past the last weight
//      column with a nonzero entry; 4 of 5 at 2x bilinear), and every
//      window lies inside the axis, zero weights filling the taps it
//      gained.  For a finite input mac(acc, 0, x) returns acc exactly (acc
//      is never -0: it starts at +0), so dropping or adding zero-weight taps
//      leaves the plain version's result bit for bit, and no tap is clamped:
//      every load and register of the walk is at a constant offset.
//
// Measured at config 5 (PERF.md section 6, row 5): 1.55-1.57 ms, 76-77% of
// the byte bound; the same kernel without its math 1.47-1.52 ms, without
// its copies 0.96-0.97 ms: its copies and stores set the pace.  Instantiations: every dtype pair of the tables route and both
// buckets, NT = 4 with V = 4 columns per lane and NT = 8 with V = 2, so
// that each keeps its state in registers.

#include "resample2d.cuh"

namespace ia {
namespace r2d {
namespace stream {

constexpr int kWarps = 4;      // warps per block, each on its own strip (_STREAM_WARPS)
constexpr int kBlock = 32 * kWarps;
constexpr int kMinBlocks = 5;  // resident blocks the register bound keeps (_STREAM_RESIDENT)

// output columns of a strip: 32 lanes of 4 columns in the 4-tap bucket, of
// 2 in the 8-tap one (ops/cuda_resize.py::_stream_tc)
__host__ __forceinline__ int strip_cols(int ntaps) { return 32 * (ntaps == 4 ? 4 : 2); }

struct PlanS {
  int H, W, OH, OW;
  int seg, n_seg, n_tx;  // output rows per segment; segments; column strips
  int stages, cols_cap;  // ring stages; widest input column span of a strip
  long long tasks;       // planes x segments x strips: one warp each
};

// Bytes of one staged row (a row's copy: up to 15 bytes of head, cols_cap
// elements, up to 15 of tail, as layout()'s) and of one warp's ring of
// `stages` stages of `ntaps` rows; a block holds kWarps rings.
// ops/cuda_resize.py::_stream_smem_bytes computes the same.
__host__ __device__ __forceinline__ int row_stride(int cols_cap, int itemsize) {
  return align16(cols_cap * itemsize) + 32;
}
__host__ __device__ __forceinline__ int warp_ring_bytes(int stages, int ntaps, int cols_cap,
                                                        int itemsize) {
  return stages * ntaps * row_stride(cols_cap, itemsize);
}

// n rows of `span_bytes` bytes from `src` (the first row's first byte; rows
// `row_bytes` apart) into `dst` (row stride `stride` bytes), 16 bytes per
// copy, each row's head and tail aligned to 16, by the warp's lanes.
__device__ __forceinline__ void warp_stage(const char* src, unsigned row_bytes, int n,
                                           int span_bytes, unsigned char* dst, int stride,
                                           int lane) {
  for (int rr = 0; rr < n; ++rr, src += row_bytes, dst += stride) {
    const char* a = (const char*)((uintptr_t)src & ~(uintptr_t)15);
    const int pieces = ((int)(src - a) + span_bytes + 15) >> 4;
    for (int q = lane; q < pieces; q += 32) cp_async16(dst + q * 16, a + q * 16);
  }
}

template <typename Tin, typename Tout, int NT>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
resample2d_stream_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                         TableTaps taps_w, TableTaps taps_h, PlanS p) {
  using P = Acc<TableTaps>;
  constexpr int kV = NT <= 4 ? 4 : 2;  // columns per lane (strip_cols)
  constexpr int kTC = 32 * kV;
  constexpr int kCH = NT;  // rows per stage: a window's slots cycle with the stages
  // uint8 -> uint8 puts the W pass result on the uint8 lattice (mid())
  constexpr bool kQuant = std::is_same_v<Tin, uint8_t> && std::is_same_v<Tout, uint8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarps + warp;
  if (task >= p.tasks) return;  // the last block's idle warps (no block barrier)
  const int tx = (int)(task % p.n_tx);
  const long long rest = task / p.n_tx;
  const int sg = (int)(rest % p.n_seg);
  const long long b = rest / p.n_seg;
  const int ox0 = tx * kTC, oy0 = sg * p.seg;
  const int tw = min(kTC, p.OW - ox0);    // ragged last strip
  const int th = min(p.seg, p.OH - oy0);  // ragged last segment
  const int NS = p.stages;

  // The strip's input rows [r0, r1) and columns [c_lo, c_lo + span): the
  // windows lie inside the image and their first taps are nondecreasing
  // (the plan checks), so they run from the first output's first tap to
  // the last output's last.
  const int r0 = taps_h.xmin[oy0];
  const int r1 = taps_h.xmin[oy0 + th - 1] + NT;
  const int c_lo = taps_w.xmin[ox0];
  const int span = taps_w.xmin[ox0 + tw - 1] + NT - c_lo;
  if (span > p.cols_cap || r0 < 0 || r1 > p.H || c_lo < 0 || c_lo + span > p.W) {
    __trap();  // host and kernel disagree
  }
  const int rows = r1 - r0;
  const int nchunks = (rows + kCH - 1) / kCH;

  const int S = row_stride(p.cols_cap, (int)sizeof(Tin));
  unsigned char* ring = smem + warp * warp_ring_bytes(NS, NT, p.cols_cap, (int)sizeof(Tin));
  const char* plane = (const char*)(x + b * p.H * p.W);
  const unsigned row_bytes = (unsigned)p.W * sizeof(Tin);
  // a staged row's head is its first byte's address mod 16 (32-bit
  // arithmetic wraps by a multiple of 16)
  const unsigned head0 = (unsigned)(uintptr_t)plane + (unsigned)r0 * row_bytes +
                         (unsigned)c_lo * sizeof(Tin);
  // the chunks' copies: chunk c is input rows r0 + kCH c ..., into stage c mod NS
  const char* src = elem<Tin>(plane, p.W, r0, c_lo);
  const int span_bytes = span * (int)sizeof(Tin);
  const unsigned chunk_bytes = kCH * row_bytes;
  const int stage_bytes = kCH * S;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nchunks) {
      warp_stage(src, row_bytes, min(kCH, rows - s * kCH), span_bytes, ring + s * stage_bytes,
                 S, lane);
    }
    src += chunk_bytes;
    cp_async_commit();
  }
  int pre_stage = NS - 1, cur_stage = 0;  // stages of chunks ch + NS - 1 and ch

  // this lane's columns: first tap (relative to c_lo) and weights, kept for
  // the whole strip (columns past the strip: the last one's tap, weight 0)
  int off[kV];
  float ww[kV][NT];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int c = lane + 32 * v;
    off[v] = taps_w.xmin[ox0 + min(c, tw - 1)] - c_lo;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      ww[v][k] = c < tw ? taps_w.w[(long long)(ox0 + c) * NT + k] : 0.0f;
    }
  }
  const float init = P::init(taps_w);
  Tout* ob = out + (b * p.OH + oy0) * p.OW + ox0 + lane;

  // win[v][i]: the W-pass result of column v's latest row r with r - r0 = i
  // mod NT (a chunk's row rr fills slot rr), so an output row whose last tap
  // row is r reads its tap k from slot (r - r0 + 1 + k) mod NT
  float win[kV][NT];
  // the next output row: its last tap row and its weights
  int o = 0;
  int last_o = taps_h.xmin[oy0] + NT - 1;
  float wh[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) wh[k] = taps_h.w[(long long)oy0 * NT + k];

  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + NS - 1 < nchunks) {  // into the stage the walk left at ch - 1
      warp_stage(src, row_bytes, min(kCH, rows - (ch + NS - 1) * kCH), span_bytes,
                 ring + pre_stage * stage_bytes, S, lane);
    }
    src += chunk_bytes;
    pre_stage = pre_stage + 1 == NS ? 0 : pre_stage + 1;
    cp_async_commit();
    cp_async_wait_n(NS - 1);  // this lane's copies of chunk ch have landed
    __syncwarp();             // and every lane's
    const unsigned char* st = ring + cur_stage * stage_bytes;
    cur_stage = cur_stage + 1 == NS ? 0 : cur_stage + 1;
    const int nr = min(kCH, rows - ch * kCH);
#pragma unroll
    for (int rr = 0; rr < kCH; ++rr) {
      if (rr < nr) {
        const int r = r0 + ch * kCH + rr;
        const unsigned h = head0 + (unsigned)(ch * kCH + rr) * row_bytes;
        const Tin* srow = (const Tin*)(st + rr * S + (h & 15));
        // W pass of row r, every column of the lane: all loads first
        float xv[kV][NT];
#pragma unroll
        for (int v = 0; v < kV; ++v) {
#pragma unroll
          for (int k = 0; k < NT; ++k) xv[v][k] = P::take(srow + off[v] + k);
        }
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          float a = init;
#pragma unroll
          for (int k = 0; k < NT; ++k) a = P::add(a, ww[v][k], xv[v][k]);
          win[v][rr] = P::mid(a, taps_w, kQuant);
        }
        // H pass of every output row whose last tap row is r
        while (o < th && last_o == r) {
          float acc[kV];
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[v] = init;
#pragma unroll
          for (int k = 0; k < NT; ++k) {
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              acc[v] = P::add(acc[v], wh[k], win[v][(rr + 1 + k) % NT]);
            }
          }
          Tout* orow = ob + (long long)o * p.OW;
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            if (lane + 32 * v < tw) orow[32 * v] = P::template put<Tout>(acc[v], taps_h);
          }
          if (++o < th) {
            last_o = taps_h.xmin[oy0 + o] + NT - 1;
#pragma unroll
            for (int k = 0; k < NT; ++k) wh[k] = taps_h.w[(long long)(oy0 + o) * NT + k];
          }
        }
      }
    }
    __syncwarp();  // every lane is done with chunk ch's stage
  }
}

struct ArgsS {
  const void* x;
  void* out;
  TableTaps taps_w, taps_h;
  PlanS p;
  int smem;
  cudaStream_t stream;
  unsigned blocks;
  int* occupancy;  // non-null: report resident blocks per SM, launch nothing
};

template <typename Tin, typename Tout, int NT>
int run_stream(const ArgsS& a) {
  auto* kernel = resample2d_stream_kernel<Tin, Tout, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  if (a.occupancy != nullptr) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kernel, kBlock,
                                                              a.smem);
  }
  kernel<<<a.blocks, kBlock, a.smem, a.stream>>>((const Tin*)a.x, (Tout*)a.out, a.taps_w,
                                                 a.taps_h, a.p);
  return (int)cudaGetLastError();
}

// the tables' taps per output: 4 or 8
template <typename Tin, typename Tout>
struct LaunchS {
  static int run(const ArgsS& a) {
    return a.taps_w.ntaps == 4 ? run_stream<Tin, Tout, 4>(a) : run_stream<Tin, Tout, 8>(a);
  }
};

// Checks the plan against the kernel's limits and its own layout (`smem`
// must equal it and fit a block), then launches on `stream`, or, with
// `occupancy` non-null, writes the resident blocks per SM there instead.
int launch(const void* x, void* out, int in_dt, int out_dt, int B, int H, int W, int OH,
           int OW, const TableTaps& taps_w, const TableTaps& taps_h, int seg, int stages,
           int cols_cap, int smem, void* stream, int* occupancy) {
  const int isz = itemsize(in_dt), nt = taps_w.ntaps;
  if (isz == 0 || (nt != 4 && nt != 8) || taps_h.ntaps != nt || seg < 1 || stages < 2 ||
      stages > 4 || cols_cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (kWarps * warp_ring_bytes(stages, nt, cols_cap, isz) != smem || smem + 64 > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int tc = strip_cols(nt);
  const int n_seg = (OH + seg - 1) / seg, n_tx = (OW + tc - 1) / tc;
  const long long tasks = (long long)B * n_seg * n_tx;
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  if (B < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const PlanS p{H, W, OH, OW, seg, n_seg, n_tx, stages, cols_cap, tasks};
  const ArgsS a{x, out, taps_w, taps_h, p, smem, (cudaStream_t)stream, (unsigned)blocks,
                occupancy};
  return dispatch_dtypes<LaunchS>(in_dt, out_dt, a);
}

}  // namespace stream
}  // namespace r2d
}  // namespace ia

extern "C" {

// x[B, H, W] -> out[B, OH, OW] on `stream`, element types by dtype code (0
// uint8, 1 float32, 2 bfloat16).  Device pointers; xmin/ymin int32 [out],
// w_w/w_h float32 row-major [out, ntaps]: ops/cuda_resize.py::
// _stream_tables' in-axis tables, both passes ntaps (4 or 8) taps per
// output.  The plan (seg, stages, cols_cap, smem) is
// ops/cuda_resize.py::_plan_stream's; smem must equal the kernel's layout of
// it.  Returns the cudaError_t of the launch (0 on success).
int ia_resample2d_stream(const void* x, void* out, int in_dt, int out_dt, int B, int H,
                         int W, int OH, int OW, const void* xmin_w, const void* w_w,
                         const void* ymin_h, const void* w_h, int ntaps, int seg, int stages,
                         int cols_cap, int smem, void* stream) {
  const ia::TableTaps tw{(const int*)xmin_w, (const float*)w_w, ntaps};
  const ia::TableTaps th{(const int*)ymin_h, (const float*)w_h, ntaps};
  return ia::r2d::stream::launch(x, out, in_dt, out_dt, B, H, W, OH, OW, tw, th, seg, stages,
                                 cols_cap, smem, stream, nullptr);
}

// Resident blocks per SM of ia_resample2d_stream's kernel for these dtypes,
// taps and plan (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into
// *blocks; no launch.
int ia_resample2d_stream_occupancy(int in_dt, int out_dt, int ntaps, int seg, int stages,
                                   int cols_cap, int smem, int* blocks) {
  const ia::TableTaps t{nullptr, nullptr, ntaps};
  return ia::r2d::stream::launch(nullptr, nullptr, in_dt, out_dt, 1, 1, 1, 1, 1, t, t, seg,
                                 stages, cols_cap, smem, nullptr, blocks);
}

}  // extern "C"
