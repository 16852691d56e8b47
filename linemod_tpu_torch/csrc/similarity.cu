// LINE-MOD similarity scans for Hopper (sm_90a): the coarse scan of every
// template at every coarse grid cell, its per-template masked max (phase 1
// of the large-bank prefiltered cut), and the fine refine of the top-K
// candidates over their sub-cell windows.
//
// Replaces the three Pallas TPU scan kernels:
//   coarse_scores_kernel <- coarse_scores_pallas / _make_coarse_kernel,
//                           linemod_tpu/ops/similarity_pallas.py:42-107
//   coarse_max_kernel    <- coarse_max_pallas / _make_coarse_max_kernel,
//                           linemod_tpu/ops/similarity_pallas.py:110-216
//   fine_scores_kernel   <- fine_scores_pallas / _fine_kernel,
//                           linemod_tpu/ops/similarity_pallas.py:222-299
//
// All three are gather-accumulates over per-template feature tables:
//   score = sum_f planes[p_f, y + sy_f, x + sx_f]
// on u8 linearized response planes [P(+1 zero plane), rows, stride]
// (linemod_tpu_torch/ops/spread.py), with each feature given as a
// (plane, sy, sx) int32 triplet and invalid features pointing at the
// trailing all-zero plane. Sums are int32 and exact, so a kernel equals its
// plain PyTorch version bit for bit.
//
// What bounds them on the card: at the 640x480 fixture the coarse scan
// reads N*F*G = 2048*64*1200 ~ 157 M plane bytes and writes 9.8 MB of int32
// scores; the fine refine reads 512*64*64 ~ 2.1 M bytes. The planes
// (coarse 3.2 MB, fine 3.9 MB) sit in the 50 MB L2 for the whole launch, so
// the coarse scan is bound by L2 load throughput and by how many byte loads
// per cycle the SMs execute, not by device memory. The design, kept simple:
//   - a block stages its templates' triplets, pre-folded into flat plane
//     offsets, in shared memory once; every thread then reads them as
//     broadcasts;
//   - each thread owns one output cell, so the 32 threads of a warp read
//     32 neighbouring bytes of one plane row per feature (one or two L2
//     sectors) and accumulate in a register;
//   - a coarse block scores several templates per staged table, which
//     amortises the staging and the cell index math;
//   - outputs are written once, cropped to the real grid, coalesced.
// None of the TPU kernels' artifacts carry over: no 32x128-cell tile limit,
// no rolls, no 8-sublane output blocks, no VMEM gate, no SMEM cap on the
// templates a program takes and no padding of N. For the two scans any frame
// whose planes fit in device memory (and in int32 offsets) works; vector
// loads and shared-memory plane tiles are left for later work.
//
// The masked max (coarse_max_kernel, replacing coarse_max_pallas) does the
// coarse scan's accumulation but writes one int32 per template instead of
// the [ch, cw] scores: at the reference's configured 96,300-template bank
// (96,512 padded) the dense scores would be 463 MB per frame. Its distinct
// non-zero input is small (512 planes x 30 x 40 cells = 614 KB at the
// 640x480 fixture), but it is looked up ~5.7 G times a frame. The first
// port (one block per template, one global byte load per feature and cell)
// pulled every lookup through L1 from L2: ~10.8 GB of 32-byte sectors a
// frame, at L2 bandwidth, 23x above its bound. This design serves the
// lookups from shared memory and reads each plane byte from L2 once per
// group of templates:
//   - a block of kWarps warps takes kWarps * kSlots units of work (48
//     templates at the fixture; a unit is 32 rows x 40 columns of a
//     template's fit box, so a 60x80 grid takes 4). It walks the planes in
//     chunks; for each chunk it stages every plane's reachable rectangle
//     (rows [0, ch + max_sy), 4 * pitch bytes of each row, padding bytes
//     included) with 16-byte loads, kBatch in flight a thread;
//   - lane l of a warp owns row l of its units, as kItems 8-cell items, and
//     keeps their sums in registers across the chunks. The host sorts each
//     template's features by plane into per-chunk buckets of offsets into
//     the staged chunk (CoarseMaxPlan, ops/similarity_cuda.py), so a bucket
//     is added as soon as its chunk is staged;
//   - an item is 3 aligned 32-bit shared-memory reads (neighbouring items
//     share one) and two funnel shifts, which give its 8 unaligned bytes,
//     added as 4 byte lanes of two u32 words. The staged row pitch is an odd
//     number of words, so the 32 lanes' rows fall in 32 banks whatever the
//     feature's shift. A byte lane holds at most 32 x 7 < 256 between
//     flushes into u16 pairs, so plane bytes up to 7 are exact (responses
//     are 0..4), and the u16 pairs hold F <= 8192 features of 7;
//   - after the last chunk the cells outside the fit box are masked, the
//     max is reduced across the warp with __reduce_max_sync and combined
//     across a template's units with atomicMax on an output the wrapper
//     fills with -1.
// What bounds it now, at the fixture with the 96,512 bank: the stage, ~2 GB
// a frame from L2 (64-byte sectors a 52-byte row, 2,011 groups), and the
// shared-memory reads, 11 a feature for each warp, with the warps waiting
// for the slowest at each chunk. The two do not overlap; the group size
// that sets the stage's bytes is set by the registers the sums take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCoarseThreads = 256;       // cells per coarse block
constexpr int kCoarseTemplatesPerBlock = 4;
// coarse_max: kWarps warps a block, kSlots units a warp, kItems 8-cell
// items a lane and unit, sums flushed from byte lanes every kFlush features
// (at most 32: a batch's offsets are held one a lane), kStageBytes of
// shared memory per chunk, kBatch 16-byte loads in flight a thread
// (ops/similarity_cuda.py holds the same numbers for its plan)
constexpr int kWarps = 16;
constexpr int kSlots = 3;
constexpr int kItems = 5;
constexpr int kFlush = 32;
constexpr int kStageBytes = 180 * 1024;
constexpr int kBatch = 4;

__device__ __forceinline__ int32_t flat_offset(const int32_t* trip, int rows,
                                               int stride) {
  return (trip[0] * rows + trip[1]) * stride + trip[2];
}

// scores[t, gy, gx] = sum_f planes[p_f, gy + sy_f, gx + sx_f]
// grid: (ceil(n / kCoarseTemplatesPerBlock), ceil(ch * cw / kCoarseThreads))
// dynamic shared memory: kCoarseTemplatesPerBlock * f int32
__global__ void coarse_scores_kernel(const uint8_t* __restrict__ planes,
                                     int rows, int stride,
                                     const int32_t* __restrict__ off3, int n,
                                     int f, int ch, int cw,
                                     int32_t* __restrict__ out) {
  extern __shared__ int32_t s_off[];
  const int t0 = blockIdx.x * kCoarseTemplatesPerBlock;
  const int n_t = min(kCoarseTemplatesPerBlock, n - t0);
  for (int i = threadIdx.x; i < n_t * f; i += blockDim.x) {
    s_off[i] = flat_offset(off3 + (static_cast<size_t>(t0) * f + i) * 3, rows,
                           stride);
  }
  __syncthreads();

  const int cells = ch * cw;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= cells) return;
  const int gy = g / cw;
  const int gx = g - gy * cw;
  const uint8_t* base = planes + static_cast<size_t>(gy) * stride + gx;
  for (int tt = 0; tt < n_t; ++tt) {
    const int32_t* o = s_off + tt * f;
    int32_t acc = 0;
    for (int k = 0; k < f; ++k) acc += base[o[k]];
    out[static_cast<size_t>(t0 + tt) * cells + g] = acc;
  }
}

// One unit of coarse_max work: the cells of template t's fit box (ny x nx)
// in rows [row0, row0 + 32) and columns [col0, col0 + 8 * kItems); lane l
// owns row row0 + l, as kItems 8-cell items.
struct Unit {
  int t, row0, col0, ny, nx;
};

__device__ __forceinline__ Unit unit_of(int u, const int32_t* lim, int n,
                                        int ch, int cw, int row_bands,
                                        int col_bands) {
  Unit w{-1, 0, 0, 0, 0};
  const int per_template = row_bands * col_bands;
  if (u >= n * per_template) return w;
  const int t = u / per_template;
  const int band = u - t * per_template;
  const int rb = band / col_bands;
  w.row0 = rb * 32;
  w.col0 = (band - rb * col_bands) * 8 * kItems;
  w.ny = max(0, min(lim[2 * t], ch));
  w.nx = max(0, min(lim[2 * t + 1], cw));
  if (w.row0 < w.ny && w.col0 < w.nx) w.t = t;
  return w;
}

// out[t] = max over gy < min(lim[t, 0], ch), gx < min(lim[t, 1], cw) of
//          sum_f planes[p_f, gy + sy_f, gx + sx_f]; out holds -1 on entry.
// feat [n, f]: template t's features on planes < n_planes, sorted by plane,
//   as byte offsets (p - chunk's first plane) * stage_rows * 4 * pitch +
//   sy * 4 * pitch + sx into its chunk's staged rectangles; starts
//   [n, chunks + 1]: chunk c's bucket is feat[t, starts[t, c]:starts[t, c+1]].
// grid: ceil(n * row_bands * col_bands / (kWarps * kSlots)); kWarps * 32
// threads; dynamic shared memory: chunk_planes * stage_rows * pitch words.
__global__ void __launch_bounds__(kWarps * 32, 1)
    coarse_max_kernel(const uint8_t* __restrict__ planes, int rows, int stride,
                      const int32_t* __restrict__ feat,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ lim, int n, int f, int ch,
                      int cw, int n_planes, int stage_rows, int pitch,
                      int chunk_planes, int chunks, int row_bands,
                      int col_bands, int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_words[];
  const int lane = threadIdx.x & 31;
  const int unit0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kSlots;

  // per slot: the template (-1: idle), the word offset of the lane's row
  // in a staged rectangle, and the bounds [fb, fe) of the next bucket
  int tmpl[kSlots], base[kSlots], fb[kSlots], fe[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const Unit w = unit_of(unit0 + s, lim, n, ch, cw, row_bands, col_bands);
    tmpl[s] = w.t;
    base[s] = w.row0 + lane < w.ny ? (w.row0 + lane) * pitch + w.col0 / 4 : 0;
    const int32_t* st = starts + static_cast<size_t>(max(w.t, 0)) * (chunks + 1);
    fb[s] = st[0];
    fe[s] = chunks > 0 ? st[1] : 0;
  }
  // u16 pairs: acc[s][k][v][0] holds cells 4v and 4v + 2 of item k,
  // acc[s][k][v][1] cells 4v + 1 and 4v + 3
  uint32_t acc[kSlots][kItems][2][2] = {};

  // the stage: each thread moves one 16-byte column of every movers-th
  // staged row, kBatch loads in flight before their stores
  const int row_units = (pitch + 3) >> 2;
  const int movers = blockDim.x / row_units;
  const int mover = threadIdx.x / row_units;
  const int col = (threadIdx.x - mover * row_units) << 4;
  const int step_p = movers / stage_rows, step_r = movers - step_p * stage_rows;
  for (int c = 0; c < chunks; ++c) {
    const int p0 = c * chunk_planes;
    const int plane_rows = min(chunk_planes, n_planes - p0) * stage_rows;
    // the bucket's first 32 features, and the next bucket's bounds, are
    // loaded before the stage so that their latency hides behind it
    int mine[kSlots], next_fe[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const size_t t = max(tmpl[s], 0);
      mine[s] = fb[s] + lane < fe[s] ? feat[t * f + fb[s] + lane] : 0;
      next_fe[s] = c + 2 <= chunks ? starts[t * (chunks + 1) + c + 2] : 0;
    }
    __syncthreads();  // every warp is done with the previous chunk
    if (mover < movers) {
      int p = mover / stage_rows, r = mover - p * stage_rows;
      for (int pr = mover; pr < plane_rows; pr += kBatch * movers) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = make_uint4(0, 0, 0, 0);
          if (pr + u * movers < plane_rows && col < stride) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                planes + (static_cast<size_t>(p0 + p) * rows + r) * stride +
                col));
          }
          p += step_p;
          r += step_r;
          if (r >= stage_rows) {
            r -= stage_rows;
            ++p;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (pr + u * movers >= plane_rows) break;
          uint32_t* dst = s_words + (pr + u * movers) * pitch + (col >> 2);
          const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if ((col >> 2) + e < pitch) dst[e] = w[e];
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tmpl[s] < 0) continue;  // warp-uniform
      const int32_t* ft = feat + static_cast<size_t>(tmpl[s]) * f;
      for (int b = fb[s]; b < fe[s]; b += kFlush) {
        const int nb = min(kFlush, fe[s] - b);
        const int batch = b == fb[s] ? mine[s] : (lane < nb ? ft[b + lane] : 0);
        uint32_t a8[kItems][2] = {};
        for (int q = 0; q < nb; ++q) {
          const int off = __shfl_sync(0xffffffffu, batch, q);
          const uint32_t* w = s_words + base[s] + (off >> 2);
          const uint32_t sh = (off & 3) << 3;
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            const uint32_t w0 = w[2 * k], w1 = w[2 * k + 1], w2 = w[2 * k + 2];
            a8[k][0] += __funnelshift_r(w0, w1, sh);
            a8[k][1] += __funnelshift_r(w1, w2, sh);
          }
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            acc[s][k][v][0] += a8[k][v] & 0x00FF00FFu;
            acc[s][k][v][1] += (a8[k][v] >> 8) & 0x00FF00FFu;
          }
        }
      }
      fb[s] = fe[s];
      fe[s] = next_fe[s];
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const Unit w = unit_of(unit0 + s, lim, n, ch, cw, row_bands, col_bands);
    if (w.t < 0) continue;  // warp-uniform
    int32_t best = -1;
    if (w.row0 + lane < w.ny) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const uint32_t lo = acc[s][k][v][0], hi = acc[s][k][v][1];
          const int gx = w.col0 + 8 * k + 4 * v;
          if (gx < w.nx) best = max(best, static_cast<int32_t>(lo & 0xFFFFu));
          if (gx + 1 < w.nx) best = max(best, static_cast<int32_t>(hi & 0xFFFFu));
          if (gx + 2 < w.nx) best = max(best, static_cast<int32_t>(lo >> 16));
          if (gx + 3 < w.nx) best = max(best, static_cast<int32_t>(hi >> 16));
        }
      }
    }
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) atomicMax(out + w.t, best);
  }
}

// scores[k, dy, dx] = sum_f planes[p_f, by_k + sy_f + dy, bx_k + sx_f + dx]
// over the features of template cand_t[k]; one block per candidate, one
// thread per window cell (win * win threads).
// dynamic shared memory: f int32
__global__ void fine_scores_kernel(const uint8_t* __restrict__ planes,
                                   int rows, int stride,
                                   const int32_t* __restrict__ off3, int f,
                                   const int32_t* __restrict__ cand_t,
                                   const int32_t* __restrict__ base_yx,
                                   int win, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_off[];
  const int k = blockIdx.x;
  const int32_t* trips = off3 + static_cast<size_t>(cand_t[k]) * f * 3;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    s_off[i] = flat_offset(trips + static_cast<size_t>(i) * 3, rows, stride);
  }
  __syncthreads();

  const int dy = threadIdx.x / win;
  const int dx = threadIdx.x - dy * win;
  const uint8_t* base = planes +
                        static_cast<size_t>(base_yx[2 * k] + dy) * stride +
                        base_yx[2 * k + 1] + dx;
  int32_t acc = 0;
  for (int i = 0; i < f; ++i) acc += base[s_off[i]];
  out[static_cast<size_t>(k) * win * win + threadIdx.x] = acc;
}

}  // namespace

// C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int coarse_scores(const void* planes, int rows, int stride,
                             const void* off3, int n, int f, int ch, int cw,
                             void* out, void* stream) {
  const int cells = ch * cw;
  const dim3 grid((n + kCoarseTemplatesPerBlock - 1) / kCoarseTemplatesPerBlock,
                  (cells + kCoarseThreads - 1) / kCoarseThreads);
  const size_t smem = sizeof(int32_t) * kCoarseTemplatesPerBlock * f;
  coarse_scores_kernel<<<grid, kCoarseThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), rows, stride,
      static_cast<const int32_t*>(off3), n, f, ch, cw,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// geometry: {n_planes, stage_rows, pitch, chunk_planes, chunks, row_bands,
// col_bands}, from the wrapper's plan; out must hold -1. Returns
// cudaErrorInvalidValue for a geometry the kernel's constants do not cover.
extern "C" int coarse_max(const void* planes, int rows, int stride,
                          const void* feat, const void* starts,
                          const void* lim, int n, int f, int ch, int cw,
                          const int* geometry, void* out, void* stream) {
  const int n_planes = geometry[0], stage_rows = geometry[1],
            pitch = geometry[2], chunk_planes = geometry[3],
            chunks = geometry[4], row_bands = geometry[5],
            col_bands = geometry[6];
  const size_t buf =
      sizeof(uint32_t) * static_cast<size_t>(chunk_planes) * stage_rows * pitch;
  if (stage_rows > rows || buf > kStageBytes || 32 * row_bands < ch ||
      8 * kItems * col_bands < cw || chunks * chunk_planes < n_planes ||
      f > 8192 || stride % 16 || reinterpret_cast<uintptr_t>(planes) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n * row_bands * col_bands + kWarps * kSlots - 1) /
                     (kWarps * kSlots);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(buf));
  if (err != cudaSuccess) return static_cast<int>(err);
  coarse_max_kernel<<<blocks, kWarps * 32, buf,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), rows, stride,
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lim), n, f, ch, cw, n_planes, stage_rows,
      pitch, chunk_planes, chunks, row_bands, col_bands,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fine_scores(const void* planes, int rows, int stride,
                           const void* off3, int f, const void* cand_t,
                           const void* base_yx, int k, int win, void* out,
                           void* stream) {
  const size_t smem = sizeof(int32_t) * f;
  fine_scores_kernel<<<k, win * win, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), rows, stride,
      static_cast<const int32_t*>(off3), f,
      static_cast<const int32_t*>(cand_t),
      static_cast<const int32_t*>(base_yx), win, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
