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
// The masked max (coarse_max_kernel) does the coarse scan's accumulation but
// writes one int32 per template instead of the [ch, cw] scores: at the
// reference's configured 96,300-template bank (96,512 padded) the dense
// scores would be 463 MB per frame. It reads the same L2-resident planes
// about 96,512 * 64 * ~1,000 fitting cells ~ 6 G times, so it is bound by
// those byte loads and their int32 adds (~6 G adds are ~90 us at the card's
// 67 T/s CUDA-core rate), not by its ~78 MB of device-memory traffic
// (~23 us). One block per template, looping over the fitting cells only;
// the maximum is reduced in registers, then across the warp with
// __reduce_max_sync, then across warps in shared memory.
// None of the TPU kernels' artifacts carry over: no 32x128-cell tile limit,
// no rolls, no 8-sublane output blocks, no VMEM gate, no SMEM cap on the
// templates a program takes and no padding of N; any frame whose planes
// fit in device memory (and in int32 offsets) works. Vector loads and
// shared-memory plane tiles are left for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCoarseThreads = 256;       // cells per coarse block
constexpr int kCoarseTemplatesPerBlock = 4;
constexpr int kMaxThreads = 256;  // threads per coarse_max block

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

// out[t] = max over gy < min(lim[t, 0], ch), gx < min(lim[t, 1], cw) of
//          sum_f planes[p_f, gy + sy_f, gx + sx_f], or -1 where no cell fits
// grid: n blocks, one template each; kMaxThreads threads
// dynamic shared memory: f int32
__global__ void coarse_max_kernel(const uint8_t* __restrict__ planes, int rows,
                                  int stride, const int32_t* __restrict__ off3,
                                  const int32_t* __restrict__ lim, int f,
                                  int ch, int cw, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_off[];
  __shared__ int32_t s_warp_max[kMaxThreads / 32];
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    s_off[i] = flat_offset(off3 + (static_cast<size_t>(t) * f + i) * 3, rows,
                           stride);
  }
  __syncthreads();

  const int ny = max(0, min(lim[2 * t], ch));
  const int nx = max(0, min(lim[2 * t + 1], cw));
  const int cells = ny * nx;
  int32_t best = -1;
  for (int g = threadIdx.x; g < cells; g += blockDim.x) {
    const int gy = g / nx;
    const int gx = g - gy * nx;
    const uint8_t* base = planes + static_cast<size_t>(gy) * stride + gx;
    int32_t acc = 0;
    for (int k = 0; k < f; ++k) acc += base[s_off[k]];
    best = max(best, acc);
  }
  best = __reduce_max_sync(0xffffffffu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp_max[warp] = best;
  __syncthreads();
  if (warp == 0) {
    int32_t v = lane < kMaxThreads / 32 ? s_warp_max[lane] : -1;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) out[t] = v;
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

extern "C" int coarse_max(const void* planes, int rows, int stride,
                          const void* off3, const void* lim, int n, int f,
                          int ch, int cw, void* out, void* stream) {
  const size_t smem = sizeof(int32_t) * f;
  coarse_max_kernel<<<n, kMaxThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), rows, stride,
      static_cast<const int32_t*>(off3), static_cast<const int32_t*>(lim), f,
      ch, cw, static_cast<int32_t*>(out));
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
