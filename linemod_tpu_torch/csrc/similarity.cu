// LINE-MOD similarity scans for Hopper (sm_90a): the coarse scan of every
// template at every coarse grid cell, its per-template masked max (phase 1
// of the large-bank prefiltered cut), and the fine refine of the top-K
// candidates over their sub-cell windows.
//
// Replaces the three Pallas TPU scan kernels:
//   coarse_kernel<true>  <- coarse_scores_pallas / _make_coarse_kernel,
//                           linemod_tpu/ops/similarity_pallas.py:42-107
//   coarse_kernel<false> <- coarse_max_pallas / _make_coarse_max_kernel,
//                           linemod_tpu/ops/similarity_pallas.py:110-216
//   fine_kernel<L, S>    <- fine_scores_pallas / _fine_kernel,
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
// The coarse scan and the masked max share one body (coarse_kernel). Their
// input is small (the 640x480 fixture's coarse planes are 513 x 48 x 128 =
// 3.2 MB) but looked up many times: N * F * G = 2048 * 64 * 1200 ~ 157 M
// times a frame for the scan, ~5.7 G for the masked max over the 96,512
// templates of the reference's configured bank. One global byte load per
// lookup pulls every lookup through L1 from L2 (the first ports: ~0.5 GB of
// sectors for the scan, ~10.8 GB for the masked max). The body serves the
// lookups from shared memory instead and reads each plane byte from L2
// once per group of templates:
//   - a unit of work is 32 rows x 40 columns of a template's cells (a band),
//     so a 30x40 grid is one band and a 60x80 grid four. A block of kWarps
//     warps takes kWarps * kSlots units of one band (48 templates for the
//     masked max, 32 for the scan; see kMaxSlots, kScanSlots). It walks
//     the planes in chunks; for each chunk it stages every plane's
//     rectangle that the band reaches (rows [row0, row0 + stage_rows) and
//     4 * pitch bytes of each row from the band's first column rounded down
//     to 16 bytes, padding bytes included) with 16-byte loads, kBatch in
//     flight a thread;
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
//     are 0..4), and the u16 pairs hold F <= 8192 features of 7.
// The two epilogues:
//   - masked max (2.3): the cells outside the fit box are masked, the max
//     is reduced across the warp with __reduce_max_sync and combined across
//     a template's units with atomicMax on an output the wrapper fills with
//     -1. At 96,512 templates there are 2,011 groups, which fill the card.
//   - scores (2.1): every cell is written as int32. At 1,024-4,096
//     templates one block a group would leave most of the 132 SMs idle (64
//     groups of 32 at the fixture's 2,048), so S blocks of a thread-block
//     cluster share one group: block r stages and adds chunks r, r + S, ...
//     After the last chunk each block leaves its u16 partial sums, in cell
//     order, in its own shared memory; after cluster.sync() each block adds
//     1/S of the 16-byte items (8 cells) across the S blocks' buffers
//     (distributed shared memory, u16 pairs added as u32: the totals fit 16
//     bits), unpacks them and stores them cropped to [ch, cw], two 16-byte
//     stores an item where the row allows, a warp's lanes on consecutive
//     items. No atomics and no memset; the bytes staged are those of a block
//     without the split. The wrapper picks S from N, the grid, the chunks
//     and cudaOccupancyMaxActiveClusters (at 180 KB a block the card runs
//     66 clusters of 2 but only 39 of 3: a cluster's blocks share a GPC).
// What bounds the body: the stage (the masked max at the fixture with the
// 96,512 bank: ~2 GB a frame from L2, 64-byte sectors a 52-byte row, 2,011
// groups) and the shared-memory reads, 11 a feature for each warp, with the
// warps waiting for the slowest at each chunk. The two do not overlap; the
// group size that sets the stage's bytes is set by the registers the sums
// take. The scan at the fixture is short: a block's 3 chunks, its combine
// and its stores, with one cluster round on the card.
//
// The fine refine (fine_kernel) sums each of K candidates' F features over
// a win x win window: at the fixture 512 x 64 windows of 8 rows of 8
// bytes, ~2.1 M plane bytes (347 KB distinct) from the 3.9 MB fine planes,
// which the linearize step has just written and which sit in L2. What
// bounds it is the L2: each row's 8 bytes come in one or two 32-byte
// sectors, ~10 MB of sectors at the fixture, ~2 us at the ~5 TB/s the L2
// serves, which the L1 cuts only where rows repeat; then the chain of
// dependent round trips (the candidate's template, its triplets, the rows)
// and the launch. One thread a cell (the first port) reads the same
// sectors, so at window 8 the design matches it; it wins where that one
// left lanes idle (window 4: 16 threads a block). The design:
//   - a warp a group of a candidate's window rows, two warps a candidate
//     from window 2 to 8 (more warps in flight than one a candidate: faster
//     at 1280x960 and the dual shape), no shared memory and no
//     __syncthreads();
//   - lane = (slice s, row r, word j): L lanes a window row hold its W + 1
//     consecutive aligned plane words (W = ceil(win / 4) result words, L a
//     power of two >= W + 1), so one load instruction reads whole rows, a
//     request a row: at win 8, L = 4 and 2 slices of 4 rows (2 features an
//     instruction); at win 4, L = 2 and 8 slices of 2 rows; idle lanes
//     read words that live lanes read, so a batch reads exactly the
//     sectors its rows need. A first design with lanes as (row, slice),
//     each lane loading its row's 3 words itself, made 24 requests a
//     feature and was slower than one thread a cell (PERF.md, Findings);
//   - the warp takes its template's features 32 at a time: lane l loads
//     feature b + l's triplet (3 coalesced loads a batch; the next batch's
//     are loaded before this one is added) and makes its flat offset; slice
//     s takes the batch's features s, s + S, ... by __shfl_sync, issues all
//     their loads, then adds them: lane j joins its word and the next
//     lane's (__shfl_down_sync) with a funnel shift (the coarse kernel's
//     trick), 4 byte lanes a word, flushed into u16 pairs every kFineFlush
//     features a lane (bytes <= 7 exact);
//   - the S slices' u16 pairs are summed with __shfl_xor_sync (F <= 8192
//     keeps the totals under 65,536, so no widening), and lane (0, r, j)
//     stores cells 4j .. 4j + 3 of row r, one 16-byte store where win is a
//     multiple of 4.
// No tensor cores and no TMA: there is no product to give wgmma and no
// tile for TMA, only scattered 8-byte rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// kWarps warps a block, kItems 8-cell items a lane and
// unit, sums flushed from byte lanes every kFlush features (at most 32: a
// batch's offsets are held one a lane), kStageBytes of shared memory per
// chunk, kBatch 16-byte loads in flight a thread, at most kMaxSplit blocks
// a group (ops/similarity_cuda.py holds the same numbers for its plan)
constexpr int kWarps = 16;
// units a warp: the masked max takes 3 (48 templates a block; the sums take
// all 128 registers a thread may have at 512 threads), the scan 2 (32 a
// block: 1,024-4,096 templates then make more groups to spread over the
// SMs; measured faster at the fixture, slower for the masked max)
constexpr int kMaxSlots = 3;
constexpr int kScanSlots = 2;
constexpr int kMaxUnits = kWarps * kMaxSlots;
constexpr int kScanUnits = kWarps * kScanSlots;
constexpr int kItems = 5;
constexpr int kFlush = 32;
constexpr int kStageBytes = 180 * 1024;
constexpr int kBatch = 4;
constexpr int kMaxSplit = 8;
// the scan's u16 partial sums of one block: its units x 32 rows x kItems
// items of 8 cells (16 bytes), kept in the stage's buffer after the last
// chunk
constexpr int kPartItems = kScanUnits * 32 * kItems;
// the fine kernel: at most kFineMaxWarps warps a block (the wrapper passes
// its FINE_WARPS), features taken kFineBatch at a time
// (one offset a lane), byte lanes flushed every kFineFlush features a lane,
// at most kFineMaxFeatures features (u16 totals of bytes <= 7);
// ops/similarity_cuda.py holds the same numbers
constexpr int kFineMaxWarps = 8;
constexpr int kFineBatch = 32;
constexpr int kFineFlush = 32;
constexpr int kFineMaxFeatures = 8192;

struct Geometry {
  int n_planes, stage_rows, pitch, chunk_planes, chunks, row_bands, col_bands;
};

__device__ __forceinline__ int32_t flat_offset(const int32_t* trip, int rows,
                                               int stride) {
  return (trip[0] * rows + trip[1]) * stride + trip[2];
}

// One unit of coarse work: the cells of template t in rows [row0, row0 +
// 32) and columns [col0, col0 + 8 * kItems) (its band), cut to ny x nx (the
// grid, or the masked max's fit box); lane l owns row row0 + l, as kItems
// 8-cell items. t is -1 where the unit has no cell.
struct Unit {
  int t, row0, col0, ny, nx;
};

// Unit j of block `group` of `units` units: the groups are band-major,
// ceil(n / units) of them a band, and a group's units are templates of one
// band.
__device__ __forceinline__ Unit unit_of(int group, int j, int units,
                                        const int32_t* lim, int n, int ch,
                                        int cw, int col_bands) {
  const int per_band = (n + units - 1) / units;
  const int band = group / per_band;
  const int t = (group - band * per_band) * units + j;
  const int rb = band / col_bands;
  Unit w{-1, rb * 32, (band - rb * col_bands) * 8 * kItems, 0, 0};
  if (t >= n) return w;
  w.ny = lim == nullptr ? ch : max(0, min(lim[2 * t], ch));
  w.nx = lim == nullptr ? cw : max(0, min(lim[2 * t + 1], cw));
  if (w.row0 < w.ny && w.col0 < w.nx) w.t = t;
  return w;
}

// kScores: scores[t, gy, gx] = sum_f planes[p_f, gy + sy_f, gx + sx_f] for
//   every cell (lim unused), the group's chunks split over the `split`
//   blocks of a cluster;
// else: out[t] = max over gy < min(lim[t, 0], ch), gx < min(lim[t, 1], cw)
//   of the same sums; out holds -1 on entry; split is 1.
// feat [n, f]: template t's features on planes < n_planes, sorted by plane,
//   as byte offsets (p - chunk's first plane) * stage_rows * 4 * pitch +
//   sy * 4 * pitch + sx into its chunk's staged rectangles (relative to the
//   band's corner); starts [n, chunks + 1]: chunk c's bucket is
//   feat[t, starts[t, c]:starts[t, c+1]].
// grid: row_bands * col_bands * ceil(n / kUnits) * split blocks of
// kWarps * 32 threads; dynamic shared memory: chunk_planes * stage_rows *
// pitch words, and at least kPartItems 16-byte items for the scores.
template <bool kScores>
__global__ void __launch_bounds__(kWarps * 32, 1)
    coarse_kernel(const uint8_t* __restrict__ planes, int rows, int stride,
                  const int32_t* __restrict__ feat,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ lim, int n, int f, int ch,
                  int cw, Geometry geo, int split, int32_t* __restrict__ out) {
  constexpr int kSlots = kScores ? kScanSlots : kMaxSlots;
  constexpr int kUnits = kWarps * kSlots;
  extern __shared__ __align__(16) uint32_t s_words[];
  const int n_planes = geo.n_planes, stage_rows = geo.stage_rows,
            pitch = geo.pitch, chunk_planes = geo.chunk_planes,
            chunks = geo.chunks, col_bands = geo.col_bands;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = blockIdx.x / split;
  const int rank = blockIdx.x - group * split;
  // the block's band: its first row, and its first column rounded down to
  // a 16-byte load (the band's columns start 0 or 8 bytes into the stage)
  const Unit band = unit_of(group, 0, kUnits, nullptr, n, ch, cw, col_bands);
  const int col_start = band.col0 & ~15;

  // per slot: the template (-1: idle), the word offset of the lane's row
  // in a staged rectangle, and the bounds fb | fe << 16 of the next bucket
  int tmpl[kSlots], base[kSlots], bounds[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const Unit w =
        unit_of(group, warp * kSlots + s, kUnits, lim, n, ch, cw, col_bands);
    tmpl[s] = w.t;
    base[s] = w.row0 + lane < w.ny ? lane * pitch + (w.col0 - col_start) / 4 : 0;
    const int32_t* st = starts + static_cast<size_t>(max(w.t, 0)) * (chunks + 1);
    bounds[s] = rank < chunks ? st[rank] | st[rank + 1] << 16 : 0;
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
  for (int c = rank; c < chunks; c += split) {
    const int p0 = c * chunk_planes;
    const int plane_rows = min(chunk_planes, n_planes - p0) * stage_rows;
    // the bucket's first 32 features, and the next bucket's bounds, are
    // loaded before the stage so that their latency hides behind it
    int mine[kSlots], next[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const size_t t = max(tmpl[s], 0);
      const int fb = bounds[s] & 0xFFFF, fe = bounds[s] >> 16;
      mine[s] = fb + lane < fe ? feat[t * f + fb + lane] : 0;
      const int32_t* st = starts + t * (chunks + 1) + c + split;
      next[s] = c + split < chunks ? st[0] | st[1] << 16 : 0;
    }
    __syncthreads();  // every warp is done with the previous chunk
    if (mover < movers) {
      int p = mover / stage_rows, r = mover - p * stage_rows;
      for (int pr = mover; pr < plane_rows; pr += kBatch * movers) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = make_uint4(0, 0, 0, 0);
          if (pr + u * movers < plane_rows && band.row0 + r < rows &&
              col_start + col < stride) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                planes +
                (static_cast<size_t>(p0 + p) * rows + band.row0 + r) * stride +
                col_start + col));
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
      const int fb = bounds[s] & 0xFFFF, fe = bounds[s] >> 16;
      for (int b = fb; b < fe; b += kFlush) {
        const int nb = min(kFlush, fe - b);
        const int batch = b == fb ? mine[s] : (lane < nb ? ft[b + lane] : 0);
        uint32_t a8[kItems][2] = {};
#pragma unroll 4
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
      bounds[s] = next[s];
    }
  }

  if constexpr (kScores) {
    // this block's partial sums, as u16 pairs in cell order: item
    // (unit * 32 + row) * kItems + k is 4 words, the pairs of cells
    // (0, 1), (2, 3), (4, 5), (6, 7) of the row's item k; one 16-byte
    // store a lane (a lane stride of 80 bytes: no bank conflict)
    __syncthreads();  // every warp is done with the last chunk's stage
    uint4* part = reinterpret_cast<uint4*>(s_words);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const uint32_t(&a)[2][2] = acc[s][k];
        part[((warp * kSlots + s) * 32 + lane) * kItems + k] =
            make_uint4(__byte_perm(a[0][0], a[0][1], 0x5410),
                       __byte_perm(a[0][0], a[0][1], 0x7632),
                       __byte_perm(a[1][0], a[1][1], 0x5410),
                       __byte_perm(a[1][0], a[1][1], 0x7632));
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // block `rank` takes its 1/split of the items, adds them across the
    // blocks' buffers (u16 pairs added as u32: the totals fit 16 bits) and
    // writes their 8 cells cropped to the grid; a warp's lanes take
    // consecutive items, which are consecutive cells of a row
    const int end = (rank + 1) * kPartItems / split;
    for (int e = rank * kPartItems / split + threadIdx.x; e < end;
         e += blockDim.x) {
      const int j = e / (32 * kItems);
      const int row = (e - j * 32 * kItems) / kItems;
      const int k = e - (j * 32 + row) * kItems;
      const Unit w = unit_of(group, j, kUnits, nullptr, n, ch, cw, col_bands);
      const int gy = w.row0 + row, gx = w.col0 + 8 * k;
      if (w.t < 0 || gy >= ch || gx >= cw) continue;
      uint4 sum = make_uint4(0, 0, 0, 0);
      for (int r = 0; r < split; ++r) {
        const uint4 v = *cluster.map_shared_rank(part + e, r);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int32_t c[8] = {
          static_cast<int32_t>(sum.x & 0xFFFFu), static_cast<int32_t>(sum.x >> 16),
          static_cast<int32_t>(sum.y & 0xFFFFu), static_cast<int32_t>(sum.y >> 16),
          static_cast<int32_t>(sum.z & 0xFFFFu), static_cast<int32_t>(sum.z >> 16),
          static_cast<int32_t>(sum.w & 0xFFFFu), static_cast<int32_t>(sum.w >> 16)};
      int32_t* o = out + (static_cast<size_t>(w.t) * ch + gy) * cw + gx;
      if ((cw & 3) == 0 && gx + 8 <= cw) {  // o is 16-byte aligned
        reinterpret_cast<int4*>(o)[0] = make_int4(c[0], c[1], c[2], c[3]);
        reinterpret_cast<int4*>(o)[1] = make_int4(c[4], c[5], c[6], c[7]);
      } else {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (gx + m < cw) o[m] = c[m];
        }
      }
    }
    cluster.sync();  // no block leaves while the others read its buffer
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const Unit w =
          unit_of(group, warp * kSlots + s, kUnits, lim, n, ch, cw, col_bands);
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
}

// scores[k, dy, dx] = sum_f planes[p_f, by_k + sy_f + dy, bx_k + sx_f + dx]
// over the features of template cand_t[k]. A candidate takes `groups` =
// ceil(win / kRows) warps, one a group of kRows rows; warp w of block b is
// warp b * (blockDim.x / 32) + w of the grid, group g of candidate c in
// order c * groups + g. A lane is (slice s, row r, word j) of L lanes a row
// and kRows rows a slice; a row's W = ceil(win / 4) result words need
// W + 1 <= L plane words. f >= 1. last_word: the planes' last 32-bit word
// (the extra word's load is clamped to it).
// (minimum 1 block an SM: without it ptxas keeps 32 registers and issues
// each load behind the previous one's shuffle, 3.5x slower at the fixture)
template <int L, int S>
__global__ void __launch_bounds__(kFineMaxWarps * 32, 1)
    fine_kernel(const uint8_t* __restrict__ planes, int rows, int stride,
                int last_word, const int32_t* __restrict__ off3, int f,
                const int32_t* __restrict__ cand_t,
                const int32_t* __restrict__ base_yx, int k, int win,
                int32_t* __restrict__ out) {
  constexpr int kRows = 32 / (L * S);
  constexpr int kPer = kFineBatch / S;  // a slice's features of a batch
  constexpr int kFlushBatches = kFineFlush / kPer;
  const int lane = threadIdx.x & 31;
  const int groups = (win + kRows - 1) / kRows;
  const int gw = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int c = gw / groups;
  if (c >= k) return;  // warp-uniform
  const int dy = (gw - c * groups) * kRows + lane / L % kRows;
  const int j = lane % L;
  const int s = lane / (L * kRows);
  const int row_words = (win + 3) >> 2;
  const int32_t* trips = off3 + static_cast<size_t>(cand_t[c]) * f * 3;
  const int by = base_yx[2 * c], bx = base_yx[2 * c + 1];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(planes);
  // feature g's flat offset into the planes; past the last feature, the
  // last feature's
  auto offset_of = [&](int g) {
    return flat_offset(trips + 3 * static_cast<size_t>(min(g, f - 1)), rows, stride);
  };

  // every lane loads, so that a batch's loads are all in flight, and
  // reads only sectors the batch needs: lanes past the window's last row
  // or the row's extra word, and features past the last, read words a
  // live lane reads; the extra word's lanes read the row's last word
  // where the row's bytes end before the extra word (the funnel shift
  // then takes none of its bytes that are kept); only lanes
  // j < row_words of live rows add
  const bool adds = dy < win && j < row_words;
  // the extra word is needed where (at & 3) > slack
  const int slack = j >= row_words ? 4 * row_words - win : -1;
  const int base = (by + min(dy, win - 1)) * stride + bx + 4 * min(j, row_words);
  // byte lanes, and u16 pairs: acc0 holds cells 4j and 4j + 2, acc1
  // 4j + 1 and 4j + 3
  uint32_t a8 = 0, acc0 = 0, acc1 = 0;
  // lane l holds the offset of the batch's feature l
  int mine = offset_of(lane);
  for (int b = 0, batch = 1; b < f; b += kFineBatch, ++batch) {
    const int next = offset_of(b + kFineBatch + lane);
    const int nb = min(kFineBatch, f - b);
    // the slice's features of the batch: all loads first, then the adds
    uint32_t w[kPer], sh[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int at = base + __shfl_sync(0xffffffffu, mine, s + S * i);
      sh[i] = (at & 3) << 3;
      w[i] = __ldg(words + min((at >> 2) - ((at & 3) <= slack), last_word));
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      // the row's next word is the next lane's
      const uint32_t hi = __shfl_down_sync(0xffffffffu, w[i], 1);
      if (adds && s + S * i < nb) a8 += __funnelshift_r(w[i], hi, sh[i]);
    }
    if (batch % kFlushBatches == 0 || b + kFineBatch >= f) {
      acc0 += a8 & 0x00FF00FFu;
      acc1 += (a8 >> 8) & 0x00FF00FFu;
      a8 = 0;
    }
    mine = next;
  }
  // the S slices of a row and word are lanes L * kRows apart
#pragma unroll
  for (int m = 1; m < S; m <<= 1) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, m * L * kRows);
    acc1 += __shfl_xor_sync(0xffffffffu, acc1, m * L * kRows);
  }
  if (s != 0 || !adds) return;
  int32_t* o = out + (static_cast<size_t>(c) * win + dy) * win + 4 * j;
  const int32_t cell[4] = {static_cast<int32_t>(acc0 & 0xFFFFu),
                           static_cast<int32_t>(acc1 & 0xFFFFu),
                           static_cast<int32_t>(acc0 >> 16),
                           static_cast<int32_t>(acc1 >> 16)};
  if ((win & 3) == 0) {  // o is 16-byte aligned
    *reinterpret_cast<int4*>(o) = make_int4(cell[0], cell[1], cell[2], cell[3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (4 * j + m < win) o[m] = cell[m];
    }
  }
}

// The geometry from the wrapper's plan, its dynamic shared memory in bytes,
// or 0 for a geometry the kernel's constants do not cover.
size_t coarse_smem(const int* g, int rows, int stride, int ch, int cw, int f,
                   const void* planes, bool scores) {
  const Geometry geo{g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
  const size_t buf = sizeof(uint32_t) * static_cast<size_t>(geo.chunk_planes) *
                     geo.stage_rows * geo.pitch;
  if (geo.stage_rows > rows || buf > kStageBytes || 32 * geo.row_bands < ch ||
      8 * kItems * geo.col_bands < cw ||
      geo.chunks * geo.chunk_planes < geo.n_planes || f > 8192 || stride % 16 ||
      reinterpret_cast<uintptr_t>(planes) % 16) {
    return 0;
  }
  return scores ? std::max(buf, sizeof(uint4) * kPartItems) : buf;
}

cudaLaunchConfig_t scores_config(int blocks, size_t smem, int split,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a geometry the kernel's constants do not cover.
// geometry: {n_planes, stage_rows, pitch, chunk_planes, chunks, row_bands,
// col_bands}, from the wrapper's plan.

// out: int32 [n, ch, cw]; split: blocks a group, 1..kMaxSplit (a cluster).
extern "C" int coarse_scores(const void* planes, int rows, int stride,
                             const void* feat, const void* starts, int n,
                             int f, int ch, int cw, const int* geometry,
                             int split, void* out, void* stream) {
  const size_t smem =
      coarse_smem(geometry, rows, stride, ch, cw, f, planes, true);
  if (smem == 0 || split < 1 || split > kMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups =
      geometry[5] * geometry[6] * ((n + kScanUnits - 1) / kScanUnits);
  if (groups == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      scores_config(groups * split, smem, split, &attr, stream);
  const Geometry geo{geometry[0], geometry[1], geometry[2], geometry[3],
                     geometry[4], geometry[5], geometry[6]};
  err = cudaLaunchKernelEx(&cfg, coarse_kernel<true>,
                           static_cast<const uint8_t*>(planes), rows, stride,
                           static_cast<const int32_t*>(feat),
                           static_cast<const int32_t*>(starts),
                           static_cast<const int32_t*>(nullptr), n, f, ch, cw,
                           geo, split, static_cast<int32_t*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// *active: how many clusters of `split` blocks of the scan, each with
// `smem` bytes of dynamic shared memory, the card runs at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int coarse_scores_clusters(int split, int smem, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = scores_config(split, smem, split, &attr, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      active, coarse_kernel<true>, &cfg));
}

// out: int32 [n], holding -1 on entry.
extern "C" int coarse_max(const void* planes, int rows, int stride,
                          const void* feat, const void* starts,
                          const void* lim, int n, int f, int ch, int cw,
                          const int* geometry, void* out, void* stream) {
  const size_t smem =
      coarse_smem(geometry, rows, stride, ch, cw, f, planes, false);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      geometry[5] * geometry[6] * ((n + kMaxUnits - 1) / kMaxUnits);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry geo{geometry[0], geometry[1], geometry[2], geometry[3],
                     geometry[4], geometry[5], geometry[6]};
  coarse_kernel<false><<<blocks, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), rows, stride,
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lim), n, f, ch, cw, geo, 1,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: int32 [k, win, win]; win 1..32; warps: warps a block,
// 1..kFineMaxWarps; lanes_row, slices: the wrapper's layout
// (similarity_cuda.fine_layout), one of the instantiated pairs, with
// ceil(win / 4) + 1 <= lanes_row. The planes' address and stride must be
// multiples of 4 (the word loads), out's of 16 (the 16-byte stores).
extern "C" int fine_scores(const void* planes, int n_planes, int rows,
                           int stride, const void* off3, int f,
                           const void* cand_t, const void* base_yx, int k,
                           int win, int warps, int lanes_row, int slices,
                           void* out, void* stream) {
  if (win < 1 || win > 32 || warps < 1 || warps > kFineMaxWarps || f < 0 ||
      f > kFineMaxFeatures || k < 0 || (win + 3) / 4 + 1 > lanes_row ||
      slices < 1 || 32 % (lanes_row * slices) ||
      stride % 4 ||
      reinterpret_cast<uintptr_t>(planes) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 0) return static_cast<int>(cudaSuccess);
  if (f == 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(int32_t) * static_cast<size_t>(k) * win * win, st));
  }
  const int last_word = static_cast<int>(
      static_cast<int64_t>(n_planes) * rows * (stride / 4) - 1);
  const int slice_rows = 32 / (lanes_row * slices);
  const int64_t grid_warps = static_cast<int64_t>(k) * ((win + slice_rows - 1) / slice_rows);
  const dim3 grid(static_cast<unsigned>((grid_warps + warps - 1) / warps)), block(warps * 32);
  const uint8_t* p = static_cast<const uint8_t*>(planes);
  const int32_t* o3 = static_cast<const int32_t*>(off3);
  const int32_t* ct = static_cast<const int32_t*>(cand_t);
  const int32_t* by = static_cast<const int32_t*>(base_yx);
  int32_t* o = static_cast<int32_t*>(out);
#define FINE_LAUNCH(L, S)                                                  \
  if (lanes_row == L && slices == S) {                                    \
    fine_kernel<L, S><<<grid, block, 0, st>>>(p, rows, stride, last_word, \
                                              o3, f, ct, by, k, win, o);  \
    return static_cast<int>(cudaGetLastError());                          \
  }
  FINE_LAUNCH(2, 16)
  FINE_LAUNCH(2, 8)
  FINE_LAUNCH(4, 2)
  FINE_LAUNCH(4, 1)
  FINE_LAUNCH(8, 1)
  FINE_LAUNCH(16, 1)
#undef FINE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
