// LINE-MOD color-gradient quantizer for Hopper (sm_90a): one pyramid level
// of a frame (or of a batch of rendered views) in one launch.
//
// Replaces no Pallas kernel: the JAX reference computes this with XLA
// operations (quantize_color_gradients, linemod_tpu/ops/gradients.py), and
// the port's plain version (quantize_color_gradients_plain,
// linemod_tpu_torch/ops/gradients.py) repeats them, ~800 launches a level
// with each fused multiply-add emulated in float64. This kernel computes the
// same function bit for bit:
//   7x7 Gaussian (row pass, then column pass), both 3x3 Sobels, each
//   channel's squared magnitude, the strongest channel (the first maximum),
//   its orientation by the C library's atan2f, the 8-bin quantization and
//   the 3x3 vote (>= 5 of 9 on one bin, the first maximum) of the pixels
//   whose magnitude passes the weak threshold.
// Given `half`, it quantizes the 2x2-averaged frame instead, reading the
// level-0 color and forming each average as ops/extract.downsample2 does:
// (((a + b) + c) + d) * 0.25 in row-major window order, an odd last row or
// column dropped.
//
// Bit for bit with the plain chain, and through it with XLA's CPU program:
//   - every operation is an explicitly rounded intrinsic, so nvcc's default
//     --fmad=true contracts nothing: __fmaf_rn exactly where XLA fuses a
//     product into a sum (_sum_of_products: the first product rounded on its
//     own, each later one fused; mag2 = fma(dx, dx, dy * dy)), and
//     __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn for each operation of
//     atan2 and _atanf_nonneg, in their order;
//   - subnormal atan2 inputs and quotients are flushed to signed zero
//     explicitly, as XLA's CPU code runs; nothing is built with -ftz or fast
//     math;
//   - round half to even (rintf), then & 15 on the int32; the vote's counts
//     are small integers, exact in any order; ties take the first maximum in
//     the channel pick, the vote's argmax and nowhere else;
//   - replicate padding stage by stage: each stage's out-of-image
//     coordinate is clamped to that stage's own image (the Sobel pads the
//     smoothed image, the vote pads the bins), as each _sep_conv2d call pads
//     its own input. Every buffer below holds, at a position outside the
//     image, the value at the clamped position, and a stage computing
//     position p reads its input around clamp(p).
//
// Bound: bytes. At 640x480 level 0 reads the 3.69 MB color and writes 0.31
// MB of orientations and 1.23 MB of magnitudes: 5.2 MB, 1.6 us at 3.35
// TB/s; level 1 reads the same color and writes a quarter: 1.2 us. The
// arithmetic (~250 float operations a pixel with the halo's share, the
// atan2's divisions, ~0.1 G a 640x480 level) is under 2 us at 67 TFLOP/s.
// Both levels are far below a launch and its round trips, so the kernel is
// launch- and latency-bound. The design:
//   - a block a 32 x 16 output tile (600 blocks at 640x480, 150 at level 1,
//     to fill the 132 SMs) with the batch on blockIdx.z and 64-bit offsets
//     (a 256-view generation chunk of 640x480 is 236 M floats);
//   - the block stages its tile plus a 5-pixel halo (3 for the Gaussian, 1
//     for the Sobel, 1 for the vote), one channel plane after another, in
//     shared memory (33.6 KB with the row-pass, smoothed and bin buffers: 6
//     blocks an SM), and runs each stage over its own region of the halo,
//     a thread a position, with a barrier between stages;
//   - the bins carry the weak-threshold bit, so the vote reads one byte a
//     neighbour and counts in 4-bit fields of one register.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;
constexpr int kTileH = 16;
// each stage's region: the vote reads the bins 1 pixel around the tile, the
// Sobel the smoothed image 1 further, the Gaussian's column pass the row
// pass 3 rows further and its row pass the color 3 columns further
constexpr int kBinW = kTileW + 2;
constexpr int kBinH = kTileH + 2;
constexpr int kSmW = kTileW + 4;
constexpr int kSmH = kTileH + 4;
constexpr int kInW = kTileW + 10;
constexpr int kInH = kTileH + 10;
constexpr int kStrongBit = 8;  // in a bin byte: bits 0-2 the bin
constexpr int kMinVotes = 5;   // ops/gradients.NEIGHBOR_VOTES

// float32 constants as exact hexadecimal literals (tests hold them to
// ops/gradients.py's): the 7-tap Gaussian (OpenCV's sigma for ksize 7),
// fdlibm's atanf breakpoints' values (hi, lo) and polynomial coefficients,
// pi, pi/2, pi's low part, atan2f's tiny, 16 / (2 pi) and FLT_MIN
__constant__ float kGauss[7] = {0x1.db0ef4p-6f, 0x1.a93d6ep-4f, 0x1.c90f1ep-3f, 0x1.26f04cp-2f,
                                0x1.c90f1ep-3f, 0x1.a93d6ep-4f, 0x1.db0ef4p-6f};
__constant__ float kAtanHi[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f, 0x1.f730bcp-1f, 0x1.921fb4p+0f};
__constant__ float kAtanLo[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f, 0x1.281f68p-25f, 0x1.4442d0p-24f};
__constant__ float kAtanOdd[6] = {0x1.555556p-2f, 0x1.24924ap-3f, 0x1.745cdcp-4f,
                                  0x1.10d66ap-4f, 0x1.97b4b2p-5f, 0x1.0ad3aep-6f};
__constant__ float kAtanEven[5] = {-0x1.99999ap-3f, -0x1.c71c70p-4f, -0x1.3b0f2ap-4f,
                                   -0x1.dde2d6p-5f, -0x1.2b4442p-5f};
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kPiO2 = 0x1.921fb6p+0f;
constexpr float kPiLo = -0x1.777a5cp-24f;
constexpr float kTiny = 0x1.4484c0p-100f;
constexpr float kBinScale = 0x1.45f306p+1f;
constexpr float kMinNormal = 0x1p-126f;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kMinNormal ? __fmul_rn(v, 0.0f) : v;
}

// atanf of x >= 0 as the C library computes it (gradients._atanf_nonneg)
__device__ float atanf_nonneg(float x) {
  const int ix = __float_as_int(x);
  if (ix >= 0x4C000000) return __fadd_rn(kAtanHi[3], kAtanLo[3]);
  if (ix < 0x31000000) return x;
  const int idx = (ix >= 0x3EE00000) + (ix >= 0x3F300000) + (ix >= 0x3F980000) +
                  (ix >= 0x401C0000) - 1;
  float xr = x;
  if (idx == 0) {
    xr = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, x), 1.0f), __fadd_rn(2.0f, x));
  } else if (idx == 1) {
    xr = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
  } else if (idx == 2) {
    xr = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
  } else if (idx == 3) {
    xr = __fdiv_rn(-1.0f, x);
  }
  const float z = __fmul_rn(xr, xr);
  const float w = __fmul_rn(z, z);
  float p1 = kAtanOdd[5];
#pragma unroll
  for (int k = 4; k >= 0; --k) p1 = __fadd_rn(__fmul_rn(p1, w), kAtanOdd[k]);
  float p2 = kAtanEven[4];
#pragma unroll
  for (int k = 3; k >= 0; --k) p2 = __fadd_rn(__fmul_rn(p2, w), kAtanEven[k]);
  const float t = __fmul_rn(xr, __fadd_rn(__fmul_rn(z, p1), __fmul_rn(p2, w)));
  if (idx < 0) return __fsub_rn(xr, t);
  return __fsub_rn(kAtanHi[idx], __fsub_rn(__fsub_rn(t, kAtanLo[idx]), xr));
}

// atan2f(y, x) of finite inputs as the C library computes it
// (gradients.atan2), subnormals flushed
__device__ float atan2_libc(float y, float x) {
  x = flush(x);
  y = flush(y);
  const int hx = __float_as_int(x);
  const int hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF;
  const int iy = hy & 0x7FFFFFFF;
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2 * sign(x) + sign(y)
  if (ix == 0 && iy != 0) return hy < 0 ? __fsub_rn(-kPiO2, kTiny) : __fadd_rn(kPiO2, kTiny);
  if (iy == 0) return m <= 1 ? y : (m == 2 ? __fadd_rn(kPi, kTiny) : __fsub_rn(-kPi, kTiny));
  const int k = (iy - ix) >> 23;  // the exponents' difference
  float z;
  if (k > 60) {
    z = __fadd_rn(kPiO2, __fmul_rn(0.5f, kPiLo));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_nonneg(fabsf(flush(__fdiv_rn(y, ix == 0 ? 1.0f : x))));
  }
  if (m == 0) return z;
  if (m == 1) return -z;
  if (m == 2) return __fsub_rn(kPi, __fsub_rn(z, kPiLo));
  return __fsub_rn(__fsub_rn(z, kPiLo), kPi);
}

// src: float32 [B, src_h, src_w, 3]; quant: uint8 [B, h, w]; mag2: float32
// [B, h, w], where (h, w) = (src_h, src_w), or halved when kHalf.
template <bool kHalf>
__global__ void __launch_bounds__(kThreads) gradient_quant_kernel(
    const float* __restrict__ src, int src_h, int src_w, int h, int w, float strong2,
    uint8_t* __restrict__ quant, float* __restrict__ mag2) {
  __shared__ float in[3][kInH][kInW];
  __shared__ float row[3][kInH][kSmW];
  __shared__ float sm[3][kSmH][kSmW];
  __shared__ uint8_t bins[kBinH][kBinW];

  // every stage strides by blockDim.x (kThreads on the card), so the same
  // body run as one thread a block visits every position
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* img = src + static_cast<int64_t>(blockIdx.z) * src_h * src_w * 3;
  const int64_t out0 = static_cast<int64_t>(blockIdx.z) * h * w;

  // the color around the tile, each position clamped to the level's image
  for (int i = tid; i < kInH * kInW; i += blockDim.x) {
    const int ly = i / kInW;
    const int lx = i - ly * kInW;
    const int y = clampi(y0 - 5 + ly, h - 1);
    const int x = clampi(x0 - 5 + lx, w - 1);
    if (kHalf) {
      const float* p = img + (static_cast<int64_t>(2 * y) * src_w + 2 * x) * 3;
      const float* q = p + static_cast<int64_t>(src_w) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float s = __fadd_rn(__fadd_rn(__fadd_rn(p[c], p[3 + c]), q[c]), q[3 + c]);
        in[c][ly][lx] = __fmul_rn(s, 0.25f);
      }
    } else {
      const float* p = img + (static_cast<int64_t>(y) * src_w + x) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) in[c][ly][lx] = p[c];
    }
  }
  __syncthreads();

  // the Gaussian's row pass: every staged row, the smoothed region's columns
  for (int i = tid; i < kInH * kSmW; i += blockDim.x) {
    const int ly = i / kSmW;
    const int lx = i - ly * kSmW;
    const int cx = clampi(x0 - 2 + lx, w - 1) - x0 + 2;  // tap i reads column cx + i
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* v = &in[c][ly][cx];
      float acc = __fmaf_rn(v[0], kGauss[0], __fmul_rn(v[1], kGauss[1]));
#pragma unroll
      for (int k = 2; k < 7; ++k) acc = __fmaf_rn(v[k], kGauss[k], acc);
      row[c][ly][lx] = acc;
    }
  }
  __syncthreads();

  // its column pass
  for (int i = tid; i < kSmH * kSmW; i += blockDim.x) {
    const int ly = i / kSmW;
    const int lx = i - ly * kSmW;
    const int cy = clampi(y0 - 2 + ly, h - 1) - y0 + 2;  // tap j reads row cy + j
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = __fmaf_rn(row[c][cy][lx], kGauss[0], __fmul_rn(row[c][cy + 1][lx], kGauss[1]));
#pragma unroll
      for (int k = 2; k < 7; ++k) acc = __fmaf_rn(row[c][cy + k][lx], kGauss[k], acc);
      sm[c][ly][lx] = acc;
    }
  }
  __syncthreads();

  // Sobels, magnitudes, the strongest channel, its bin and weak-threshold
  // bit; the tile's own positions write their magnitude
  for (int i = tid; i < kBinH * kBinW; i += blockDim.x) {
    const int ly = i / kBinW;
    const int lx = i - ly * kBinW;
    const int y = y0 - 1 + ly;
    const int x = x0 - 1 + lx;
    const int cy = clampi(y, h - 1) - y0 + 1;  // the 3x3 window's first row and column
    const int cx = clampi(x, w - 1) - x0 + 1;
    float best_dx = 0.0f, best_dy = 0.0f, best = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a[3], b[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* s = &sm[c][cy + r][cx];
        a[r] = __fmaf_rn(s[0], -1.0f, __fmul_rn(s[2], 1.0f));                // [-1, 0, 1]
        b[r] = __fmaf_rn(s[2], 1.0f, __fmaf_rn(s[0], 1.0f, __fmul_rn(s[1], 2.0f)));  // [1, 2, 1]
      }
      const float dx = __fmaf_rn(a[2], 1.0f, __fmaf_rn(a[0], 1.0f, __fmul_rn(a[1], 2.0f)));
      const float dy = __fmaf_rn(b[0], -1.0f, __fmul_rn(b[2], 1.0f));
      const float m2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
      if (c == 0 || m2 > best) {  // strict: the first maximum wins ties
        best = m2;
        best_dx = dx;
        best_dy = dy;
      }
    }
    const float angle = atan2_libc(best_dy, best_dx);
    const int bin = (static_cast<int>(rintf(__fmul_rn(angle, kBinScale))) & 15) & 7;
    bins[ly][lx] = static_cast<uint8_t>(bin | (best > strong2 ? kStrongBit : 0));
    if (ly >= 1 && ly <= kTileH && lx >= 1 && lx <= kTileW && y < h && x < w) {
      mag2[out0 + static_cast<int64_t>(y) * w + x] = best;
    }
  }
  __syncthreads();

  // the 3x3 vote over the bins, counted in 4-bit fields (at most 9)
  for (int i = tid; i < kTileH * kTileW; i += blockDim.x) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= h || x >= w) continue;
    uint32_t counts = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) counts += 1u << (4 * (bins[ty + dy][tx + dx] & 7));
    }
    int most = 0, winner = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = (counts >> (4 * k)) & 15;
      if (n > most) {
        most = n;
        winner = k;
      }
    }
    const bool keep = most >= kMinVotes && (bins[ty + 1][tx + 1] & kStrongBit);
    quant[out0 + static_cast<int64_t>(y) * w + x] = keep ? static_cast<uint8_t>(1u << winner) : 0;
  }
}

}  // namespace

// img: float32 [batch, src_h, src_w, 3] (BGR, contiguous); quant: uint8 and
// mag2: float32 [batch, h, w], (h, w) = (src_h, src_w) or, given half,
// (src_h / 2, src_w / 2). strong2: the weak threshold squared.
extern "C" int gradient_quant(const void* img, int batch, int src_h, int src_w, int half,
                              float strong2, void* quant, void* mag2, void* stream) {
  const int h = half ? src_h / 2 : src_h;
  const int w = half ? src_w / 2 : src_w;
  if (batch < 1 || batch > 65535 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(img);
  uint8_t* q = static_cast<uint8_t*>(quant);
  float* m = static_cast<float*>(mag2);
  if (half) {
    gradient_quant_kernel<true><<<grid, kThreads, 0, s>>>(src, src_h, src_w, h, w, strong2, q, m);
  } else {
    gradient_quant_kernel<false><<<grid, kThreads, 0, s>>>(src, src_h, src_w, h, w, strong2, q, m);
  }
  return static_cast<int>(cudaGetLastError());
}
