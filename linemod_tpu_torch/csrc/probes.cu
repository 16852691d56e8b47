// The two layout probes of the JAX package, for Hopper (sm_90a).
//
// Replaces the Pallas TPU probe kernels:
//   bitcast_u8_to_i32_kernel,  <- `kernel`, scripts/test_bitcast.py:22-25
//   bitcast_i32_to_u8_kernel      (pltpu.bitcast u8 <-> i32, sublane packing)
//   roll2d_u8_kernel           <- `kernel`, scripts/test_u8_roll.py:26-32
//                                 (pltpu.roll of a u8 block on both axes)
//
// On the TPU they probed how Mosaic lowers a dtype bitcast and a u8 roll. On
// the card each is a plain elementwise copy with an index map:
//   bitcast u8 [4R, C] -> i32 [R, C]: word (r, c) packs rows 4r..4r+3 of
//     column c, row 4r in the least significant byte; i32 -> u8 undoes it;
//   roll2d u8 [H, W] by (sy, sx): out[y, x] = in[(y - sy) mod H, (x - sx) mod W],
//     which is np.roll(np.roll(in, sy, 0), sx, 1).
// One thread per output word or byte, neighbouring threads on neighbouring
// columns, so loads and stores coalesce. They move a few KB and are bound by
// launch latency; no tiling is worth it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bitcast_u8_to_i32_kernel(const uint8_t* __restrict__ x,
                                         int rows4, int cols,
                                         int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows4 * cols) return;
  const int r = i / cols;
  const int c = i - r * cols;
  const uint8_t* p = x + static_cast<size_t>(4 * r) * cols + c;
  const uint32_t w = static_cast<uint32_t>(p[0]) |
                     static_cast<uint32_t>(p[cols]) << 8 |
                     static_cast<uint32_t>(p[2 * cols]) << 16 |
                     static_cast<uint32_t>(p[3 * cols]) << 24;
  out[i] = static_cast<int32_t>(w);
}

__global__ void bitcast_i32_to_u8_kernel(const int32_t* __restrict__ w,
                                         int rows4, int cols,
                                         uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows4 * cols) return;
  const int r = i / cols;
  const int c = i - r * cols;
  const uint32_t v = static_cast<uint32_t>(w[i]);
  uint8_t* p = out + static_cast<size_t>(4 * r) * cols + c;
  p[0] = static_cast<uint8_t>(v);
  p[cols] = static_cast<uint8_t>(v >> 8);
  p[2 * cols] = static_cast<uint8_t>(v >> 16);
  p[3 * cols] = static_cast<uint8_t>(v >> 24);
}

// sy in [0, h), sx in [0, w)
__global__ void roll2d_u8_kernel(const uint8_t* __restrict__ x, int h, int w,
                                 int sy, int sx, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w;
  const int c = i - y * w;
  const int ys = y >= sy ? y - sy : y - sy + h;
  const int cs = c >= sx ? c - sx : c - sx + w;
  out[i] = x[static_cast<size_t>(ys) * w + cs];
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int bitcast_u8_to_i32(const void* x, int rows4, int cols, void* out,
                                 void* stream) {
  bitcast_u8_to_i32_kernel<<<blocks(rows4 * cols), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), rows4, cols, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitcast_i32_to_u8(const void* w, int rows4, int cols, void* out,
                                 void* stream) {
  bitcast_i32_to_u8_kernel<<<blocks(rows4 * cols), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), rows4, cols, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int roll2d_u8(const void* x, int h, int w, int sy, int sx, void* out,
                         void* stream) {
  roll2d_u8_kernel<<<blocks(h * w), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), h, w, sy, sx, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
