// PNG scanline unfilter (PNG spec section 9), the host half of the port's
// PNG reader (linemod_tpu_torch/utils/png.py): the port's own copy of the
// unfilter loop of native/loader.cpp, over the bytes Python's zlib
// inflated. Built with g++ -O3 -shared -fPIC at first use and bound with
// ctypes (utils/png.py); it allocates nothing and touches no Python object.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + row_bytes bytes); out: h x row_bytes.
// bpp: bytes a complete pixel (at least 1). Returns 0, or y + 1 for the
// first row y whose filter type is not 0-4.
int png_unfilter(const uint8_t* raw, int h, int row_bytes, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (row_bytes + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out + static_cast<size_t>(y) * row_bytes;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, row_bytes);
        break;
      case 1:
        for (int x = 0; x < row_bytes; ++x) dst[x] = uint8_t(src[x] + (x >= bpp ? dst[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < row_bytes; ++x) dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + (a + b) / 2);
        }
        break;
      case 4:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          dst[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
