// TIFF strip decoding: LZW (compression 5), PackBits (32773), the
// horizontal predictor (Predictor 2) and the floating-point one (3), the host half of the port's TIFF
// reader (linemod_tpu_torch/utils/tiff.py; Deflate strips are inflated by
// Python's zlib there). Each is libtiff's (tif_lzw.c, tif_packbits.c,
// tif_predict.c) for a conforming strip:
//   - LZW: codes of 9 to 12 bits, most significant bit first, ClearCode
//     256 and EndOfInformation 257, the code width growing one code early
//     (at 511, 1023 and 2047) as TIFF's LZW does; the old-style
//     (LSB-first) variant is refused;
//   - PackBits: n in 0..127 copies n + 1 bytes, -127..-1 repeats the next
//     byte 1 - n times, -128 is skipped;
//   - the horizontal predictor adds each sample to the one a pixel before
//     it in its row, modulo 2^8 or 2^16, on samples already in host byte
//     order; the floating-point one sums bytes and then regathers them.
// A strip that decodes to fewer bytes than its rows need is an error, as
// it is to libtiff. Sequential, so it is C++ (g++ -O3 -shared -fPIC at
// first use, bound with ctypes); it allocates only the LZW table.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

enum { kOk = 0, kShort = 1, kCorrupt = 2, kOldStyle = 3 };

struct Entry {
  int prefix;     // previous entry, -1 for a root
  uint8_t first;  // the string's first byte
  uint8_t last;   // its last byte
  int length;
};

}  // namespace

extern "C" {

// LZW strip src[0:n] -> out[0:want]. Returns 0, 1 when the codes end
// before `want` bytes, 2 for a bad code, 3 for old-style LZW.
int tiff_lzw_decode(const uint8_t* src, long n, uint8_t* out, long want) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return kOldStyle;
  std::vector<Entry> table(4096);
  for (int i = 0; i < 256; ++i) table[i] = {-1, static_cast<uint8_t>(i), static_cast<uint8_t>(i), 1};
  long bitpos = 0, nbits = 8L * n, got = 0;
  int width = 9, next = 258, prev = -1;
  auto read = [&]() -> int {
    if (bitpos + width > nbits) return 257;  // out of data: as an EndOfInformation
    int v = 0;
    for (int i = 0; i < width; ++i, ++bitpos) v = (v << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto emit = [&](int code) {  // write entry `code`'s string, cut at `want`
    int len = table[code].length;
    long start = got;
    got += len;
    for (int c = code, k = len - 1; c >= 0; c = table[c].prefix, --k)
      if (start + k < want) out[start + k] = table[c].last;
  };
  while (got < want) {
    int code = read();
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (code > next || (prev < 0 && code > 255)) return kCorrupt;
    if (prev >= 0 && next < 4096) {
      uint8_t first = code < next ? table[code].first : table[prev].first;
      table[next] = {prev, table[prev].first, first, table[prev].length + 1};
      ++next;
    }
    emit(code);
    prev = code;
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  return got >= want ? kOk : kShort;
}

// PackBits strip src[0:n] -> out[0:want]. Returns 0 or 1 (too short).
int tiff_packbits_decode(const uint8_t* src, long n, uint8_t* out, long want) {
  long p = 0, got = 0;
  while (got < want && p < n) {
    int c = static_cast<int8_t>(src[p++]);
    if (c >= 0) {
      for (int i = 0; i <= c && p < n; ++i, ++p)
        if (got < want) out[got++] = src[p];
    } else if (c != -128) {
      if (p >= n) break;
      uint8_t v = src[p++];
      for (int i = 0; i < 1 - c; ++i)
        if (got < want) out[got++] = v;
    }
  }
  return got >= want ? kOk : kShort;
}

// Undo Predictor 2 in place on rows x cols samples (cols = width x samples
// a pixel) of `bytes` (1 or 2) bytes each, `stride` samples a pixel.
void tiff_unpredict(void* data, long rows, long cols, int stride, int bytes) {
  for (long y = 0; y < rows; ++y) {
    if (bytes == 1) {
      uint8_t* row = static_cast<uint8_t*>(data) + y * cols;
      for (long i = stride; i < cols; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else {
      uint16_t* row = static_cast<uint16_t*>(data) + y * cols;
      for (long i = stride; i < cols; ++i) row[i] = static_cast<uint16_t>(row[i] + row[i - stride]);
    }
  }
}

// Undo Predictor 3 (floating point) in place on rows x cols 4-byte samples
// as stored: each row's bytes summed `stride` bytes apart, then gathered
// from its four byte planes (most significant first) into big-endian
// samples, as libtiff's fpAcc does whatever the file's byte order.
void tiff_unpredict_float(uint8_t* data, long rows, long cols, int stride) {
  const long n = cols * 4;
  std::vector<uint8_t> planes(n);
  for (long y = 0; y < rows; ++y) {
    uint8_t* row = data + y * n;
    for (long i = stride; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    std::copy(row, row + n, planes.begin());
    for (long c = 0; c < cols; ++c)
      for (int b = 0; b < 4; ++b) row[4 * c + b] = planes[b * cols + c];
  }
}

}  // extern "C"
