// BMP run-length decoding (BI_RLE8, BI_RLE4) into palette indices, the
// host half of the port's BMP reader (linemod_tpu_torch/utils/bmp.py).
// It follows OpenCV's BmpDecoder (imgcodecs grfmt_bmp.cpp) step by step,
// so that what cv2.imread makes of a stream this makes too:
//   - rows are filled in file order (bottom-up), pixels skipped by an
//     end-of-line, a delta or the end-of-bitmap take index 0;
//   - an RLE8 run that ends a row carries on to the next, and an
//     end-of-line straight after it is ignored; an RLE4 run does not;
//   - in RLE4 an end-of-bitmap ends only its row, as an end-of-line does,
//     and a delta moves right by its first byte and ignores its second;
//   - a run or an absolute block that passes its row's end stops the
//     decode (cv2.imread returns nothing), and so does data that ends
//     before the bitmap does.
// Per-pixel and sequential, so it is C++ (g++ -O3 -shared -fPIC at first
// use, bound with ctypes); it allocates nothing.
#include <cstddef>
#include <cstdint>

namespace {

enum { kOk = 0, kPastRow = 1, kTruncated = 2 };

struct Cursor {
  uint8_t* img;
  long w, h;
  long y = 0, data = 0, line_end;

  // FillUniColor: `count` pixels of `v` from the cursor, on to the next
  // rows, stopping at the last.
  void fill(long count, uint8_t v) {
    do {
      long end = data + count;
      if (end > line_end) end = line_end;
      count -= end - data;
      for (; data < end; ++data) img[data] = v;
      if (data >= line_end) {
        line_end += w;
        data = line_end - w;
        if (++y >= h) break;
      }
    } while (count > 0);
  }
};

}  // namespace

extern "C" {

// src: the n bytes of the bitmap's data; bits: 8 (RLE8) or 4 (RLE4); out:
// h x w indices, row 0 the file's first (the image's bottom). Returns 0, 1
// for a run past its row's end, 2 for data that ends too early.
int bmp_rle_decode(const uint8_t* src, long n, int bits, long w, long h, uint8_t* out) {
  Cursor c{out, w, h};
  c.line_end = w;
  for (long i = 0; i < w * h; ++i) out[i] = 0;
  long p = 0;
  int line_end_flag = 0;
  for (;;) {
    if (p + 2 > n) return kTruncated;
    int len = src[p], code = src[p + 1];
    p += 2;
    if (len != 0) {  // encoded run
      if (c.data + len > c.line_end) return kPastRow;
      if (bits == 8) {
        long prev_y = c.y;
        c.fill(len, static_cast<uint8_t>(code));
        line_end_flag = static_cast<int>(c.y - prev_y);
        if (c.y >= h) break;
      } else {
        const uint8_t pair[2] = {static_cast<uint8_t>(code >> 4), static_cast<uint8_t>(code & 15)};
        long end = c.data + len;
        int t = 0;
        do {
          out[c.data] = pair[t];
          t ^= 1;
        } while (++c.data < end);
      }
    } else if (code > 2) {  // absolute block
      if (c.data + code > c.line_end) return kPastRow;
      long size = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      if (p + size > n) return kTruncated;
      for (int i = 0; i < code; ++i)
        out[c.data + i] = bits == 8 ? src[p + i] : (i & 1 ? src[p + i / 2] & 15 : src[p + i / 2] >> 4);
      c.data += code;
      p += size;
      line_end_flag = 0;
    } else if (bits == 4) {  // OpenCV's RLE4: an end of bitmap ends the row only, a delta moves right only
      long count = c.line_end - c.data;
      if (code == 2) {
        if (p + 2 > n) return kTruncated;
        count = src[p];
        p += 2;
      }
      c.fill(count, 0);
      if (c.y >= h) break;
    } else {  // 0: end of line, 1: end of bitmap, 2: delta
      long x_shift = c.line_end - c.data, y_shift = h - c.y;
      if (code || !line_end_flag || x_shift < w) {
        if (code == 2) {
          if (p + 2 > n) return kTruncated;
          x_shift = src[p];
          y_shift = src[p + 1];
          p += 2;
        }
        x_shift += code == 0 ? 0 : y_shift * w;
        if (c.y >= h) break;
        c.fill(x_shift, 0);
        if (c.y >= h) break;
      }
      line_end_flag = 0;
    }
  }
  return kOk;
}

}  // extern "C"
