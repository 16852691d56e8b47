// Baseline, extended sequential and progressive Huffman JPEG decoding
// (SOF0/SOF1/SOF2, 8-bit, 1 or 3 components, any integral sampling factors,
// restart intervals), the host half of the port's JPEG reader
// (linemod_tpu_torch/utils/jpeg.py).
// Its output equals what OpenCV's imread gets from its bundled
// libjpeg-turbo at the library's defaults, bit for bit:
//   - the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) and
//     its post-IDCT range-limit table, indexed by the sample & 1023;
//   - fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
//     their alternating rounding biases and edge columns, h1v2 for 4:4:0,
//     replication for the other integral factors and for chroma planes
//     two samples wide or less; the context row above the first row and
//     below the last is that row itself (jdmainct.c);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16);
//   - gray output of a YCbCr file is its Y plane;
//   - progressive scans as jdphuff.c decodes them (DC first and refine, AC
//     first with end-of-band runs, AC refine with its correction bits; the
//     run is reset at each restart marker), their spectral selection and
//     successive approximation checked as jdphuff.c checks them (a scan
//     that breaks the rules, which libjpeg only warns of, is refused);
//   - each component dequantized with the table in force at its first scan
//     (jdinput.c latch_quant_tables), so a DQT between scans changes only
//     the components that have not been scanned yet.
// A progressive file whose scans leave bits of one of the first ten AC
// coefficients (zigzag 1-9) unsent is refused: libjpeg-turbo smooths such
// blocks (jdcoefct.c decompress_smooth_data), which this does not.
// Huffman decoding is sequential, so it stays on the host. Arithmetic-
// coded, lossless, hierarchical and 12-bit files, CMYK and RGB-coded
// (Adobe transform 0) files are refused with a message, and so is a scan
// whose data ends before its last MCU: no call returns an image that
// differs from OpenCV's.
//
// Built with g++ -O3 -shared -fPIC at first use and bound with ctypes.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                         12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                         35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                         58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  int lookup[512];  // 9-bit prefix -> (length << 8) | value, or -1
};

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int dw, dh;              // downsampled width and height (samples)
  int bw, bh;              // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int pred = 0;
  bool latched = false;  // its quantization table, copied at its first scan
  uint16_t q[64] = {};
  int coef_bits[64];  // progressive: the last successive-approximation bit sent, -1 for none
};

// One scan's spectral selection and successive approximation.
struct Scan {
  int ss = 0, se = 63, ah = 0, al = 0;
  bool progressive = false;
  int eobrun = 0;
};

struct Frame {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool have_frame = false;
  bool progressive = false;
};

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>(p[0] << 8 | p[1]); }

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  t.defined = true;
  std::memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valptr[len] = k;
    t.mincode[len] = code;
    code += counts[len - 1];
    k += counts[len - 1];
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  for (int i = 0; i < 512; ++i) t.lookup[i] = -1;
  code = 0;
  k = 0;
  for (int len = 1; len <= 9; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      int shift = 9 - len;
      for (int j = 0; j < (1 << shift); ++j) t.lookup[(code << shift) | j] = (len << 8) | vals[k];
    }
    code <<= 1;
  }
}

// One restart interval's entropy-coded bytes, with the 0xFF00 stuffing
// removed. Reading past the end yields zero bits and marks an overrun.
struct BitReader {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;
  bool overrun = false;

  void fill() {
    while (cnt <= 56) {
      uint8_t b = 0;
      if (pos < n) b = p[pos];
      else overrun = true;
      ++pos;
      acc |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int k) {
    if (cnt < k) fill();
    return static_cast<int>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // Bits consumed beyond the data: a truncated scan.
  bool past_end() const { return overrun && (pos - n) * 8 > static_cast<size_t>(cnt); }
};

int decode_symbol(BitReader& br, const Huffman& t) {
  int look = br.peek(9);
  int e = t.lookup[look];
  if (e >= 0) {
    br.skip(e >> 8);
    return e & 255;
  }
  int code = br.get(1);
  int len = 1;
  while (code > t.maxcode[len]) {
    code = (code << 1) | br.get(1);
    if (++len > 16) throw Error{"corrupt Huffman data (bad code)"};
  }
  return t.vals[t.valptr[len] + code - t.mincode[len]];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

void decode_block(BitReader& br, Component& c, const Frame& f, int16_t* blk) {
  const Huffman& dct = f.dc[c.td];
  const Huffman& act = f.ac[c.ta];
  int s = decode_symbol(br, dct);
  if (s > 11) throw Error{"corrupt Huffman data (DC magnitude)"};
  int diff = s ? extend(br.get(s), s) : 0;
  c.pred += diff;
  blk[0] = static_cast<int16_t>(c.pred);
  for (int k = 1; k < 64;) {
    int rs = decode_symbol(br, act);
    int r = rs >> 4, ss = rs & 15;
    if (ss == 0) {
      if (r != 15) break;
      k += 16;
      continue;
    }
    k += r;
    if (k > 63) throw Error{"corrupt Huffman data (coefficient index)"};
    blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(ss), ss));
    ++k;
  }
}

// jdphuff.c decode_mcu_DC_first / _DC_refine
void decode_dc_first(BitReader& br, Component& c, const Frame& f, int16_t* blk, int al) {
  int s = decode_symbol(br, f.dc[c.td]);
  if (s > 15) throw Error{"corrupt Huffman data (DC magnitude)"};
  c.pred += s ? extend(br.get(s), s) : 0;
  blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
}

void decode_dc_refine(BitReader& br, int16_t* blk, int al) {
  if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

// jdphuff.c decode_mcu_AC_first: one block's band, or one block of an
// end-of-band run
void decode_ac_first(BitReader& br, const Component& c, const Frame& f, int16_t* blk, Scan& sc) {
  if (sc.eobrun > 0) {
    --sc.eobrun;
    return;
  }
  const Huffman& t = f.ac[c.ta];
  for (int k = sc.ss; k <= sc.se; ++k) {
    int rs = decode_symbol(br, t);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > sc.se) throw Error{"corrupt Huffman data (coefficient index)"};
      blk[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << sc.al);
    } else if (r == 15) {
      k += 15;
    } else {
      sc.eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
      break;
    }
  }
}

// A correction bit for an already nonzero coefficient: 1 raises its
// magnitude by the bit being refined.
inline void correct(BitReader& br, int16_t& coef, int p1) {
  if (br.get(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef - p1);
}

// jdphuff.c decode_mcu_AC_refine
void decode_ac_refine(BitReader& br, const Component& c, const Frame& f, int16_t* blk, Scan& sc) {
  const int p1 = 1 << sc.al;
  int k = sc.ss;
  if (sc.eobrun == 0) {
    const Huffman& t = f.ac[c.ta];
    for (; k <= sc.se; ++k) {
      int rs = decode_symbol(br, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) throw Error{"corrupt Huffman data (refinement of more than one bit)"};
        s = br.get(1) ? p1 : -p1;
      } else if (r != 15) {
        sc.eobrun = (1 << r) + (r ? br.get(r) : 0);
        break;
      }
      // pass the nonzero coefficients (correcting each) and r zero ones
      do {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) {
          correct(br, coef, p1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) {
        if (k > sc.se) throw Error{"corrupt Huffman data (coefficient index)"};
        blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (sc.eobrun > 0) {  // the rest of the band in an end-of-band run
    for (; k <= sc.se; ++k) {
      int16_t& coef = blk[kZigzag[k]];
      if (coef != 0) correct(br, coef, p1);
    }
    --sc.eobrun;
  }
}

void decode_unit(BitReader& br, Component& c, const Frame& f, int16_t* blk, Scan& sc) {
  if (!sc.progressive) decode_block(br, c, f, blk);
  else if (sc.ss == 0 && sc.ah == 0) decode_dc_first(br, c, f, blk, sc.al);
  else if (sc.ss == 0) decode_dc_refine(br, blk, sc.al);
  else if (sc.ah == 0) decode_ac_first(br, c, f, blk, sc);
  else decode_ac_refine(br, c, f, blk, sc);
}

// The entropy-coded segments of a scan starting at data[pos], split at its
// RSTn markers and unstuffed. Returns the position of the marker that ends
// the scan (or n).
size_t scan_segments(const uint8_t* data, size_t n, size_t pos, std::vector<std::vector<uint8_t>>& segs) {
  segs.emplace_back();
  while (pos < n) {
    uint8_t b = data[pos];
    if (b != 0xFF) {
      segs.back().push_back(b);
      ++pos;
      continue;
    }
    if (pos + 1 >= n) return n;
    uint8_t m = data[pos + 1];
    if (m == 0x00) {
      segs.back().push_back(0xFF);
      pos += 2;
    } else if (m == 0xFF) {
      ++pos;  // fill byte
    } else if (m >= 0xD0 && m <= 0xD7) {
      segs.emplace_back();
      pos += 2;
    } else {
      return pos;
    }
  }
  return n;
}

void decode_scan(Frame& f, const uint8_t* data, size_t n, size_t& pos, int ns, Component** sc, Scan& scan) {
  std::vector<std::vector<uint8_t>> segs;
  pos = scan_segments(data, n, pos, segs);
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = f.mcux;
    units_y = f.mcuy;
  }
  long total = static_cast<long>(units_x) * units_y;
  long per = f.restart ? f.restart : total;
  size_t seg = 0;
  long done = 0;
  while (done < total) {
    if (seg >= segs.size()) throw Error{"premature end of data (scan truncated)"};
    BitReader br{segs[seg].data(), segs[seg].size()};
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    scan.eobrun = 0;
    long stop = std::min(total, done + per);
    for (; done < stop; ++done) {
      int ux = static_cast<int>(done % units_x), uy = static_cast<int>(done / units_x);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int y = 0; y < bh; ++y)
          for (int x = 0; x < bw; ++x) {
            int bx = ux * bw + x, by = uy * bh + y;
            decode_unit(br, c, f, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], scan);
          }
      }
      if (br.past_end()) throw Error{"premature end of data (scan truncated)"};
    }
    ++seg;
  }
}

// jidctint.c
const int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
              F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069, F_2_053 = 16819,
              F_2_562 = 20995, F_3_072 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = 128 + i;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = static_cast<uint8_t>(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = kRange.t[static_cast<int>(descale(wp[0], PASS1_BITS + 3)) & 1023];
      for (int i = 0; i < 8; ++i) op[i] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// A component's samples (bw*8 x bh*8, of which dw x dh are real).
std::vector<uint8_t> component_plane(const Component& c, const uint16_t* q) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], q,
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  return plane;
}

// The component upsampled to (at least) W x H; out is W x H.
void upsample(const Component& c, const std::vector<uint8_t>& plane, const Frame& f, uint8_t* out) {
  const int W = f.width, H = f.height, stride = c.bw * 8, dw = c.dw, dh = c.dh;
  const int hx = f.hmax / c.h, vx = f.vmax / c.v;
  auto in = [&](int y, int x) { return static_cast<int>(plane[static_cast<size_t>(y) * stride + x]); };
  std::vector<uint8_t> row(static_cast<size_t>(dw) * hx + 2);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * W;
    if (hx == 1 && vx == 1) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(in(y, x));
    } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
      int r = y;
      row[0] = static_cast<uint8_t>(in(r, 0));
      row[1] = static_cast<uint8_t>((in(r, 0) * 3 + in(r, 1) + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = in(r, x) * 3;
        row[2 * x] = static_cast<uint8_t>((v + in(r, x - 1) + 1) >> 2);
        row[2 * x + 1] = static_cast<uint8_t>((v + in(r, x + 1) + 2) >> 2);
      }
      int last = dw - 1;
      row[2 * last] = static_cast<uint8_t>((in(r, last) * 3 + in(r, last - 1) + 1) >> 2);
      row[2 * last + 1] = static_cast<uint8_t>(in(r, last));
      std::memcpy(o, row.data(), W);
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      int r = y >> 1, v = y & 1;
      int rn = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
      int bias = v == 0 ? 1 : 2;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((in(r, x) * 3 + in(rn, x) + bias) >> 2);
    } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
      int r = y >> 1, v = y & 1;
      int rn = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
      auto colsum = [&](int x) { return in(r, x) * 3 + in(rn, x); };
      int thiscol = colsum(0), nextcol = colsum(1), lastcol;
      row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < dw - 1; ++x) {
        nextcol = colsum(x + 1);
        row[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        row[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      int last = dw - 1;
      row[2 * last] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      row[2 * last + 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      std::memcpy(o, row.data(), W);
    } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
      int r = y / vx;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(in(r, x / hx));
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = static_cast<int>((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                                        // -FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;                             // -FIX(0.34414)
    }
  }
};
const YccTables kYcc;

void ycc_to_bgr(const uint8_t* Y, const uint8_t* Cb, const uint8_t* Cr, size_t n, uint8_t* out) {
  const YccTables& t = kYcc;
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (size_t i = 0; i < n; ++i) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 2] = clamp(y + t.cr_r[cr]);
    out[3 * i + 1] = clamp(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 0] = clamp(y + t.cb_b[cb]);
  }
}

const char* frame_name(int m) {
  switch (m) {
    case 0xC2: return "progressive (SOF2)";
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
  }
  return "unknown";
}

void read_frame_header(Frame& f, const uint8_t* p, int len) {
  if (f.have_frame) throw Error{"more than one frame header"};
  if (len < 6) throw Error{"corrupt frame header"};
  int precision = p[0];
  if (precision != 8) throw Error{std::to_string(precision) + "-bit JPEG (only 8-bit samples are decoded)"};
  f.height = be16(p + 1);
  f.width = be16(p + 3);
  f.ncomp = p[5];
  if (f.width == 0 || f.height == 0) throw Error{"image without a size in the frame header"};
  if (f.ncomp != 1 && f.ncomp != 3)
    throw Error{std::to_string(f.ncomp) + "-component JPEG (only gray and YCbCr are decoded)"};
  if (len < 6 + 3 * f.ncomp) throw Error{"corrupt frame header"};
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Error{"bad sampling factors"};
    f.hmax = std::max(f.hmax, c.h);
    f.vmax = std::max(f.vmax, c.v);
  }
  f.mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
  f.mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    if (f.hmax % c.h || f.vmax % c.v) throw Error{"non-integral sampling factors"};
    c.dw = static_cast<int>((static_cast<long>(f.width) * c.h + f.hmax - 1) / f.hmax);
    c.dh = static_cast<int>((static_cast<long>(f.height) * c.v + f.vmax - 1) / f.vmax);
    c.bw = f.mcux * c.h;
    c.bh = f.mcuy * c.v;
  }
  f.have_frame = true;
}

// A scan header's checks (jdphuff.c start_pass_phuff_decoder, jdhuff.c):
// the tables it needs are defined, its spectral selection and successive
// approximation are legal and continue each component's progression;
// then each component's quantization table is latched at its first scan.
void check_scan(Frame& f, const Scan& sc, int ns, Component** comps) {
  const bool dc_band = sc.ss == 0;
  if (!sc.progressive) {
    if (sc.ss != 0 || sc.se != 63 || sc.ah != 0 || sc.al != 0)
      throw Error{"sequential scan with spectral selection or successive approximation"};
  } else {
    bool bad = dc_band ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || ns != 1);
    if ((sc.ah != 0 && sc.al != sc.ah - 1) || sc.al > 13) bad = true;
    if (bad)
      throw Error{"invalid progressive scan (Ss " + std::to_string(sc.ss) + ", Se " + std::to_string(sc.se) +
                  ", Ah " + std::to_string(sc.ah) + ", Al " + std::to_string(sc.al) + ")"};
  }
  for (int i = 0; i < ns; ++i) {
    Component& c = *comps[i];
    bool needs_dc = !sc.progressive || (dc_band && sc.ah == 0), needs_ac = !sc.progressive || !dc_band;
    if (c.td > 3 || c.ta > 3 || (needs_dc && !f.dc[c.td].defined) || (needs_ac && !f.ac[c.ta].defined))
      throw Error{"scan uses an undefined Huffman table"};
    if (sc.progressive) {
      if (!dc_band && c.coef_bits[0] < 0)
        throw Error{"progressive scan refines AC coefficients before the DC (a bogus progression)"};
      for (int k = sc.ss; k <= sc.se; ++k) {
        if (sc.ah != std::max(c.coef_bits[k], 0))
          throw Error{"progressive scan out of order (a bogus progression)"};
        c.coef_bits[k] = sc.al;
      }
    }
    if (!c.latched) {
      if (!f.qt_defined[c.tq]) throw Error{"component uses an undefined quantization table"};
      std::memcpy(c.q, f.qt[c.tq], sizeof(c.q));
      c.latched = true;
    }
  }
  if (ns > 1) {
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps[i]->h * comps[i]->v;
    if (blocks > 10) throw Error{"too many blocks in an MCU"};
  }
}

// jdcoefct.c smoothing_ok: whether libjpeg-turbo would smooth the blocks
// of this progressive image (every component scanned with its DC known
// and nonzero quantizers at the DC and the first nine AC positions, and
// some of zigzag 1-9 not fully refined in some component).
bool would_smooth(const Frame& f) {
  static const int kPositions[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int i = 0; i < f.ncomp; ++i) {
    const Component& c = f.comp[i];
    if (!c.latched) return false;
    for (int pos : kPositions)
      if (c.q[pos] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// Parse from SOI; stops after the frame header when `decode` is false.
void run(Frame& f, const uint8_t* data, size_t n, bool decode) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Error{"not a JPEG file (no SOI marker)"};
  size_t pos = 2;
  bool any_scan = false;
  while (true) {
    while (pos < n && data[pos] != 0xFF) ++pos;  // skip garbage between segments
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) {
      if (!decode && f.have_frame) return;
      throw Error{"premature end of file (no EOI marker)"};  // cv2.imread refuses it too
    }
    int m = data[pos++];
    if (m == 0xD9) {
      if (!any_scan) throw Error{"no image data before EOI"};
      if (f.progressive && would_smooth(f))
        throw Error{"progressive JPEG whose scans leave low AC coefficients unrefined (libjpeg-turbo's block "
                    "smoothing is not decoded)"};
      return;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (pos + 2 > n) throw Error{"premature end of file"};
    int len = be16(data + pos);
    if (len < 2 || pos + len > n) throw Error{"premature end of file (segment truncated)"};
    const uint8_t* p = data + pos + 2;
    int plen = len - 2;
    pos += len;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_frame_header(f, p, plen);
      f.progressive = m == 0xC2;
      if (f.adobe && f.adobe_transform == 0 && f.ncomp == 3)
        throw Error{"RGB-coded JPEG (Adobe transform 0) is not decoded"};
      if (!f.jfif && !f.adobe && f.ncomp == 3 && f.comp[0].id == 'R' && f.comp[1].id == 'G' && f.comp[2].id == 'B')
        throw Error{"RGB-coded JPEG is not decoded"};
      if (!decode) return;
      for (int i = 0; i < f.ncomp; ++i) {
        f.comp[i].coef.assign(static_cast<size_t>(f.comp[i].bw) * f.comp[i].bh * 64, 0);
        std::fill(f.comp[i].coef_bits, f.comp[i].coef_bits + 64, -1);
      }
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      throw Error{std::string(frame_name(m)) + " JPEG is not decoded (baseline, extended sequential and "
                  "progressive Huffman only)"};
    } else if (m == 0xC4) {  // DHT
      int k = 0;
      while (k < plen) {
        if (k + 17 > plen) throw Error{"corrupt Huffman table"};
        int tc = p[k] >> 4, th = p[k] & 15;
        if (tc > 1 || th > 3) throw Error{"corrupt Huffman table"};
        int total = 0;
        for (int i = 0; i < 16; ++i) total += p[k + 1 + i];
        if (total > 256 || k + 17 + total > plen) throw Error{"corrupt Huffman table"};
        build_huffman(tc ? f.ac[th] : f.dc[th], p + k + 1, p + k + 17, total);
        k += 17 + total;
      }
    } else if (m == 0xDB) {  // DQT
      int k = 0;
      while (k < plen) {
        int pq = p[k] >> 4, tq = p[k] & 15;
        if (tq > 3 || pq > 1 || k + 1 + 64 * (pq + 1) > plen) throw Error{"corrupt quantization table"};
        for (int i = 0; i < 64; ++i)
          f.qt[tq][kZigzag[i]] = pq ? be16(p + k + 1 + 2 * i) : p[k + 1 + i];
        f.qt_defined[tq] = true;
        k += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {  // DRI
      if (plen < 2) throw Error{"corrupt restart interval"};
      f.restart = be16(p);
    } else if (m == 0xE0) {
      if (plen >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) f.jfif = true;
    } else if (m == 0xEE) {
      if (plen >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        f.adobe = true;
        f.adobe_transform = p[11];
      }
    } else if (m == 0xDA) {  // SOS
      if (!f.have_frame) throw Error{"scan before the frame header"};
      int ns = p[0];
      if (ns < 1 || ns > f.ncomp || plen < 1 + 2 * ns + 3) throw Error{"corrupt scan header"};
      Component* sc[3];
      for (int i = 0; i < ns; ++i) {
        int id = p[1 + 2 * i], t = p[2 + 2 * i];
        sc[i] = nullptr;
        for (int j = 0; j < f.ncomp; ++j)
          if (f.comp[j].id == id) sc[i] = &f.comp[j];
        if (!sc[i]) throw Error{"scan names an unknown component"};
        sc[i]->td = t >> 4;
        sc[i]->ta = t & 15;
      }
      Scan scan;
      scan.progressive = f.progressive;
      scan.ss = p[1 + 2 * ns];
      scan.se = p[2 + 2 * ns];
      scan.ah = p[3 + 2 * ns] >> 4;
      scan.al = p[3 + 2 * ns] & 15;
      check_scan(f, scan, ns, sc);
      decode_scan(f, data, n, pos, ns, sc, scan);
      any_scan = true;
    }
  }
}

void report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
}

}  // namespace

extern "C" {

// info: (height, width, components). Reads up to the frame header. Returns
// 0, or -1 with a message in err.
int jpeg_header(const uint8_t* data, long n, int* info, char* err, int errlen) {
  try {
    Frame f;
    run(f, data, static_cast<size_t>(n), false);
    if (!f.have_frame) throw Error{"no frame header"};
    info[0] = f.height;
    info[1] = f.width;
    info[2] = f.ncomp;
    return 0;
  } catch (const Error& e) {
    report(e, err, errlen);
    return -1;
  } catch (const std::exception& e) {
    report(Error{e.what()}, err, errlen);
    return -1;
  }
}

// gray: out is height x width (the Y plane); else height x width x 3 BGR.
// Returns 0, or -1 with a message in err.
int jpeg_decode(const uint8_t* data, long n, int gray, uint8_t* out, char* err, int errlen) {
  try {
    Frame f;
    run(f, data, static_cast<size_t>(n), true);
    if (!f.have_frame) throw Error{"no frame header"};
    const size_t px = static_cast<size_t>(f.width) * f.height;
    std::vector<uint8_t> planes[3];
    int needed = (gray || f.ncomp == 1) ? 1 : 3;
    for (int i = 0; i < needed; ++i) {
      std::vector<uint8_t> plane = component_plane(f.comp[i], f.comp[i].q);
      planes[i].resize(px);
      upsample(f.comp[i], plane, f, planes[i].data());
    }
    if (gray) {
      std::memcpy(out, planes[0].data(), px);
    } else if (f.ncomp == 1) {
      for (size_t i = 0; i < px; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[0][i];
    } else {
      ycc_to_bgr(planes[0].data(), planes[1].data(), planes[2].data(), px, out);
    }
    return 0;
  } catch (const Error& e) {
    report(e, err, errlen);
    return -1;
  } catch (const std::exception& e) {
    report(Error{e.what()}, err, errlen);
    return -1;
  }
}

}  // extern "C"
