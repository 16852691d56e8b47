// Host-side gradient quantization, the port's own copy of the reference's
// native/quantize.cpp (linemod_tpu_torch/utils/native.py binds it).
//
// cv::linemod::ColorGradient semantics, as ops/gradients.py computes them
// on the device: 7x7 Gaussian presmooth, Sobel, strongest color channel,
// orientation folded to 180 deg in 8 bins, 3x3 neighborhood vote >= 5,
// weak-threshold gate, in float32. The host-quantize route uploads the two
// u8 orientation maps it makes (384 KB at 640x480) in place of the BGR
// frame (921 KB) and starts the device program at the response planes.
//
// Built at first use by g++ with the reference's flags, -O3 -std=c++17
// -fPIC -Wall -pthread -fopenmp (native/Makefile), and nothing else: a
// -march that offers FMA, -ffast-math or -ffp-contract would let the
// compiler fuse `out[x] += p[x] * kv` and the squared magnitudes, which
// changes bits. Every loop writes each output element from its own inputs
// only, so OpenMP's thread count cannot change a result.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kWeakThreshold = 10.0f;   // ops/gradients.py WEAK_THRESHOLD
constexpr int kNeighborVotes = 5;

// OpenCV getGaussianKernel default sigma for ksize=7 (gradients.py:31-36)
void gaussian7(float* k) {
  const float sigma = 0.3f * ((7 - 1) * 0.5f - 1.0f) + 0.8f;
  float sum = 0.0f;
  for (int i = 0; i < 7; ++i) {
    float x = static_cast<float>(i) - 3.0f;
    k[i] = std::exp(-(x * x) / (2.0f * sigma * sigma));
    sum += k[i];
  }
  for (int i = 0; i < 7; ++i) k[i] /= sum;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// separable 2-D convolution with replicate padding on [h, w, 3] f32,
// matching gradients.py _sep_conv2d (horizontal over the row-padded image,
// then vertical), with identical accumulation order (ascending tap index).
// Written as branch-free row passes over contiguous w*3 spans so the
// compiler auto-vectorizes (the per-pixel clamped version ran ~5x slower).
void sep_conv3(const float* src, int h, int w, const float* kx, int nx,
               const float* ky, int ny, float* dst, float* tmp,
               float* padrow_storage) {
  const int rx = nx / 2;
  const int ry = ny / 2;
  const int wc = w * 3;
  const int pwc = (w + 2 * rx) * 3;
  // horizontal pass into tmp[(h + 2*ry) x w x 3]
#pragma omp parallel for schedule(static)
  for (int y = -ry; y < h + ry; ++y) {
    const float* row = src + static_cast<size_t>(clampi(y, 0, h - 1)) * wc;
    // edge-replicated padded copy of this row (per-thread scratch slot)
    float* pad = padrow_storage + static_cast<size_t>(y + ry) * pwc;
    for (int i = 0; i < rx; ++i) {
      pad[i * 3 + 0] = row[0];
      pad[i * 3 + 1] = row[1];
      pad[i * 3 + 2] = row[2];
      pad[(w + rx + i) * 3 + 0] = row[wc - 3];
      pad[(w + rx + i) * 3 + 1] = row[wc - 2];
      pad[(w + rx + i) * 3 + 2] = row[wc - 1];
    }
    std::memcpy(pad + rx * 3, row, sizeof(float) * wc);
    float* out = tmp + static_cast<size_t>(y + ry) * wc;
    bool first = true;
    for (int i = 0; i < nx; ++i) {
      const float kv = kx[i];
      if (kv == 0.0f) continue;
      const float* p = pad + i * 3;
      if (first) {
        for (int x = 0; x < wc; ++x) out[x] = p[x] * kv;
        first = false;
      } else {
        for (int x = 0; x < wc; ++x) out[x] += p[x] * kv;
      }
    }
  }
  // vertical pass tmp -> dst (contiguous row axpy)
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    float* out = dst + static_cast<size_t>(y) * wc;
    bool first = true;
    for (int j = 0; j < ny; ++j) {
      const float kv = ky[j];
      if (kv == 0.0f) continue;
      const float* p = tmp + static_cast<size_t>(y + j) * wc;
      if (first) {
        for (int x = 0; x < wc; ++x) out[x] = p[x] * kv;
        first = false;
      } else {
        for (int x = 0; x < wc; ++x) out[x] += p[x] * kv;
      }
    }
  }
}

// quantize one [h, w, 3] f32 image to the one-hot orientation map
void quantize_f32(const float* img, int h, int w, uint8_t* quant) {
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<float> sm(n * 3), tmp((static_cast<size_t>(h) + 6) * w * 3);
  std::vector<float> pads((static_cast<size_t>(h) + 6) * (w + 6) * 3);
  std::vector<float> dx(n * 3), dy(n * 3);
  float g[7];
  gaussian7(g);
  sep_conv3(img, h, w, g, 7, g, 7, sm.data(), tmp.data(), pads.data());
  const float sx[3] = {-1.0f, 0.0f, 1.0f};
  const float sy[3] = {1.0f, 2.0f, 1.0f};
  sep_conv3(sm.data(), h, w, sx, 3, sy, 3, dx.data(), tmp.data(), pads.data());
  sep_conv3(sm.data(), h, w, sy, 3, sx, 3, dy.data(), tmp.data(), pads.data());

  std::vector<uint8_t> bin8(n);
  std::vector<uint8_t> strong(n);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < static_cast<long>(n); ++i) {
    const float* px = dx.data() + i * 3;
    const float* py = dy.data() + i * 3;
    float m0 = px[0] * px[0] + py[0] * py[0];
    float m1 = px[1] * px[1] + py[1] * py[1];
    float m2 = px[2] * px[2] + py[2] * py[2];
    // argmax with first-max tie-breaking (gradients.py:82-92)
    int c = 0;
    float best = m0;
    if (m1 > best) { c = 1; best = m1; }
    if (m2 > best) { c = 2; best = m2; }
    const float angle = std::atan2(py[c], px[c]);
    // jnp.round = round-half-to-even; rintf honors the default FE mode
    const int b16 = static_cast<int>(std::rint(angle * (16.0f / (2.0f * static_cast<float>(M_PI))))) & 15;
    bin8[i] = static_cast<uint8_t>(b16 & 7);
    strong[i] = best > kWeakThreshold * kWeakThreshold ? 1 : 0;
  }

  // 3x3 neighborhood vote (replicate border), winner = first max
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int hist[8] = {0};
      for (int dy2 = -1; dy2 <= 1; ++dy2) {
        const uint8_t* row =
            bin8.data() + static_cast<size_t>(clampi(y + dy2, 0, h - 1)) * w;
        for (int dx2 = -1; dx2 <= 1; ++dx2) {
          ++hist[row[clampi(x + dx2, 0, w - 1)]];
        }
      }
      int winner = 0, count = hist[0];
      for (int b = 1; b < 8; ++b) {
        if (hist[b] > count) { count = hist[b]; winner = b; }
      }
      const size_t i = static_cast<size_t>(y) * w + x;
      quant[i] = (count >= kNeighborVotes && strong[i])
                     ? static_cast<uint8_t>(1u << winner)
                     : 0;
    }
  }
}

}  // namespace

extern "C" {

// bgr: [h, w, 3] uint8; quant0: [h, w] u8 one-hot orientation map (level 0);
// quant1: [h/2, w/2] u8 (level 1, quantized on the 2x2-average downsample).
void linemod_quantize_frame(const uint8_t* bgr, int w, int h, uint8_t* quant0,
                            uint8_t* quant1) {
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<float> img(n * 3);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < static_cast<long>(n * 3); ++i) {
    img[i] = static_cast<float>(bgr[i]);
  }
  quantize_f32(img.data(), h, w, quant0);

  // 2x2 average downsample (ops/extract.py downsample2) then quantize
  const int h1 = h / 2, w1 = w / 2;
  std::vector<float> img1(static_cast<size_t>(h1) * w1 * 3);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h1; ++y) {
    for (int x = 0; x < w1; ++x) {
      for (int c = 0; c < 3; ++c) {
        const size_t a = (static_cast<size_t>(2 * y) * w + 2 * x) * 3 + c;
        const size_t b = (static_cast<size_t>(2 * y) * w + 2 * x + 1) * 3 + c;
        const size_t d = (static_cast<size_t>(2 * y + 1) * w + 2 * x) * 3 + c;
        const size_t e = (static_cast<size_t>(2 * y + 1) * w + 2 * x + 1) * 3 + c;
        img1[(static_cast<size_t>(y) * w1 + x) * 3 + c] =
            (img[a] + img[b] + img[d] + img[e]) * 0.25f;
      }
    }
  }
  quantize_f32(img1.data(), h1, w1, quant1);
}

}  // extern "C"
