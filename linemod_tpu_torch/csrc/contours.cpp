// Contours of a binary image and the square-candidate filter of the ArUco
// detector, the host half of linemod_tpu_torch/ops/aruco.py. Each function
// reproduces OpenCV's, point for point:
//   - find_contours: cv::findContours(RETR_LIST, CHAIN_APPROX_NONE), the
//     Suzuki-Abe border following of imgproc/contours.cpp on the image
//     framed by one row and column of zeros: every outer and hole border,
//     each starting where the raster scan meets it and followed in
//     OpenCV's direction, listed in the reverse of the order they were met;
//   - approx_poly_dp: cv::approxPolyDP on a closed curve (Douglas-Peucker
//     with OpenCV's choice of the first split and its clean-up pass);
//   - is_contour_convex: cv::isContourConvex on integer points;
//   - marker_contours: _findMarkerContours of objdetect/aruco_detector.cpp
//     (perimeter range, a convex quadrilateral, corner spacing, distance to
//     the border) over one thresholded map.
// Results are handed to Python through an opaque list of int sequences.
// Built with g++ -O3 -shared -fPIC at first use and bound with ctypes.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  int x, y;
};

using Seq = std::vector<int>;  // x0, y0, x1, y1, ...

struct Result {
  std::vector<Seq> seqs;
};

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// icvFetchContour with CHAIN_APPROX_NONE. img: the framed image (values
// 0, 1 and the marks 2 / -126); i0: the start pixel; pt: its point in
// image coordinates.
void fetch_contour(int8_t* img, long step, long i0, Pt pt, bool hole, Seq& out) {
  const int8_t nbd = 2;
  long deltas[16];
  for (int k = 0; k < 8; ++k) deltas[k] = deltas[k + 8] = kDx[k] + kDy[k] * step;
  int s, s_end;
  s_end = s = hole ? 0 : 4;
  long i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (img[i1] == 0 && s != s_end);
  if (s == s_end) {  // a single pixel
    img[i0] = static_cast<int8_t>(nbd | -128);
    out.push_back(pt.x);
    out.push_back(pt.y);
    return;
  }
  long i3 = i0, i4 = 0;
  for (;;) {
    s_end = s;
    s = std::min(s, 15);
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (img[i4] != 0) break;
    }
    s &= 7;
    if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
      img[i3] = static_cast<int8_t>(nbd | -128);
    } else if (img[i3] == 1) {
      img[i3] = nbd;
    }
    out.push_back(pt.x);
    out.push_back(pt.y);
    pt.x += kDx[s];
    pt.y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

// Every border of the nonzero pixels of src [h, w], in OpenCV's order.
void find_contours_impl(const uint8_t* src, int h, int w, std::vector<Seq>& contours) {
  const long step = w + 2;
  std::vector<int8_t> img(static_cast<size_t>(step) * (h + 2), 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) img[(y + 1) * step + x + 1] = src[static_cast<size_t>(y) * w + x] ? 1 : 0;
  std::vector<Seq> found;
  for (int y = 1; y <= h; ++y) {
    int8_t* row = img.data() + y * step;
    int prev = 0;
    for (int x = 1; x <= w; ++x) {
      int p = row[x];
      if (p == prev) continue;
      bool outer = prev == 0 && p == 1;
      bool hole = !outer && p == 0 && prev >= 1;
      if (!outer && !hole) {
        prev = p;
        continue;
      }
      int sx = x - (hole ? 1 : 0);
      found.emplace_back();
      fetch_contour(img.data(), step, y * step + sx, Pt{sx - 1, y - 1}, hole, found.back());
      prev = row[x];
    }
  }
  contours.assign(found.rbegin(), found.rend());
}

// approxPolyDP_ of imgproc/approx.cpp on a closed curve of integer points.
int approx_impl(const Pt* src, int count0, Pt* dst, double eps) {
  if (count0 == 0) return 0;
  struct Range {
    int start, end;
  };
  std::vector<Range> stack;
  Range slice{0, 0}, right_slice{0, 0};
  Pt start_pt{-1000000, -1000000}, end_pt{0, 0}, pt{0, 0};
  int pos = 0, wpos, count = count0, new_count = 0;
  bool le_eps = false;
  eps *= eps;
  auto read_pt = [&](Pt& p, int& ps) {
    p = src[ps];
    if (++ps >= count) ps = 0;
  };
  // 1. two roughly farthest points of the curve
  for (int i = 0; i < 3; ++i) {
    double max_dist = 0;
    pos = (pos + right_slice.start) % count;
    read_pt(start_pt, pos);
    for (int j = 1; j < count; ++j) {
      read_pt(pt, pos);
      double dx = pt.x - start_pt.x, dy = pt.y - start_pt.y;
      double dist = dx * dx + dy * dy;
      if (dist > max_dist) {
        max_dist = dist;
        right_slice.start = j;
      }
    }
    le_eps = max_dist <= eps;
  }
  if (!le_eps) {
    right_slice.end = slice.start = pos % count;
    slice.end = right_slice.start = (right_slice.start + slice.start) % count;
    stack.push_back(right_slice);
    stack.push_back(slice);
  } else {
    dst[new_count++] = start_pt;
  }
  // 2. split each slice at its farthest point until it is within eps
  while (!stack.empty()) {
    slice = stack.back();
    stack.pop_back();
    end_pt = src[slice.end];
    pos = slice.start;
    read_pt(start_pt, pos);
    if (pos != slice.end) {
      double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y, max_dist = 0;
      while (pos != slice.end) {
        read_pt(pt, pos);
        double dist = std::fabs((pt.y - start_pt.y) * dx - (pt.x - start_pt.x) * dy);
        if (dist > max_dist) {
          max_dist = dist;
          right_slice.start = (pos + count - 1) % count;
        }
      }
      le_eps = max_dist * max_dist <= eps * (dx * dx + dy * dy);
    } else {
      le_eps = true;
      start_pt = src[slice.start];
    }
    if (le_eps) {
      dst[new_count++] = start_pt;
    } else {
      right_slice.end = slice.end;
      slice.end = right_slice.start;
      stack.push_back(right_slice);
      stack.push_back(slice);
    }
  }
  // 3. remove points on (almost) straight runs
  count = new_count;
  pos = count - 1;
  auto read_dst = [&](Pt& p, int& ps) {
    p = dst[ps];
    if (++ps >= count) ps = 0;
  };
  read_dst(start_pt, pos);
  wpos = pos;
  read_dst(pt, pos);
  for (int i = 0; i < count && new_count > 2; ++i) {
    read_dst(end_pt, pos);
    double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y;
    double dist = std::fabs((pt.x - start_pt.x) * dy - (pt.y - start_pt.y) * dx);
    double successive_inner_product =
        double(pt.x - start_pt.x) * (end_pt.x - pt.x) + double(pt.y - start_pt.y) * (end_pt.y - pt.y);
    if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) && dx != 0 && dy != 0 && successive_inner_product >= 0) {
      new_count--;
      dst[wpos] = start_pt = end_pt;
      if (++wpos >= count) wpos = 0;
      read_dst(pt, pos);
      i++;
      continue;
    }
    dst[wpos] = start_pt = pt;
    if (++wpos >= count) wpos = 0;
    pt = end_pt;
  }
  return new_count;
}

bool convex_impl(const Pt* p, int n) {
  if (n == 0) return false;
  Pt prev_pt = p[(n - 2 + n) % n], cur_pt = p[n - 1];
  int dx0 = cur_pt.x - prev_pt.x, dy0 = cur_pt.y - prev_pt.y, orientation = 0;
  for (int i = 0; i < n; ++i) {
    prev_pt = cur_pt;
    cur_pt = p[i];
    int dx = cur_pt.x - prev_pt.x, dy = cur_pt.y - prev_pt.y;
    int dxdy0 = dx * dy0, dydx0 = dy * dx0;
    orientation |= dydx0 > dxdy0 ? 1 : (dydx0 < dxdy0 ? 2 : 3);
    if (orientation == 3) return false;
    dx0 = dx;
    dy0 = dy;
  }
  return true;
}

}  // namespace

extern "C" {

int seq_count(void* res) { return static_cast<int>(static_cast<Result*>(res)->seqs.size()); }

// Lengths (in points) of every sequence, then their points as x, y pairs.
void seq_copy(void* res, int* lengths, int* points) {
  for (const Seq& s : static_cast<Result*>(res)->seqs) {
    *lengths++ = static_cast<int>(s.size() / 2);
    std::memcpy(points, s.data(), s.size() * sizeof(int));
    points += s.size();
  }
}

long seq_points(void* res) {
  long n = 0;
  for (const Seq& s : static_cast<Result*>(res)->seqs) n += static_cast<long>(s.size() / 2);
  return n;
}

void seq_free(void* res) { delete static_cast<Result*>(res); }

void* find_contours(const uint8_t* img, int h, int w) {
  Result* res = new Result;
  find_contours_impl(img, h, w, res->seqs);
  return res;
}

// A closed curve, points: n x 2 ints; out: room for n points. Returns the
// count written.
int approx_poly_dp(const int* points, int n, double eps, int* out) {
  return approx_impl(reinterpret_cast<const Pt*>(points), n, reinterpret_cast<Pt*>(out), eps);
}

int is_contour_convex(const int* points, int n) { return convex_impl(reinterpret_cast<const Pt*>(points), n); }

// The square candidates of one thresholded map [h, w], as pairs of
// sequences: the 4 corners of the approximating polygon, then the contour.
void* marker_contours(const uint8_t* img, int h, int w, double min_perimeter_rate, double max_perimeter_rate,
                      double accuracy_rate, double min_corner_distance_rate, int min_distance_to_border) {
  Result* res = new Result;
  std::vector<Seq> contours;
  find_contours_impl(img, h, w, contours);
  const int side = std::max(w, h);
  const unsigned min_perimeter = static_cast<unsigned>(min_perimeter_rate * side);
  const unsigned max_perimeter = static_cast<unsigned>(max_perimeter_rate * side);
  std::vector<Pt> approx;
  for (Seq& c : contours) {
    const unsigned n = static_cast<unsigned>(c.size() / 2);
    if (n < min_perimeter || n > max_perimeter) continue;
    approx.resize(n);
    int k = approx_impl(reinterpret_cast<const Pt*>(c.data()), static_cast<int>(n), approx.data(), double(n) * accuracy_rate);
    if (k != 4 || !convex_impl(approx.data(), 4)) continue;
    double min_dist_sq = double(side) * side;
    for (int j = 0; j < 4; ++j) {
      double dx = double(approx[j].x - approx[(j + 1) % 4].x), dy = double(approx[j].y - approx[(j + 1) % 4].y);
      min_dist_sq = std::min(min_dist_sq, dx * dx + dy * dy);
    }
    double min_corner = double(n) * min_corner_distance_rate;
    if (min_dist_sq < min_corner * min_corner) continue;
    bool near_border = false;
    for (int j = 0; j < 4; ++j)
      if (approx[j].x < min_distance_to_border || approx[j].y < min_distance_to_border ||
          approx[j].x > w - 1 - min_distance_to_border || approx[j].y > h - 1 - min_distance_to_border)
        near_border = true;
    if (near_border) continue;
    Seq corners;
    for (int j = 0; j < 4; ++j) {
      corners.push_back(approx[j].x);
      corners.push_back(approx[j].y);
    }
    res->seqs.push_back(std::move(corners));
    res->seqs.push_back(std::move(c));
  }
  return res;
}

}  // extern "C"
