// Native host-path kernels for the data pipeline and post-processing (the
// port's copy of caesar_mrcnn_tpu/native/fastops.cpp, with the six
// functions the port calls, plus the contour tracer that replaces the JAX
// package's cv2.findContours).
//
// The reference delegated its host hot loops to numpy/astropy Python code:
// the O(anchors x GT) RPN-target IoU matrix (reference:
// mrcnn/model.py:1536-1644 via utils.compute_overlaps), the per-image
// zscale stretch (reference: mrcnn/utils.py:1166-1172, astropy C-backed),
// and the O(N^2) mask pair tests in the analyzer merge step (reference:
// mrcnn/analyze.py:1262-1311). These are re-implemented here in C++ with
// OpenMP-free portable loops, exposed through a plain C ABI for ctypes.
//
// Build: make -C caesar_mrcnn_tpu_torch/native OUT=<path>/libfastops.so
// (the package builds it at first use into build/native/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// IoU matrix between two box sets in (y1, x1, y2, x2) layout.
// out[i * n2 + j] = IoU(b1[i], b2[j]); zero-area unions give 0.
void iou_matrix(const float* b1, int64_t n1, const float* b2, int64_t n2,
                double* out) {
  std::vector<double> area2(n2);
  for (int64_t j = 0; j < n2; ++j) {
    const float* b = b2 + 4 * j;
    area2[j] = double(b[2] - b[0]) * double(b[3] - b[1]);
  }
  for (int64_t i = 0; i < n1; ++i) {
    const float* a = b1 + 4 * i;
    const double area1 = double(a[2] - a[0]) * double(a[3] - a[1]);
    double* row = out + i * n2;
    for (int64_t j = 0; j < n2; ++j) {
      const float* b = b2 + 4 * j;
      const double y1 = std::max(a[0], b[0]);
      const double x1 = std::max(a[1], b[1]);
      const double y2 = std::min(a[2], b[2]);
      const double x2 = std::min(a[3], b[3]);
      const double inter =
          std::max(y2 - y1, 0.0) * std::max(x2 - x1, 0.0);
      const double uni = area1 + area2[j] - inter;
      row[j] = uni > 0.0 ? inter / uni : 0.0;
    }
  }
}

// Single-pass anchor<->GT statistics for RPN target building
// (reference semantics: mrcnn/model.py:1583-1595 built from a full
// utils.compute_overlaps matrix + numpy argmax/max/argwhere; here the
// matrix never leaves this function). Per-cell IoU math is identical to
// iou_matrix above (f32 inputs, f64 arithmetic) so results are
// bit-consistent with the two-step path. Writes:
//   amax[i] = max_j IoU(anchor i, gt j)                      (f64)
//   aarg[i] = argmax_j, first occurrence like np.argmax      (i32)
//   tie[i]  = 1 iff exists j: IoU(i, j) == max_i' IoU(i', j) > 0
//             (the "best anchor per GT incl. ties" positive set)
void rpn_anchor_stats(const float* anchors, int64_t na, const float* gt,
                      int64_t ng, float* amax, int32_t* aarg, uint8_t* tie) {
  std::fill(tie, tie + na, (uint8_t)0);
  if (ng == 0) {
    std::fill(amax, amax + na, 0.0f);
    std::fill(aarg, aarg + na, 0);
    return;
  }
  // SoA anchor layout so the per-GT sweep over all anchors vectorizes
  // (the AoS row-major double variant measured 2.7 ms at [16368 x 11];
  // this form ~0.2 ms). Buffers are thread_local: a fresh 1 MB
  // vector per call costs ~1 ms in mmap + first-touch page faults alone.
  thread_local std::vector<float> soa, m;
  soa.resize((size_t)na * 5);
  float* ay1 = soa.data();
  float* ax1 = ay1 + na;
  float* ay2 = ax1 + na;
  float* ax2 = ay2 + na;
  float* aarea = ax2 + na;
  for (int64_t i = 0; i < na; ++i) {
    const float* a = anchors + 4 * i;
    ay1[i] = a[0];
    ax1[i] = a[1];
    ay2[i] = a[2];
    ax2[i] = a[3];
    aarea[i] = (a[2] - a[0]) * (a[3] - a[1]);
  }
  // Per-GT column buffer (64 KB at 16k anchors) stays L2-resident; the
  // full [A, G] matrix never exists, so the kernel is compute- not
  // DRAM-bound (the stored-matrix variant re-traversed ~2.9 MB per call).
  m.resize((size_t)na);
  float* __restrict__ col = m.data();
  std::fill(amax, amax + na, 0.0f);
  std::fill(aarg, aarg + na, 0);
  for (int64_t j = 0; j < ng; ++j) {
    const float* b = gt + 4 * j;
    const float by1 = b[0], bx1 = b[1], by2 = b[2], bx2 = b[3];
    const float barea = (by2 - by1) * (bx2 - bx1);
    float g = 0.0f;
    for (int64_t i = 0; i < na; ++i) {
      const float y1 = std::max(ay1[i], by1);
      const float x1 = std::max(ax1[i], bx1);
      const float y2 = std::min(ay2[i], by2);
      const float x2 = std::min(ax2[i], bx2);
      const float inter = std::max(y2 - y1, 0.0f) * std::max(x2 - x1, 0.0f);
      const float uni = aarea[i] + barea - inter;
      const float iou = uni > 0.0f ? inter / uni : 0.0f;
      col[i] = iou;
      g = std::max(g, iou);
    }
    for (int64_t i = 0; i < na; ++i)
      if (col[i] > amax[i]) {  // strict > keeps np.argmax first-occurrence
        amax[i] = col[i];
        aarg[i] = (int32_t)j;
      }
    if (g > 0.0f)
      for (int64_t i = 0; i < na; ++i)
        if (col[i] == g) tie[i] = 1;
  }
}

// IRAF zscale limits: sampled sorted pixels, iterative k-sigma-clipped
// weighted line fit through the midpoint, slope / contrast.
// Returns 0 on success; writes vmin/vmax.
int zscale_limits(const float* data, int64_t n, double contrast,
                  int64_t nsamples, double max_reject, int64_t min_npixels,
                  double krej, int max_iterations, double* vmin_out,
                  double* vmax_out) {
  // collect finite values with stride sampling
  std::vector<double> finite;
  finite.reserve(std::min<int64_t>(n, nsamples * 2));
  int64_t n_finite = 0;
  for (int64_t i = 0; i < n; ++i)
    if (std::isfinite(data[i])) ++n_finite;
  if (n_finite == 0) {
    *vmin_out = 0.0;
    *vmax_out = 1.0;
    return 0;
  }
  const int64_t stride = std::max<int64_t>(1, n_finite / nsamples);
  int64_t seen = 0;
  for (int64_t i = 0; i < n && (int64_t)finite.size() < nsamples; ++i) {
    if (!std::isfinite(data[i])) continue;
    if (seen % stride == 0) finite.push_back(data[i]);
    ++seen;
  }
  std::sort(finite.begin(), finite.end());
  const int64_t npix = (int64_t)finite.size();
  if (npix < 2) {
    *vmin_out = npix ? finite[0] : 0.0;
    *vmax_out = *vmin_out + 1.0;
    return 0;
  }
  double vmin = finite.front();
  double vmax = finite.back();

  const int64_t minpix =
      std::max<int64_t>(min_npixels, (int64_t)(npix * max_reject));
  std::vector<uint8_t> badpix(npix, 0);
  int64_t ngood = npix;
  int64_t last_ngood = npix + 1;
  const int64_t ngrow = std::max<int64_t>(1, (int64_t)(npix * 0.01));
  double slope = 0.0;

  for (int it = 0; it < max_iterations; ++it) {
    if (ngood >= last_ngood || ngood < minpix) break;
    // weighted least squares over good pixels
    double sw = 0, sx = 0, sy = 0;
    for (int64_t i = 0; i < npix; ++i) {
      if (badpix[i]) continue;
      sw += 1.0;
      sx += (double)i;
      sy += finite[i];
    }
    const double mx = sx / sw, my = sy / sw;
    double cov = 0, var = 0;
    for (int64_t i = 0; i < npix; ++i) {
      if (badpix[i]) continue;
      const double dx = (double)i - mx;
      cov += dx * (finite[i] - my);
      var += dx * dx;
    }
    slope = var > 0 ? cov / var : 0.0;
    const double intercept = my - slope * mx;

    // k-sigma rejection about the fitted line
    double ss = 0;
    int64_t cnt = 0;
    std::vector<double> flat(npix);
    for (int64_t i = 0; i < npix; ++i) {
      flat[i] = finite[i] - (slope * (double)i + intercept);
      if (!badpix[i]) {
        ss += flat[i] * flat[i];
        ++cnt;
      }
    }
    double mean_flat = 0;
    for (int64_t i = 0; i < npix; ++i)
      if (!badpix[i]) mean_flat += flat[i];
    mean_flat /= std::max<int64_t>(cnt, 1);
    double varf = 0;
    for (int64_t i = 0; i < npix; ++i)
      if (!badpix[i]) varf += (flat[i] - mean_flat) * (flat[i] - mean_flat);
    const double sigma = std::sqrt(varf / std::max<int64_t>(cnt, 1));
    const double threshold = krej * sigma;
    for (int64_t i = 0; i < npix; ++i)
      if (std::fabs(flat[i]) > threshold) badpix[i] = 1;

    // grow the rejection mask
    std::vector<uint8_t> grown(badpix);
    for (int64_t i = 0; i < npix; ++i) {
      if (!badpix[i]) continue;
      const int64_t lo = std::max<int64_t>(0, i - ngrow / 2);
      const int64_t hi = std::min<int64_t>(npix - 1, i + ngrow / 2);
      for (int64_t j = lo; j <= hi; ++j) grown[j] = 1;
    }
    badpix.swap(grown);
    last_ngood = ngood;
    ngood = 0;
    for (int64_t i = 0; i < npix; ++i)
      if (!badpix[i]) ++ngood;
  }

  if (ngood >= minpix) {
    if (contrast > 0) slope /= contrast;
    // astropy/IRAF midpoint convention: (npix + 1) / 2
    const int64_t center = (npix + 1) / 2;
    const double median =
        (npix % 2) ? finite[npix / 2]
                   : 0.5 * (finite[npix / 2 - 1] + finite[npix / 2]);
    vmin = std::max(vmin, median - (double)(center - 1) * slope);
    vmax = std::min(vmax, median + (double)(npix - center) * slope);
  }
  *vmin_out = vmin;
  *vmax_out = vmax;
  return 0;
}

// Apply the [vmin, vmax] interval + [0,1] clip + optional uint8 scaling
// in one fused pass (the reference chains stretch -> normalize ->
// gray2rgb as separate numpy passes, mrcnn/utils.py:1097-1160).
void stretch_to_u8(const float* data, int64_t n, double vmin, double vmax,
                   uint8_t* out) {
  const double inv = vmax > vmin ? 1.0 / (vmax - vmin) : 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double v = (double(data[i]) - vmin) * inv;
    v = v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v);
    out[i] = (uint8_t)std::lround(v * 255.0);
  }
}

// Binary-mask IoU for two same-shape uint8 masks.
double mask_iou(const uint8_t* m1, const uint8_t* m2, int64_t n) {
  int64_t inter = 0, uni = 0;
  for (int64_t i = 0; i < n; ++i) {
    const bool a = m1[i] != 0, b = m2[i] != 0;
    inter += (a && b);
    uni += (a || b);
  }
  return uni > 0 ? (double)inter / (double)uni : 0.0;
}

// 8-connectivity adjacency between two same-shape masks: true when some
// pixel pair is within |dx|<=1, |dy|<=1 (the reference's merge criterion,
// mrcnn/analyze.py:2154-2173).
int masks_connected(const uint8_t* m1, const uint8_t* m2, int64_t h,
                    int64_t w) {
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      if (!m1[y * w + x]) continue;
      const int64_t y0 = std::max<int64_t>(0, y - 1);
      const int64_t y1 = std::min<int64_t>(h - 1, y + 1);
      const int64_t x0 = std::max<int64_t>(0, x - 1);
      const int64_t x1 = std::min<int64_t>(w - 1, x + 1);
      for (int64_t yy = y0; yy <= y1; ++yy)
        for (int64_t xx = x0; xx <= x1; ++xx)
          if (m2[yy * w + xx]) return 1;
    }
  }
  return 0;
}

}  // extern "C"

// ----------------------------------------------------------- contours
//
// Outer borders of a binary mask, as OpenCV's
// cv::findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE) finds them: the
// border following of Suzuki & Abe (1985) in OpenCV's form (its
// icvFetchContour and the RETR_EXTERNAL branch of its raster scan). The
// mask is copied into a frame one pixel wider on each side, so borders on
// the image edge are followed like any other (OpenCV >= 3.2 does the same).
// Pixels of the frame hold 0 (background), 1 (object), 2 (a followed
// border pixel) or kRightEdge (a followed border pixel whose right
// neighbour was examined as background).

namespace {

// Chain-code directions (OpenCV's): 0 right, 1 up-right, 2 up, 3 up-left,
// 4 left, 5 down-left, 6 down, 7 down-right (y grows downward).
constexpr int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
constexpr int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
constexpr int8_t kRightEdge = (int8_t)(2 | -128);

// Follows the outer border that starts at frame pixel i0 = (x, y), whose
// left neighbour is background, and marks it. Writes up to `room` points
// (x, y) in mask coordinates to `out`; returns the border's point count.
int64_t follow_border(int8_t* img, const int64_t* delta, int64_t i0,
                      int32_t x, int32_t y, int32_t* out, int64_t room) {
  int64_t n = 0;
  auto put = [&](int32_t px, int32_t py) {
    if (n < room) {
      out[2 * n] = px - 1;
      out[2 * n + 1] = py - 1;
    }
    ++n;
  };
  // the last border pixel: the first object pixel clockwise from the left
  int s = 4;
  const int s_first = 4;
  int64_t i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + delta[s];
  } while (img[i1] == 0 && s != s_first);
  if (s == s_first) {  // a single pixel
    img[i0] = kRightEdge;
    put(x, y);
    return n;
  }
  int64_t i3 = i0, i4 = i0;
  for (;;) {
    // next border pixel: counterclockwise from the one after the previous
    const int s_end = s;
    do {
      i4 = i3 + delta[++s];
    } while (img[i4] == 0 && s < 15);
    s &= 7;
    if ((unsigned)(s - 1) < (unsigned)s_end) {
      img[i3] = kRightEdge;
    } else if (img[i3] == 1) {
      img[i3] = 2;
    }
    put(x, y);
    x += kDx[s];
    y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
  return n;
}

}  // namespace

extern "C" {

// Outer borders of the nonzero pixels of an h x w uint8 mask, in the order
// the raster scan finds them (OpenCV lists them in the reverse order), each
// from its raster-first pixel and counterclockwise on the screen, with
// every pixel of the walk (a border that doubles back over a 1-pixel line
// lists its pixels twice). Writes up to max_points points (x, y) as int32
// pairs to `points` and up to max_contours point counts to `lengths`, sets
// *n_contours, and returns the number of points of all borders: a caller
// whose buffers were too small calls again with larger ones.
int64_t find_contours_external(const uint8_t* mask, int64_t h, int64_t w,
                               int32_t* points, int64_t max_points,
                               int64_t* lengths, int64_t max_contours,
                               int64_t* n_contours) {
  const int64_t W = w + 2, H = h + 2;
  std::vector<int8_t> img(W * H, 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      img[(y + 1) * W + x + 1] = mask[y * w + x] != 0;
  int64_t delta[16];
  for (int s = 0; s < 8; ++s) delta[s] = delta[s + 8] = kDy[s] * W + kDx[s];
  int64_t total = 0, count = 0;
  for (int64_t y = 1; y < H - 1; ++y) {
    int64_t lnbd = y * W;  // the last border pixel met on this row
    int prev = 0;
    for (int64_t x = 1; x < W - 1; ++x) {
      const int64_t i = y * W + x;
      if (img[i] == prev) continue;
      // an outer border starts here unless it lies in a hole of a border
      // already followed (RETR_EXTERNAL)
      if (prev == 0 && img[i] == 1 && img[lnbd] <= 0) {
        const int64_t room = std::max<int64_t>(0, max_points - total);
        const int64_t n = follow_border(img.data(), delta, i, (int32_t)x,
                                        (int32_t)y, points + 2 * std::min(total, max_points), room);
        if (count < max_contours) lengths[count] = n;
        ++count;
        total += n;
        lnbd = i;
      }
      prev = img[i];
      if (prev & -2) lnbd = i;
    }
  }
  *n_contours = count;
  return total;
}

}  // extern "C"
