// Native host-path kernels for the data pipeline (the port's copy of
// caesar_mrcnn_tpu/native/fastops.cpp, with the four functions the port
// calls).
//
// The reference delegated its host hot loops to numpy/astropy Python code:
// the O(anchors x GT) RPN-target IoU matrix (reference:
// mrcnn/model.py:1536-1644 via utils.compute_overlaps) and the per-image
// zscale stretch (reference: mrcnn/utils.py:1166-1172, astropy C-backed).
// These are re-implemented here in C++ with OpenMP-free portable loops,
// exposed through a plain C ABI for ctypes.
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

}  // extern "C"
