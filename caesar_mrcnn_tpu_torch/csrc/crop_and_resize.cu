// Bilinear crop-and-resize of GT mask channels, for the mask targets of
// training, for Hopper (sm_90a).
//
// Replaces: caesar_mrcnn_tpu/ops/roi_align.py::crop_and_resize as the JAX
// training graph calls it at models/targets.py:237-257: transpose the GT
// masks [H, W, G] to [G, H, W], gather channel gt_assign[r] for every
// positive ROI, and crop each at its box to 28x28. JAX materializes that
// [R, H, W] gather (168 x 256 x 256 f32 = 44 MB per image at the training
// flagship); this kernel reads the assigned channel in place.
//
// What bounds it on the card: latency of scattered reads. Each output
// element reads four taps from a [B, H, W, G] f32 map whose channel stride
// is G (300 at the flagship), so the taps of neighbouring threads are G
// floats apart; the output is small (8 x 168 x 28 x 28).
//
// Design: one thread per output element (b, r, py, px), consecutive threads
// along px. Each thread computes its two taps itself (sampling.cuh, the
// sample positions of the ROIAlign kernels; no shared memory), and reads
// the four taps.
//
// Numerics follow ops/roi_align.py::_bilinear_sample exactly: top = f00
// (1 - wx) + f01 wx, bot likewise, out = top (1 - wy) + bot wy, each
// operation rounded (explicit _rn intrinsics, --fmad=false), and 0 where the
// sample lies outside the map. f32 results equal the plain PyTorch version
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"

namespace {

using caesar::sample;
using caesar::Tap;

// masks: [B, H, W, G] f32; boxes: [B*R, 4] f32 normalized; assign: [B*R]
// int32 in 0..G-1; out: [B*R, ph, pw] f32.
__global__ void crop_and_resize_kernel(const float* __restrict__ masks, int h,
                                       int w, int g,
                                       const float* __restrict__ boxes,
                                       const int32_t* __restrict__ assign,
                                       int rois, int ph, int pw,
                                       float* __restrict__ out, long total) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int px = (int)(idx % pw);
  const int py = (int)((idx / pw) % ph);
  const long br = idx / ((long)ph * pw);
  const long b = br / rois;
  const float* box = boxes + br * 4;
  const Tap ty = sample(box[0], box[2], h, ph, py);
  const Tap tx = sample(box[1], box[3], w, pw, px);
  float v = 0.0f;
  if (ty.inside && tx.inside) {
    const float* m = masks + (size_t)b * h * w * g + assign[br];
    const float f00 = m[((size_t)ty.lo * w + tx.lo) * g];
    const float f01 = m[((size_t)ty.lo * w + tx.hi) * g];
    const float f10 = m[((size_t)ty.hi * w + tx.lo) * g];
    const float f11 = m[((size_t)ty.hi * w + tx.hi) * g];
    const float wx1 = __fsub_rn(1.0f, tx.w);
    const float wy1 = __fsub_rn(1.0f, ty.w);
    const float top = __fadd_rn(__fmul_rn(f00, wx1), __fmul_rn(f01, tx.w));
    const float bot = __fadd_rn(__fmul_rn(f10, wx1), __fmul_rn(f11, tx.w));
    v = __fadd_rn(__fmul_rn(top, wy1), __fmul_rn(bot, ty.w));
  }
  out[idx] = v;
}

}  // namespace

extern "C" int caesar_crop_and_resize(const float* masks, int batch, int h,
                                      int w, int g, const float* boxes,
                                      const int32_t* assign, int rois, int ph,
                                      int pw, float* out, void* stream) {
  if (ph < 2 || pw < 2 || g < 1) return (int)cudaErrorInvalidValue;
  const long total = (long)batch * rois * ph * pw;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  crop_and_resize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      masks, h, w, g, boxes, assign, rois, ph, pw, out, total);
  return (int)cudaGetLastError();
}
