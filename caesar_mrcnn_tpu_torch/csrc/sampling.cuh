// Bilinear sample positions of crop_and_resize with aligned corners, shared
// by the ROIAlign forward and backward (roi_align.cu) and the mask-target
// crop (crop_and_resize.cu), so that all three sample exactly where the
// plain versions in ops/roi_align.py do.
//
// Along one axis of extent H, sample p of n sits at
// (lo + (hi - lo) * t) * (H - 1), with jnp.linspace's t = p * (1 / (n - 1))
// and t = 1 at the last sample, so a border-touching box lands exactly on
// H - 1. Its taps are floor(pos) and floor(pos) + 1, both clamped to
// [0, H - 1]; its weight is the clamped position's fraction past tap 0; a
// sample outside [0, H - 1] reads 0. Every operation is an explicitly
// rounded intrinsic (and the build passes --fmad=false).

#pragma once

#include <cuda_runtime.h>

namespace caesar {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Tap {
  int lo;       // tap 0 index
  int hi;       // tap 1 index
  float w;      // fractional part: the weight of tap 1
  bool inside;  // sample inside the map
};

// Sample p of n between box edges lo and hi (normalized), on an axis of
// `extent` pixels.
__device__ __forceinline__ Tap sample(float lo, float hi, int extent, int n,
                                      int p) {
  const float extent_m1 = __fsub_rn((float)extent, 1.0f);
  const float step = __fdiv_rn(1.0f, (float)(n - 1));
  const float t = p == n - 1 ? 1.0f : __fmul_rn((float)p, step);
  const float pos =
      __fmul_rn(__fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), t)), extent_m1);
  const float t0 = clampf(floorf(pos), 0.0f, extent_m1);
  const float t1 = clampf(__fadd_rn(t0, 1.0f), 0.0f, extent_m1);
  Tap tap;
  tap.inside = pos >= 0.0f && pos <= extent_m1;
  tap.w = __fsub_rn(clampf(pos, 0.0f, extent_m1), t0);
  tap.lo = (int)t0;
  tap.hi = (int)t1;
  return tap;
}

}  // namespace caesar
