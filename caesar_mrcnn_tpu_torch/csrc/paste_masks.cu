// Paste of every tile's detection masks into its full [H, W, n] bool frame,
// for the tiled detect path, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package and the port unmold on the host:
// Detector.unmold_detections resizes each detection's 28x28 mask to its
// pixel box (utils/image.py::paste_mask, one CPU F.interpolate a detection),
// thresholds it at 0.5 and writes it into a fresh [H, W, n] bool frame a
// tile. At 512^2 tiles and 100 detections that is 800 resizes and 210 MB of
// frame a batch of 8 on one host thread. This kernel does the same work for
// a whole batch in one launch, between the detect step and the batch's
// event, so the host's unmold only builds views of the frames.
//
// What bounds it on the card: the frames' bytes, written once. The frames
// live in pinned host memory, which unified addressing maps into the
// device's address space, so the kernel stores straight into them over
// PCIe (H*W*n bytes a tile: 26 MB at 512^2 and n = 100); it reads only the
// detections and the small u8 masks (a tile's 100 x 784 bytes stay in L1).
// Design: grid (blocks per tile, tiles), kPasteThreads threads a block.
//  1. Warp 0 finds the tile's n (the first zero class id), computes each
//     detection's pixel box and compacts the kept ones (nonzero area), in
//     order, into shared memory, with their resize scales.
//  2. All threads walk the tile's frame in 16-byte chunks (grid-stride over
//     the tile's blocks), each byte one (pixel, kept detection): 0 outside
//     the detection's box, else its bilinear sample >= 0.5. A chunk leaves
//     as one 16-byte streaming store, so a warp writes 512 contiguous bytes.
// Every byte of the frame's [H, W, n] prefix is written once; nothing is
// zeroed first. A tile with no frame (a null pointer) is skipped.
//
// Numerics are the host unmold's, bit for bit:
//  * pixel boxes as utils/boxes.py::denorm_boxes on the full frame in f64:
//    rint(b * (size - 1) + {0, 0, 1, 1}), multiply and add rounded apart,
//    half to even; kept where (y2 - y1) * (x2 - x1) > 0 in int32;
//  * the mask value u8 / 255 in f32;
//  * the resize as CPU ATen's upsample_bilinear2d (align_corners=False) as
//    compiled for its AVX2 and AVX512 kernels, whose multiply-adds are
//    contracted into FMAs: per axis, scale = in / out, source
//    fma(scale, d + 0.5, -0.5) clamped at 0, i0 = min(floor(src), in - 1),
//    i1 = i0 + (i0 < in - 1), l1 = clamp(src - i0, 0, 1), l0 = 1 - l1.
//    Outputs with out_h + out_w <= 128 take ATen's vectorized kernel:
//    fma(v11, h1 w1, fma(v10, h1 w0, fma(v00, h0 w0, v01 (h0 w1)))); larger
//    ones its generic kernel: fma(t0, h0, t1 h1), t_r = fma(v_r0, w0,
//    v_r1 w1). Every operation is an explicit intrinsic (and the build
//    passes --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPasteThreads = 256;
constexpr int kMaxTiles = 64;         // frame pointers passed by value per launch
constexpr int kMaxDetections = 1024;  // detections a tile: records within the default 48 KB of shared memory
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Frames {
  unsigned char* p[kMaxTiles];
};

// A kept detection: its pixel box, its row in the tile's masks, and the
// resize scales in / out of each axis.
struct __align__(16) Kept {
  int y1, x1, y2, x2;
  int row, small;
  float sy, sx;
};

// One axis of ATen's bilinear resize at output index d.
struct Axis {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Axis axis(float scale, int d, int in) {
  float src = __fmaf_rn(scale, __fadd_rn((float)d, 0.5f), -0.5f);
  if (src < 0.0f) src = 0.0f;
  Axis a;
  a.i0 = min((int)floorf(src), in - 1);
  a.i1 = a.i0 + (a.i0 < in - 1 ? 1 : 0);
  a.l1 = fminf(fmaxf(__fsub_rn(src, (float)a.i0), 0.0f), 1.0f);
  a.l0 = __fsub_rn(1.0f, a.l1);
  return a;
}

__device__ __forceinline__ float mask_value(const unsigned char* m, int i) {
  return __fdiv_rn((float)__ldg(m + i), 255.0f);
}

// The thresholded sample of kept detection d at pixel (y, x) of the frame.
__device__ __forceinline__ unsigned char pixel(const Kept& d, int y, int x,
                                               const unsigned char* m, int mh,
                                               int mw) {
  if (y < d.y1 || y >= d.y2 || x < d.x1 || x >= d.x2) return 0;
  const Axis ay = axis(d.sy, y - d.y1, mh);
  const Axis ax = axis(d.sx, x - d.x1, mw);
  const float v00 = mask_value(m, ay.i0 * mw + ax.i0);
  const float v01 = mask_value(m, ay.i0 * mw + ax.i1);
  const float v10 = mask_value(m, ay.i1 * mw + ax.i0);
  const float v11 = mask_value(m, ay.i1 * mw + ax.i1);
  float v;
  if (d.small) {
    const float w00 = __fmul_rn(ay.l0, ax.l0);
    const float w01 = __fmul_rn(ay.l0, ax.l1);
    const float w10 = __fmul_rn(ay.l1, ax.l0);
    const float w11 = __fmul_rn(ay.l1, ax.l1);
    v = __fmaf_rn(v00, w00, __fmul_rn(v01, w01));
    v = __fmaf_rn(v10, w10, v);
    v = __fmaf_rn(v11, w11, v);
  } else {
    const float t0 = __fmaf_rn(v00, ax.l0, __fmul_rn(v01, ax.l1));
    const float t1 = __fmaf_rn(v10, ax.l0, __fmul_rn(v11, ax.l1));
    v = __fmaf_rn(t0, ay.l0, __fmul_rn(t1, ay.l1));
  }
  return v >= 0.5f ? 1 : 0;
}

// Pixel coordinate of a normalized edge, as numpy's denorm_boxes.
__device__ __forceinline__ int pixel_edge(float b, double size_m1, double shift) {
  return __double2int_rn(__dadd_rn(__dmul_rn((double)b, size_m1), shift));
}

// grid (blocks per tile, tiles) of kPasteThreads. dets: [tiles, D, 6] f32;
// masks: [tiles, D, mh, mw] u8; frames.p[t]: tile t's frame, at least
// h * w * D bytes, 16-byte aligned, or null.
__global__ void __launch_bounds__(kPasteThreads)
paste_masks_kernel(const float* __restrict__ dets,
                   const unsigned char* __restrict__ masks, int D, int mh,
                   int mw, int h, int w, Frames frames) {
  extern __shared__ Kept kept[];
  __shared__ int s_k;
  const int tile = blockIdx.y;
  unsigned char* frame = frames.p[tile];
  if (frame == nullptr) return;
  const float* det = dets + (size_t)tile * D * 6;
  const unsigned char* tile_masks = masks + (size_t)tile * D * mh * mw;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = D;
    for (int base = 0; base < D; base += 32) {
      const int i = base + lane;
      const unsigned zero = __ballot_sync(kFull, i < D && det[i * 6 + 4] == 0.0f);
      if (zero) {
        n = base + __ffs(zero) - 1;
        break;
      }
    }
    const double hm1 = (double)(h - 1), wm1 = (double)(w - 1);
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      Kept d;
      bool keep = false;
      if (i < n) {
        const float* b = det + i * 6;
        d.y1 = pixel_edge(b[0], hm1, 0.0);
        d.x1 = pixel_edge(b[1], wm1, 0.0);
        d.y2 = pixel_edge(b[2], hm1, 1.0);
        d.x2 = pixel_edge(b[3], wm1, 1.0);
        keep = (d.y2 - d.y1) * (d.x2 - d.x1) > 0;
      }
      const unsigned kept_mask = __ballot_sync(kFull, keep);
      if (keep) {
        const int oh = d.y2 - d.y1, ow = d.x2 - d.x1;
        d.row = i;
        d.small = oh + ow <= 128;
        d.sy = __fdiv_rn((float)mh, (float)oh);
        d.sx = __fdiv_rn((float)mw, (float)ow);
        kept[count + __popc(kept_mask & ((1u << lane) - 1))] = d;
      }
      count += __popc(kept_mask);
    }
    if (lane == 0) s_k = count;
  }
  __syncthreads();

  const int k = s_k;
  const long long total = (long long)h * w * k;
  const long long chunks = (total + 15) / 16;
  const long long stride = (long long)gridDim.x * kPasteThreads;
  for (long long c = (long long)blockIdx.x * kPasteThreads + threadIdx.x; c < chunks; c += stride) {
    const long long f = c * 16;
    const long long p = f / k;
    int j = (int)(f - p * k);
    int y = (int)(p / w), x = (int)(p - (long long)y * w);
    unsigned char out[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const Kept& d = kept[j];
      out[e] = f + e < total ? pixel(d, y, x, tile_masks + (size_t)d.row * mh * mw, mh, mw) : 0;
      if (++j == k) {
        j = 0;
        if (++x == w) x = 0, ++y;
      }
    }
    if (f + 16 <= total) {
      uint4 v;
      v.x = out[0] | out[1] << 8 | out[2] << 16 | (unsigned)out[3] << 24;
      v.y = out[4] | out[5] << 8 | out[6] << 16 | (unsigned)out[7] << 24;
      v.z = out[8] | out[9] << 8 | out[10] << 16 | (unsigned)out[11] << 24;
      v.w = out[12] | out[13] << 8 | out[14] << 16 | (unsigned)out[15] << 24;
      __stcs(reinterpret_cast<uint4*>(frame + f), v);
    } else {
      for (int e = 0; f + e < total; ++e) frame[f + e] = out[e];
    }
  }
}

}  // namespace

// dets [tiles, D, 6] f32 and masks [tiles, D, mh, mw] u8 on the device;
// frames: a host array of `tiles` frame pointers (device memory, or pinned
// host memory, which unified addressing maps), each 16-byte aligned and
// at least h * w * D bytes, or null to skip the tile. One launch per
// kMaxTiles tiles; sms sizes the grid.
extern "C" int caesar_paste_masks(const float* dets, const unsigned char* masks,
                                  int tiles, int D, int mh, int mw, int h, int w,
                                  void* const* frames, int sms, void* stream) {
  if (tiles < 0 || D < 1 || D > kMaxDetections || mh < 1 || mw < 1 || h < 1 || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < tiles; ++t) {
    if (reinterpret_cast<uintptr_t>(frames[t]) % 16) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)D * sizeof(Kept);
  for (int t0 = 0; t0 < tiles; t0 += kMaxTiles) {
    const int n = tiles - t0 < kMaxTiles ? tiles - t0 : kMaxTiles;
    Frames f = {};
    for (int t = 0; t < n; ++t) f.p[t] = static_cast<unsigned char*>(frames[t0 + t]);
    const dim3 grid((unsigned)((sms * kBlocksPerSm + n - 1) / n), (unsigned)n);
    paste_masks_kernel<<<grid, kPasteThreads, smem, s>>>(
        dets + (size_t)t0 * D * 6, masks + (size_t)t0 * D * mh * mw, D, mh, mw, h, w, f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
