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
// What bounds it on the card: memory, counted in sectors. The taps come
// from a [B, H, W, G] f32 map whose channel stride is G floats (1200 bytes
// at the flagship's 300), so every distinct tap costs the card one 32-byte
// sector; the output is small (8 x 168 x 28 x 28 f32 = 4.2 MB). The bound
// counts the distinct sectors the data's taps touch
// (kernel_bench.crop_sectors). What holds it now (PERF.md): random 32-byte
// reads, ~33 G per second when the ROIs are large, which its three phases
// do not overlap with their own compute (a variant reading no masks takes
// a fifth of the time). Designs whose reads start at once (one thread per
// output reading its four taps, or only the taps it is first to need)
// overlap them with their compute and match it on many large ROIs, but
// cost 1.3-3.3x its time on the small ROIs of a real train step (PERF.md).
//
// Design: one block per ROI, kCropThreads threads, three phases:
//  1. Warp 0 takes the y axis, warp 1 the x axis. Along an axis the sample
//     positions are monotone, so the samples inside the map are a run, and
//     a tap either is new or repeats one of the previous sample's two taps.
//     Each lane takes one sample (sampling.cuh::sample), flags its new taps
//     against its neighbour's (a shuffle), and a warp scan gives each new
//     tap its slot: the axis's distinct taps in order (at most 2 per
//     sample) and each sample's two taps as slots in that list.
//  2. All threads read the distinct taps of the assigned channel, rows x
//     columns (at most 2ph x 2pw: 12.5 KB at 28x28, far fewer for the small
//     ROIs of training), kCropUnroll reads in flight per thread, into a
//     shared tile.
//  3. All threads blend the ph x pw outputs from the tile.
// Phases 2 and 3 walk their grids without a division per element.
// The assignment is read as int32 or int64, as the caller holds it.
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

constexpr int kCropThreads = 256;  // at least two warps: one per axis in phase 1
constexpr int kCropUnroll = 16;    // tap reads in flight per thread in phase 2
constexpr unsigned kFull = 0xffffffffu;

// A sample's two taps along one axis, as slots in the axis's list of
// distinct taps, with the weight of its second tap.
struct __align__(16) Slots {
  int lo, hi;
  float w;
  int inside;
};

// Phase 1 along one axis, by one warp: the distinct taps of the n samples
// inside the map into list[], in order of first use (table[v] = the slot
// of tap v in list[]), and each sample's Slots into slots[n]. Returns the
// number of distinct taps, to every lane.
__device__ int axis_taps(float lo, float hi, int extent, int n, Slots* slots,
                         int* list, int* table) {
  const int lane = threadIdx.x & 31;
  int count = 0, prev_lo = -1, prev_hi = -1;
  bool prev_in = false;
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int p = p0 + lane;
    Tap t;
    if (p < n) {
      t = sample(lo, hi, extent, n, p);
    } else {
      t.inside = false, t.lo = t.hi = -1, t.w = 0.0f;
    }
    // The previous sample's taps: a tap not among them is new (the taps
    // are monotone in p, so an older repeat would be among them too).
    int plo = __shfl_up_sync(kFull, t.lo, 1);
    int phi = __shfl_up_sync(kFull, t.hi, 1);
    bool pin = __shfl_up_sync(kFull, (int)t.inside, 1) != 0;
    if (lane == 0) plo = prev_lo, phi = prev_hi, pin = prev_in;
    const bool new_lo = t.inside && !(pin && (t.lo == plo || t.lo == phi));
    const bool new_hi = t.inside && t.hi != t.lo && !(pin && (t.hi == plo || t.hi == phi));
    const int mine = (int)new_lo + (int)new_hi;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int slot = count + incl - mine;
    if (new_lo) list[slot] = t.lo, table[t.lo] = slot;
    if (new_hi) list[slot + new_lo] = t.hi, table[t.hi] = slot + new_lo;
    __syncwarp();  // a repeated tap's slot was written by this lane or an earlier one
    if (p < n) {
      Slots q;
      q.lo = t.inside ? table[t.lo] : 0;
      q.hi = t.inside ? table[t.hi] : 0;
      q.w = t.w;
      q.inside = t.inside;
      slots[p] = q;
    }
    count += __shfl_sync(kFull, incl, 31);
    prev_lo = __shfl_sync(kFull, t.lo, 31);
    prev_hi = __shfl_sync(kFull, t.hi, 31);
    prev_in = __shfl_sync(kFull, (int)t.inside, 31) != 0;
  }
  return count;
}

// Dynamic shared memory of one block: slots, distinct-tap lists, per-pixel
// slot tables, the tile (in that order; 16-byte records, then 4-byte words).
__host__ __device__ constexpr size_t crop_smem_bytes(int h, int w, int ph, int pw) {
  return (size_t)(ph + pw) * sizeof(Slots) + (size_t)2 * (ph + pw) * sizeof(int) +
         (size_t)(h + w) * sizeof(int) + (size_t)4 * ph * pw * sizeof(float);
}

// A (row, column) walk over a [rows, cols] grid in steps of kCropThreads,
// without a division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int start, int cols_)
      : r(start / cols_), c(start % cols_), dr(kCropThreads / cols_),
        dc(kCropThreads % cols_), cols(cols_) {}
  __device__ void step() {
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
};

// grid B*R blocks of kCropThreads, one per ROI. masks: [B, H, W, G] f32;
// boxes: [B*R, 4] f32 normalized; assign: [B*R] in 0..G-1; out: [B*R, ph,
// pw] f32.
template <typename I>
__global__ void __launch_bounds__(kCropThreads)
crop_and_resize_kernel(const float* __restrict__ masks, int h, int w, int g,
                       const float* __restrict__ boxes,
                       const I* __restrict__ assign, int rois, int ph, int pw,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  Slots* sy = reinterpret_cast<Slots*>(smem);
  Slots* sx = sy + ph;
  int* list_y = reinterpret_cast<int*>(sx + pw);
  int* list_x = list_y + 2 * ph;
  int* table_y = list_x + 2 * pw;
  int* table_x = table_y + h;
  float* tile = reinterpret_cast<float*>(table_x + w);
  __shared__ int count[2];

  const int roi = blockIdx.x;
  const float* box = boxes + (size_t)roi * 4;
  // the channel's address first, so that its load overlaps phase 1
  const float* m = masks + (size_t)(roi / rois) * h * w * g + (size_t)assign[roi];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int found = warp == 0 ? axis_taps(box[0], box[2], h, ph, sy, list_y, table_y)
                                : axis_taps(box[1], box[3], w, pw, sx, list_x, table_x);
    if ((threadIdx.x & 31) == 0) count[warp] = found;
  }
  __syncthreads();

  const int ny = count[0], nx = count[1];
  const int taps = ny * nx;
  if (threadIdx.x < taps) {
    Walk at(threadIdx.x, nx);
    for (int k0 = threadIdx.x; k0 < taps; k0 += kCropThreads * kCropUnroll) {
      float v[kCropUnroll];
#pragma unroll
      for (int u = 0; u < kCropUnroll; ++u) {
        if (k0 + u * kCropThreads < taps) {
          v[u] = __ldg(m + ((size_t)list_y[at.r] * w + list_x[at.c]) * g);
        }
        at.step();
      }
#pragma unroll
      for (int u = 0; u < kCropUnroll; ++u) {
        const int k = k0 + u * kCropThreads;
        if (k < taps) tile[k] = v[u];
      }
    }
  }
  __syncthreads();

  float* o = out + (size_t)roi * ph * pw;
  Walk at(threadIdx.x, pw);
  for (int k = threadIdx.x; k < ph * pw; k += kCropThreads, at.step()) {
    const Slots a = sy[at.r], b = sx[at.c];
    float v = 0.0f;
    if (a.inside && b.inside) {
      const float* r0 = tile + a.lo * nx;
      const float* r1 = tile + a.hi * nx;
      const float wx1 = __fsub_rn(1.0f, b.w);
      const float wy1 = __fsub_rn(1.0f, a.w);
      const float top = __fadd_rn(__fmul_rn(r0[b.lo], wx1), __fmul_rn(r0[b.hi], b.w));
      const float bot = __fadd_rn(__fmul_rn(r1[b.lo], wx1), __fmul_rn(r1[b.hi], b.w));
      v = __fadd_rn(__fmul_rn(top, wy1), __fmul_rn(bot, a.w));
    }
    o[k] = v;
  }
}

template <typename I>
int launch_crop(const float* masks, int batch, int h, int w, int g, const float* boxes,
                const void* assign, int rois, int ph, int pw, float* out, cudaStream_t s) {
  const size_t smem = crop_smem_bytes(h, w, ph, pw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crop_and_resize_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  crop_and_resize_kernel<I><<<(unsigned int)batch * rois, kCropThreads, smem, s>>>(
      masks, h, w, g, boxes, static_cast<const I*>(assign), rois, ph, pw, out);
  return (int)cudaGetLastError();
}

}  // namespace

// assign_bytes: 4 (int32) or 8 (int64). A block's shared memory
// (crop_smem_bytes: 16 ph pw + 24 (ph + pw) + 4 (H + W) bytes) must fit
// the 227 KB of an SM.
extern "C" int caesar_crop_and_resize(const float* masks, int batch, int h,
                                      int w, int g, const float* boxes,
                                      const void* assign, int assign_bytes,
                                      int rois, int ph, int pw, float* out,
                                      void* stream) {
  if (ph < 2 || pw < 2 || g < 1 || (assign_bytes != 4 && assign_bytes != 8) ||
      crop_smem_bytes(h, w, ph, pw) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long)batch * rois == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return assign_bytes == 4
             ? launch_crop<int32_t>(masks, batch, h, w, g, boxes, assign, rois, ph, pw, out, s)
             : launch_crop<int64_t>(masks, batch, h, w, g, boxes, assign, rois, ph, pw, out, s);
}
