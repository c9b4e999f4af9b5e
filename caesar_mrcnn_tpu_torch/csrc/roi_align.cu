// Multilevel ROIAlign (crop_and_resize sampling) over P2..P5, for Hopper
// (sm_90a), and its gradient in the levels (roi_align_backward_kernel,
// below): the VJP of ops/roi_align.py::multilevel_roi_align_batched, which
// the JAX training graph takes through XLA and the two Pallas kernels do
// not have.
//
// Replaces: caesar_mrcnn_tpu/ops/roi_align_pallas.py::multilevel_roi_align_vmem
// and ::multilevel_roi_align_pallas (the two Pallas TPU kernels), and the XLA
// gather they stand beside, ops/roi_align.py::multilevel_roi_align_batched,
// which the JAX detect graph runs at models/mask_rcnn.py:208 and :234. All
// three compute the same function.
//
// What bounds it on the card: memory. Each output element reads four taps
// and does eight flops; at the detect shapes (8 x 1000 boxes x 7x7 x 256
// bf16, and 8 x 100 x 14x14 x 256) the taps come from a ~11 MB-per-image
// pyramid and the output is written once.
//
// Design: one block per (image, box). The block computes the box's sample
// positions, clamped tap indices and bilinear weights once, in shared
// memory; its threads then run across channels with paired loads
// (__nv_bfloat162 or float2) on the NHWC level map, neighbouring threads on
// neighbouring addresses. The Pallas kernels' 32x40 tile and their level
// bump for slivers existed only because the TPU tile was fixed; taps are
// read straight from global memory here, so the exact FPN area rule stands
// (levels come from the wrapper, computed by the plain version's
// roi_levels).
//
// Numerics follow ops/roi_align.py: sample positions, taps and weights from
// sampling.cuh (shared with the backward and crop_and_resize.cu); samples
// outside the map read 0; the four products are summed in f32, in the plain
// version's order, with explicitly rounded operations, and rounded once to
// the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"

namespace {

using caesar::Tap;

constexpr int kMaxPool = 32;

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float2 to_float2(float2 v) { return v; }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

// The box's taps along y (axis 0, against h) and x (axis 1, against w),
// computed once per block into shared memory.
__device__ __forceinline__ void box_taps(Tap (&taps)[2][kMaxPool],
                                         const float* box, int h, int w,
                                         int pool) {
  for (int k = threadIdx.x; k < 2 * pool; k += blockDim.x) {
    const int axis = k / pool;
    const int p = k - axis * pool;
    taps[axis][p] = caesar::sample(box[axis], box[axis + 2],
                                   axis == 0 ? h : w, pool, p);
  }
  __syncthreads();
}

// Bilinear weights of the four taps (00, 01, 10, 11 = y, x) of one sample.
struct Corners {
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(float wy, float wx) {
  Corners k;
  k.w00 = __fmul_rn(__fsub_rn(1.0f, wy), __fsub_rn(1.0f, wx));
  k.w01 = __fmul_rn(__fsub_rn(1.0f, wy), wx);
  k.w10 = __fmul_rn(wy, __fsub_rn(1.0f, wx));
  k.w11 = __fmul_rn(wy, wx);
  return k;
}

// ((f00*w00 + f01*w01) + f10*w10) + f11*w11, each step rounded.
__device__ __forceinline__ float blend(float f00, float f01, float f10,
                                       float f11, float w00, float w01,
                                       float w10, float w11) {
  float acc = __fadd_rn(__fmul_rn(f00, w00), __fmul_rn(f01, w01));
  acc = __fadd_rn(acc, __fmul_rn(f10, w10));
  return __fadd_rn(acc, __fmul_rn(f11, w11));
}

// grid B*N, block threads over channel pairs. out: [B, N, pool, pool, C].
template <typename T>
__global__ void roi_align_kernel(Levels lv, int c, int n,
                                 const float* __restrict__ boxes,
                                 const int32_t* __restrict__ levels, int pool,
                                 T* __restrict__ out) {
  __shared__ Tap taps[2][kMaxPool];

  const int box = blockIdx.x;
  const int b = box / n;
  const int level = levels[box];
  const int h = lv.h[level];
  const int w = lv.w[level];
  const T* f = static_cast<const T*>(lv.ptr[level]) + (size_t)b * h * w * c;
  box_taps(taps, boxes + (size_t)box * 4, h, w, pool);

  T* o = out + (size_t)box * pool * pool * c;
  const int pairs = c >> 1;
  for (int py = 0; py < pool; ++py) {
    const Tap ty = taps[0][py];
    const T* row0 = f + (size_t)ty.lo * w * c;
    const T* row1 = f + (size_t)ty.hi * w * c;
    for (int px = 0; px < pool; ++px) {
      T* dst = o + ((size_t)py * pool + px) * c;
      const Tap tx = taps[1][px];
      const bool inside = ty.inside && tx.inside;
      const Corners k = corners(ty.w, tx.w);
      const size_t x0 = (size_t)tx.lo * c;
      const size_t x1 = (size_t)tx.hi * c;
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int ch = q << 1;
        float a = 0.0f, bb = 0.0f;
        if (inside) {
          const float2 f00 = Pair<T>::to_float2(Pair<T>::load(row0 + x0 + ch));
          const float2 f01 = Pair<T>::to_float2(Pair<T>::load(row0 + x1 + ch));
          const float2 f10 = Pair<T>::to_float2(Pair<T>::load(row1 + x0 + ch));
          const float2 f11 = Pair<T>::to_float2(Pair<T>::load(row1 + x1 + ch));
          a = blend(f00.x, f01.x, f10.x, f11.x, k.w00, k.w01, k.w10, k.w11);
          bb = blend(f00.y, f01.y, f10.y, f11.y, k.w00, k.w01, k.w10, k.w11);
        }
        Pair<T>::store(dst + ch, a, bb);
      }
    }
  }
}

// Backward: the VJP of roi_align_kernel with respect to the levels (boxes
// carry no gradient). Same grid and the same taps and weights as the
// forward (box_taps, corners); each inside sample scatter-adds
// grad * w_tap into its four taps with f32 atomicAdd on an f32 scratch copy
// of the level (grads: [B, H_l, W_l, C] f32 per level, zeroed by the
// caller). Taps the forward read as 0 (samples outside the map) get
// nothing. Atomics make the order of the sums, and so the f32 rounding,
// vary from run to run.
//
// What bounds it on the card: f32 atomics. At the training shapes (8 x 512
// boxes x 7x7 and 8 x 168 x 14x14, C = 256) a call issues 205M or 270M
// atomicAdds, and coarse levels are contended (a P5 pixel can receive
// thousands of them); neighbouring threads add to neighbouring
// channels, so each warp's atomics fall on consecutive addresses.
template <typename T>
__global__ void roi_align_backward_kernel(Levels grads, int c, int n,
                                          const float* __restrict__ boxes,
                                          const int32_t* __restrict__ levels,
                                          int pool,
                                          const T* __restrict__ grad_out) {
  __shared__ Tap taps[2][kMaxPool];

  const int box = blockIdx.x;
  const int b = box / n;
  const int level = levels[box];
  const int h = grads.h[level];
  const int w = grads.w[level];
  float* g = static_cast<float*>(const_cast<void*>(grads.ptr[level])) +
             (size_t)b * h * w * c;
  box_taps(taps, boxes + (size_t)box * 4, h, w, pool);

  const T* go = grad_out + (size_t)box * pool * pool * c;
  const int pairs = c >> 1;
  for (int py = 0; py < pool; ++py) {
    const Tap ty = taps[0][py];
    if (!ty.inside) continue;
    float* row0 = g + (size_t)ty.lo * w * c;
    float* row1 = g + (size_t)ty.hi * w * c;
    for (int px = 0; px < pool; ++px) {
      const Tap tx = taps[1][px];
      if (!tx.inside) continue;
      const Corners k = corners(ty.w, tx.w);
      const size_t x0 = (size_t)tx.lo * c;
      const size_t x1 = (size_t)tx.hi * c;
      const T* src = go + ((size_t)py * pool + px) * c;
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int ch = q << 1;
        const float2 d = Pair<T>::to_float2(Pair<T>::load(src + ch));
        atomicAdd(row0 + x0 + ch, __fmul_rn(d.x, k.w00));
        atomicAdd(row0 + x0 + ch + 1, __fmul_rn(d.y, k.w00));
        atomicAdd(row0 + x1 + ch, __fmul_rn(d.x, k.w01));
        atomicAdd(row0 + x1 + ch + 1, __fmul_rn(d.y, k.w01));
        atomicAdd(row1 + x0 + ch, __fmul_rn(d.x, k.w10));
        atomicAdd(row1 + x0 + ch + 1, __fmul_rn(d.y, k.w10));
        atomicAdd(row1 + x1 + ch, __fmul_rn(d.x, k.w11));
        atomicAdd(row1 + x1 + ch + 1, __fmul_rn(d.y, k.w11));
      }
    }
  }
}

}  // namespace

// grad_out: [B, N, pool, pool, C] in dtype (0 = float32, 1 = bfloat16);
// g2..g5: f32 level gradients [B, H_l, W_l, C], zeroed, accumulated into.
extern "C" int caesar_roi_align_backward(void* g2, void* g3, void* g4, void* g5,
                                         int h2, int w2, int h3, int w3,
                                         int h4, int w4, int h5, int w5,
                                         int batch, int c, const float* boxes,
                                         const int32_t* levels, int n, int pool,
                                         int dtype, const void* grad_out,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Levels lv;
  lv.ptr[0] = g2; lv.ptr[1] = g3; lv.ptr[2] = g4; lv.ptr[3] = g5;
  lv.h[0] = h2; lv.h[1] = h3; lv.h[2] = h4; lv.h[3] = h5;
  lv.w[0] = w2; lv.w[1] = w3; lv.w[2] = w4; lv.w[3] = w5;
  if (pool < 2 || pool > kMaxPool || (c & 1)) return (int)cudaErrorInvalidValue;
  const int pairs = c / 2;
  const int threads = pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32;
  const unsigned int blocks = (unsigned int)batch * (unsigned int)n;
  if (dtype == 0) {
    roi_align_backward_kernel<float><<<blocks, threads, 0, s>>>(
        lv, c, n, boxes, levels, pool, static_cast<const float*>(grad_out));
  } else if (dtype == 1) {
    roi_align_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        lv, c, n, boxes, levels, pool,
        static_cast<const __nv_bfloat16*>(grad_out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. levels: [B*N] int32 in 0..3.
extern "C" int caesar_roi_align(const void* p2, const void* p3, const void* p4,
                                const void* p5, int h2, int w2, int h3, int w3,
                                int h4, int w4, int h5, int w5, int batch,
                                int c, const float* boxes,
                                const int32_t* levels, int n, int pool,
                                int dtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Levels lv;
  lv.ptr[0] = p2; lv.ptr[1] = p3; lv.ptr[2] = p4; lv.ptr[3] = p5;
  lv.h[0] = h2; lv.h[1] = h3; lv.h[2] = h4; lv.h[3] = h5;
  lv.w[0] = w2; lv.w[1] = w3; lv.w[2] = w4; lv.w[3] = w5;
  if (pool < 2 || pool > kMaxPool || (c & 1)) return (int)cudaErrorInvalidValue;
  const int pairs = c / 2;
  const int threads = pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32;
  const unsigned int blocks = (unsigned int)batch * (unsigned int)n;
  if (dtype == 0) {
    roi_align_kernel<float><<<blocks, threads, 0, s>>>(
        lv, c, n, boxes, levels, pool, static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        lv, c, n, boxes, levels, pool, static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
