// Multilevel ROIAlign (crop_and_resize sampling) over P2..P5, for Hopper
// (sm_90a).
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
// Numerics follow ops/roi_align.py: positions (lo + (hi - lo) * t) * (H - 1)
// with jnp.linspace's t = p * (1 / (P - 1)) and t = 1 at the last sample, so
// a border-touching box lands exactly on H - 1;
// taps out of range read 0; the four products are summed in f32, in the
// plain version's order, with explicitly rounded operations, and rounded
// once to the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
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
  __shared__ float s_w[2][kMaxPool];  // fractional part, per axis
  __shared__ int s_lo[2][kMaxPool];   // tap 0 index
  __shared__ int s_hi[2][kMaxPool];   // tap 1 index
  __shared__ bool s_in[2][kMaxPool];  // sample inside the map

  const int box = blockIdx.x;
  const int b = box / n;
  const int level = levels[box];
  const int h = lv.h[level];
  const int w = lv.w[level];
  const T* f = static_cast<const T*>(lv.ptr[level]) + (size_t)b * h * w * c;

  // axis 0: y against h, axis 1: x against w
  for (int k = threadIdx.x; k < 2 * pool; k += blockDim.x) {
    const int axis = k / pool;
    const int p = k - axis * pool;
    const float lo = boxes[(size_t)box * 4 + axis];
    const float hi = boxes[(size_t)box * 4 + axis + 2];
    const float extent_m1 = __fsub_rn((float)(axis == 0 ? h : w), 1.0f);
    const float step = __fdiv_rn(1.0f, (float)(pool - 1));
    const float t = p == pool - 1 ? 1.0f : __fmul_rn((float)p, step);
    const float pos = __fmul_rn(__fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), t)), extent_m1);
    const float t0 = clampf(floorf(pos), 0.0f, extent_m1);
    const float t1 = clampf(__fadd_rn(t0, 1.0f), 0.0f, extent_m1);
    s_in[axis][p] = pos >= 0.0f && pos <= extent_m1;
    s_w[axis][p] = __fsub_rn(clampf(pos, 0.0f, extent_m1), t0);
    s_lo[axis][p] = (int)t0;
    s_hi[axis][p] = (int)t1;
  }
  __syncthreads();

  T* o = out + (size_t)box * pool * pool * c;
  const int pairs = c >> 1;
  for (int py = 0; py < pool; ++py) {
    const float wy = s_w[0][py];
    const T* row0 = f + (size_t)s_lo[0][py] * w * c;
    const T* row1 = f + (size_t)s_hi[0][py] * w * c;
    for (int px = 0; px < pool; ++px) {
      T* dst = o + ((size_t)py * pool + px) * c;
      const bool inside = s_in[0][py] && s_in[1][px];
      const float wx = s_w[1][px];
      const float w00 = __fmul_rn(__fsub_rn(1.0f, wy), __fsub_rn(1.0f, wx));
      const float w01 = __fmul_rn(__fsub_rn(1.0f, wy), wx);
      const float w10 = __fmul_rn(wy, __fsub_rn(1.0f, wx));
      const float w11 = __fmul_rn(wy, wx);
      const size_t x0 = (size_t)s_lo[1][px] * c;
      const size_t x1 = (size_t)s_hi[1][px] * c;
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int ch = q << 1;
        float a = 0.0f, bb = 0.0f;
        if (inside) {
          const float2 f00 = Pair<T>::to_float2(Pair<T>::load(row0 + x0 + ch));
          const float2 f01 = Pair<T>::to_float2(Pair<T>::load(row0 + x1 + ch));
          const float2 f10 = Pair<T>::to_float2(Pair<T>::load(row1 + x0 + ch));
          const float2 f11 = Pair<T>::to_float2(Pair<T>::load(row1 + x1 + ch));
          a = blend(f00.x, f01.x, f10.x, f11.x, w00, w01, w10, w11);
          bb = blend(f00.y, f01.y, f10.y, f11.y, w00, w01, w10, w11);
        }
        Pair<T>::store(dst + ch, a, bb);
      }
    }
  }
}

}  // namespace

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
