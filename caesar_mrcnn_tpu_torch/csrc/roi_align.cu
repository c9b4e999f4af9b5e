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
// carry no gradient), into f32 level gradients [B, H_l, W_l, C] zeroed by
// the caller, with the forward's taps and weights (box_taps). Taps the
// forward read as 0 (samples outside the map) get nothing.
//
// Replaces an earlier design that kept the forward's grid and issued eight
// scalar f32 atomicAdds to device memory per thread per sample (205M per
// call at 8 x 512 boxes x 7x7 x 256 channels, 270M at 8 x 168 x 14x14).
// Those serialise at L2: the training path's ROIs are small and go to P2,
// where a 16-pixel box is 4 pixels wide and its 49 samples land on about
// 5x5 pixels, so the same thread adds to the same address again and again.
//
// What bounds it on the card: memory in principle: grad_out (103 MB at pool
// 7 in bf16) read once and the gradients written once, ~0.04 ms. A first
// redesign merged the taps of a box in shared memory with f32 atomicAdd,
// which sm_90 compiles to a compare-and-swap loop (ATOMS.CAST.SPIN). This
// design has no atomics in shared memory and is 9-53% faster than that
// one, but still 0.10-0.35 ms at the training shapes (0.10-0.20 ms on a
// real train step's ROIs; PERF.md). What
// holds it there is not measured yet: each footprint pixel of each box
// still reaches device memory through a float4 atomic, and the training
// ROIs overlap (about 40 per source).
//
// Design: the bilinear weight of a tap is a product of a row weight and a
// column weight, so the gradient of a box is two small sums, each written
// by the one thread that owns it, with no atomics in shared memory.
//  - One block per box, 256 threads. The block finds the box's footprint
//    on its level (the bounding rows and columns of its inside taps) and,
//    for each footprint row and column, the range of samples whose taps
//    touch it and their weights along that axis, in shared memory.
//  - Column pass: for each sample row and footprint column, one thread
//    sums the row's samples that touch the column, weighted, for two
//    quads of channels (lanes on neighbouring quads, 8- or 16-byte loads
//    of grad_out), into a shared tile [pool][fw][channels].
//  - Row pass: for each footprint pixel, one thread sums the tile rows
//    that touch the pixel's row, weighted, and adds each quad to device
//    memory once, with one 16-byte vector atomicAdd (float4, sm_90).
//  - A thread walks its items with running indices (no division per
//    item) and shares each weight and loop step between its two quads:
//    fewer instructions per item took 0.01-0.07 ms off each call against
//    one quad per thread with a division per item (PERF.md).
//  - Channels go in passes of as many as the 32 KB tile holds. A box whose
//    footprint is wider or taller than 2 * pool has few repeated taps, and
//    pools above kBwdReach do not fit the weight tables: those take a
//    direct path, each thread adding four channels of one sample to its
//    four taps with float4 atomics.
//  - A channel count that is even but not a multiple of 4 runs the same
//    code on pairs of channels (V = 2: 4- or 8-byte loads, float2 atomics).
// Boxes add to device memory in any order, so the f32 rounding varies from
// run to run; and the separable sums round differently from the forward's
// tap weights (products of the two), well inside the test's 1e-5 of each
// element's absolute-contribution sum.
constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 8192;  // floats of the column-pass tile (32 KB)
constexpr int kBwdReach = 16;  // samples that can touch one footprint row or column (pool <= 16)
// Blocks per SM: the ~38 KB of shared memory of a block lets five share an
// SM, and the registers must let them too (at most 48 per thread). Without
// the bound the f32 quad kernel took 52, four blocks fitted, and the train
// step's ROIs took 12-24% longer (PERF.md).
constexpr int kBwdBlocksPerSM = 5;

// V consecutive channels as floats (V = 4: a quad; V = 2: a pair).
template <int V>
struct alignas(4 * V) Lanes {
  float v[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> zero_lanes() {
  Lanes<V> a;
#pragma unroll
  for (int i = 0; i < V; ++i) a.v[i] = 0.0f;
  return a;
}

// One 4V-byte load of f32, or one 2V-byte load of bf16.
template <int V>
__device__ __forceinline__ Lanes<V> load_lanes(const float* p) {
  Lanes<V> a;
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    a.v[0] = f.x, a.v[1] = f.y, a.v[2] = f.z, a.v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    a.v[0] = f.x, a.v[1] = f.y;
  }
  return a;
}
template <int V>
__device__ __forceinline__ Lanes<V> load_lanes(const __nv_bfloat16* p) {
  Lanes<V> a;
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    a.v[0] = f.x, a.v[1] = f.y, a.v[2] = e.x, a.v[3] = e.y;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    a.v[0] = f.x, a.v[1] = f.y;
  }
  return a;
}

template <int V>
__device__ __forceinline__ Lanes<V> scale_lanes(Lanes<V> v, float k) {
#pragma unroll
  for (int i = 0; i < V; ++i) v.v[i] = __fmul_rn(v.v[i], k);
  return v;
}

template <int V>
__device__ __forceinline__ void acc_lanes(Lanes<V>& a, const Lanes<V>& v, float k) {
#pragma unroll
  for (int i = 0; i < V; ++i) a.v[i] = __fadd_rn(a.v[i], __fmul_rn(v.v[i], k));
}

template <int V>
__device__ __forceinline__ bool any_lanes(const Lanes<V>& a) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < V; ++i) any |= a.v[i] != 0.0f;
  return any;
}

// One vector atomicAdd to device memory (float4 or float2, sm_90).
template <int V>
__device__ __forceinline__ void add_lanes(float* p, const Lanes<V>& v) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v.v[0], v.v[1]));
  }
}

// The weight sample tap t gives pixel v along its axis: 1 - w at tap 0, w
// at tap 1, their sum where both taps are v (clamped at the border).
__device__ __forceinline__ float axis_weight(const Tap& t, int v) {
  float k = 0.0f;
  if (t.lo == v) k = __fsub_rn(1.0f, t.w);
  if (t.hi == v) k = __fadd_rn(k, t.w);
  return k;
}

// grid B*N, block kBwdThreads; C a multiple of V.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
roi_align_backward_kernel(Levels grads, int c, int n,
                          const float* __restrict__ boxes,
                          const int32_t* __restrict__ levels, int pool,
                          const T* __restrict__ grad_out) {
  using L = Lanes<V>;
  __shared__ Tap taps[2][kMaxPool];
  __shared__ __align__(16) float tile_f[kBwdTile];  // [pool][fw][channels / V]
  __shared__ int span[4];  // first and last tap row, first and last tap column
  __shared__ int2 touch[2][2 * kBwdReach];  // per footprint row / column: samples [x, y) touching it
  __shared__ float weight[2][2 * kBwdReach][kBwdReach];  // their weights, from touch[].x on
  L* tile = reinterpret_cast<L*>(tile_f);

  const int box = blockIdx.x;
  const int b = box / n;
  const int level = levels[box];
  const int h = grads.h[level];
  const int w = grads.w[level];
  float* g = static_cast<float*>(const_cast<void*>(grads.ptr[level])) +
             (size_t)b * h * w * c;
  box_taps(taps, boxes + (size_t)box * 4, h, w, pool);
  if (threadIdx.x < 2) {
    int lo = 0x7fffffff, hi = -1;
    for (int p = 0; p < pool; ++p) {
      const Tap t = taps[threadIdx.x][p];
      if (t.inside) {
        lo = min(lo, t.lo);
        hi = max(hi, t.hi);
      }
    }
    span[2 * threadIdx.x] = lo;
    span[2 * threadIdx.x + 1] = hi;
  }
  __syncthreads();
  if (span[1] < 0 || span[3] < 0) return;  // no sample inside the map
  const int y0 = span[0], x0 = span[2];
  const int fh = span[1] - y0 + 1, fw = span[3] - x0 + 1;
  const T* go = grad_out + (size_t)box * pool * pool * c;

  if (fh > 2 * pool || fw > 2 * pool || pool > kBwdReach) {  // direct path
    const int vecs = c / V;
    const int samples = pool * pool;
    for (int i = threadIdx.x; i < samples * vecs; i += blockDim.x) {
      const int s = i / vecs;
      const int ch = (i - s * vecs) * V;
      const Tap ty = taps[0][s / pool];
      const Tap tx = taps[1][s % pool];
      if (!(ty.inside && tx.inside)) continue;
      const Corners k = corners(ty.w, tx.w);
      const L d = load_lanes<V>(go + (size_t)s * c + ch);
      float* row0 = g + (size_t)ty.lo * w * c + ch;
      float* row1 = g + (size_t)ty.hi * w * c + ch;
      add_lanes<V>(row0 + (size_t)tx.lo * c, scale_lanes<V>(d, k.w00));
      add_lanes<V>(row0 + (size_t)tx.hi * c, scale_lanes<V>(d, k.w01));
      add_lanes<V>(row1 + (size_t)tx.lo * c, scale_lanes<V>(d, k.w10));
      add_lanes<V>(row1 + (size_t)tx.hi * c, scale_lanes<V>(d, k.w11));
    }
    return;
  }

  for (int k = threadIdx.x; k < fh + fw; k += blockDim.x) {
    const int axis = k < fh ? 0 : 1;
    const int v = axis == 0 ? y0 + k : x0 + k - fh;
    int first = pool, end = 0;
    for (int p = 0; p < pool; ++p) {
      const Tap t = taps[axis][p];
      if (t.inside && (t.lo == v || t.hi == v)) {
        first = min(first, p);
        end = p + 1;
      }
    }
    const int e = axis == 0 ? k : k - fh;
    touch[axis][e] = make_int2(first, end);
    for (int p = first; p < end; ++p) {
      const Tap t = taps[axis][p];
      weight[axis][e][p - first] = t.inside ? axis_weight(t, v) : 0.0f;
    }
  }
  __syncthreads();

  // channels per pass: a multiple of V that the tile holds (fw <= 2 * pool)
  const int cpass = min(min(c, 2 * V * kBwdThreads), (kBwdTile / (pool * fw)) & ~(V - 1));
  for (int c0 = 0; c0 < c; c0 += cpass) {
    // Each thread keeps two vectors of channels (q and q + half) and walks
    // the pass's items (row, footprint column) in steps of `groups`.
    const int vecs = min(cpass, c - c0) / V;
    const int half = (vecs + 1) >> 1;
    const int groups = blockDim.x / half;
    const int q = threadIdx.x % half, first = threadIdx.x / half;
    const bool two = q + half < vecs;
    if (first < groups) {  // column pass: [sample row][footprint column]
      for (int r = first, py = 0, x = first; r < pool * fw; r += groups, x += groups) {
        while (x >= fw) x -= fw, ++py;
        L a0 = zero_lanes<V>(), a1 = a0;
        if (taps[0][py].inside) {
          const int2 rg = touch[1][x];
          const float* wk = weight[1][x];
          const T* src = go + ((size_t)py * pool + rg.x) * c + c0 + q * V;
          for (int j = 0; j < rg.y - rg.x; ++j, src += c) {
            const float k = wk[j];
            if (k == 0.0f) continue;
            acc_lanes<V>(a0, load_lanes<V>(src), k);
            if (two) acc_lanes<V>(a1, load_lanes<V>(src + half * V), k);
          }
        }
        tile[r * vecs + q] = a0;
        if (two) tile[r * vecs + q + half] = a1;
      }
    }
    __syncthreads();
    if (first < groups) {  // row pass: [footprint row][footprint column]
      for (int r = first, y = 0, x = first; r < fh * fw; r += groups, x += groups) {
        while (x >= fw) x -= fw, ++y;
        L a0 = zero_lanes<V>(), a1 = a0;
        const int2 rg = touch[0][y];
        const float* wk = weight[0][y];
        const L* col = tile + (rg.x * fw + x) * vecs + q;
        for (int j = 0; j < rg.y - rg.x; ++j, col += fw * vecs) {
          const float k = wk[j];
          if (k == 0.0f) continue;
          acc_lanes<V>(a0, col[0], k);
          if (two) acc_lanes<V>(a1, col[half], k);
        }
        float* dst = g + ((size_t)(y0 + y) * w + x0 + x) * c + c0 + q * V;
        if (any_lanes<V>(a0)) add_lanes<V>(dst, a0);
        if (two && any_lanes<V>(a1)) add_lanes<V>(dst + half * V, a1);
      }
    }
    __syncthreads();  // the next pass rewrites the tile
  }
}

template <typename T, int V>
void launch_backward(unsigned int blocks, cudaStream_t s, const Levels& lv, int c,
                     int n, const float* boxes, const int32_t* levels, int pool,
                     const void* grad_out) {
  roi_align_backward_kernel<T, V><<<blocks, kBwdThreads, 0, s>>>(
      lv, c, n, boxes, levels, pool, static_cast<const T*>(grad_out));
}

}  // namespace

// grad_out: [B, N, pool, pool, C] in dtype (0 = float32, 1 = bfloat16),
// C even, 16-byte aligned; g2..g5: f32 level gradients [B, H_l, W_l, C],
// 8-byte aligned (16 where 4 divides C), zeroed, accumulated into.
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
  const unsigned int blocks = (unsigned int)batch * (unsigned int)n;
  if (blocks == 0) return (int)cudaSuccess;
  const bool quads = (c & 3) == 0;
  if (dtype == 0) {
    (quads ? launch_backward<float, 4> : launch_backward<float, 2>)(
        blocks, s, lv, c, n, boxes, levels, pool, grad_out);
  } else if (dtype == 1) {
    (quads ? launch_backward<__nv_bfloat16, 4> : launch_backward<__nv_bfloat16, 2>)(
        blocks, s, lv, c, n, boxes, levels, pool, grad_out);
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
