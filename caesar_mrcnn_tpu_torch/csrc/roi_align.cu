// Multilevel ROIAlign (crop_and_resize sampling) over P2..P5, for Hopper
// (sm_90a): the forward (roi_align_kernel) and its gradient in the levels
// (roi_align_backward_kernel, below), the VJP of
// ops/roi_align.py::multilevel_roi_align_batched, which the JAX training
// graph takes through XLA and the two Pallas kernels do not have.
//
// Replaces: caesar_mrcnn_tpu/ops/roi_align_pallas.py::multilevel_roi_align_vmem
// and ::multilevel_roi_align_pallas (the two Pallas TPU kernels), and the XLA
// gather they stand beside, ops/roi_align.py::multilevel_roi_align_batched,
// which the JAX detect graph runs at models/mask_rcnn.py:208 and :234. All
// three compute the same function.
//
// Both kernels find each box's FPN level themselves, from the box, with the
// plain version's exact area rule (sampling.cuh::fpn_level); their wrappers
// launch nothing else before them. The Pallas kernels' 32x40 tile and their
// level bump for slivers existed only because the TPU tile was fixed; taps
// are read straight from global memory here, so the exact rule stands.
//
// Forward. What bounds it on the card: memory. The output is written once
// (8 x 1000 x 7x7 x 256 bf16 = 200 MB at the detect path's proposals, 0.06
// ms at 3.35 TB/s) and the taps read at least the level pixels the boxes
// touch (kernel_bench.roi_align_pixels; at most the ~11 MB pyramid of an
// image); eight flops per output element. What holds it now (PERF.md): the
// output's stores alone take half its time (2.7 TB/s), and its taps, four
// 16-byte reads per output vector, the other half; it reaches 0.5-0.66 of
// its bound.
//
// Design:
//  - One warp per (box, part), four warps per block; a part is a run of the
//    box's sample rows. Boxes are split into parts until the grid holds ~64
//    warps per SM (detect N=1000 at pool 7: 8000 boxes in 2 parts; N=100
//    at pool 14: 800 boxes in 11).
//  - The warp computes its box's level and its 2 x pool taps itself (lane p
//    < pool: the y and x taps of sample p) into its own slot of shared
//    memory, behind __syncwarp: no block barrier, so each warp loads as
//    soon as its own taps are ready.
//  - The part's output [rows, pool, C] is contiguous, cut into vectors of
//    16 bytes (8 bf16 or 4 f32 channels; 8 or 4 bytes where C or a level's
//    alignment does not allow 16: the wrapper picks the widest). Lane l
//    handles vectors l, l + 32, ...: stores are coalesced, and at C=256
//    bf16 a warp covers one sample's channel row.
//  - Each lane issues the four taps of kFwdUnroll (2) vectors (read-only
//    path, __ldg, so taps that neighbouring samples repeat hit L1) before
//    it blends any of them.
//  - pool is a template parameter for 7 and 14 (the paths' pools), with a
//    generic instantiation for 2..32.
//
// Numerics follow ops/roi_align.py: sample positions, taps and weights from
// sampling.cuh (shared with the backward and crop_and_resize.cu); samples
// outside the map read 0; the four products are summed in f32, in the plain
// version's order, with explicitly rounded operations, and rounded once to
// the feature dtype: results equal roi_align_plain's on the card.

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

// The box's taps along y (axis 0, against h) and x (axis 1, against w),
// computed once per block into shared memory (the backward's prologue).
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
                                       float f11, const Corners& k) {
  float acc = __fadd_rn(__fmul_rn(f00, k.w00), __fmul_rn(f01, k.w01));
  acc = __fadd_rn(acc, __fmul_rn(f10, k.w10));
  return __fadd_rn(acc, __fmul_rn(f11, k.w11));
}

constexpr int kFwdWarps = 4;   // warps per block
constexpr int kFwdUnroll = 2;  // vectors whose four taps a lane has in flight
constexpr int kFwdWarpsPerSM = 64;  // the grid the wrapper aims at, per SM

// A vector of W 32-bit words: 4W bytes of channels.
template <int W>
struct Words {
  unsigned int w[W];
};

template <int W>
__device__ __forceinline__ Words<W> load_words(const void* p) {
  Words<W> r;
  if constexpr (W == 4) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
    r.w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const Words<W>& r) {
  if constexpr (W == 4) {
    *static_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
    *static_cast<unsigned int*>(p) = r.w[0];
  }
}

// The channels of one 32-bit word: one f32, or two bf16 (the first in the
// low half). bf16 widens to f32 exactly by a shift.
template <typename T>
struct Packed;

template <>
struct Packed<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float get(unsigned int w, int) { return __uint_as_float(w); }
  static __device__ __forceinline__ unsigned int put(const float* v) { return __float_as_uint(v[0]); }
};

template <>
struct Packed<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float get(unsigned int w, int j) {
    return __uint_as_float(j == 0 ? w << 16 : w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned int put(const float* v) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
};

// grid: ceil(boxes * parts / kFwdWarps) blocks of kFwdWarps warps, one warp
// per (box, part). out: [B, N, pool, pool, C], C a multiple of the vector's
// channels; each level's image h * w * C below 2^31 elements. POOL = 0 reads
// the pool from pool_arg.
template <typename T, int W, int POOL>
__global__ void __launch_bounds__(kFwdWarps * 32)
roi_align_kernel(Levels lv, int c, int n, int boxes_total,
                 const float* __restrict__ boxes, float inv_denom,
                 int pool_arg, int parts, T* __restrict__ out) {
  using P = Packed<T>;
  constexpr int V = W * P::kPerWord;  // channels per vector
  const int pool = POOL > 0 ? POOL : pool_arg;
  __shared__ Tap taps[kFwdWarps][2][kMaxPool];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kFwdWarps + warp;
  if (unit >= boxes_total * parts) return;  // no block barrier follows
  const int box = unit / parts;
  const int part = unit - box * parts;
  const float* bx = boxes + (size_t)box * 4;
  const int level = caesar::fpn_level(bx, inv_denom);
  const int h = lv.h[level];
  const int w = lv.w[level];
  const T* f = static_cast<const T*>(lv.ptr[level]) + (size_t)(box / n) * h * w * c;
  Tap(&ty)[kMaxPool] = taps[warp][0];
  Tap(&tx)[kMaxPool] = taps[warp][1];
  if (lane < pool) {
    ty[lane] = caesar::sample(bx[0], bx[2], h, pool, lane);
    tx[lane] = caesar::sample(bx[1], bx[3], w, pool, lane);
  }
  __syncwarp();

  // The part's vectors: vector i is (sample s, channel vector q), s * nvec +
  // q past the part's first; the lane keeps (s, q) of its next vector.
  const int row0 = part * pool / parts, row1 = (part + 1) * pool / parts;
  const int nvec = c / V;
  const int items = (row1 - row0) * pool * nvec;
  T* o = out + ((size_t)box * pool + row0) * pool * c;
  const int ds = 32 / nvec, dq = 32 - ds * nvec;
  int s = row0 * pool + lane / nvec, q = lane % nvec;
  const int wc = w * c;
  for (int i = lane; i < items; i += 32 * kFwdUnroll) {
    Words<W> t00[kFwdUnroll], t01[kFwdUnroll], t10[kFwdUnroll], t11[kFwdUnroll];
    Corners k[kFwdUnroll];
    bool live[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      live[u] = false;
      if (i + 32 * u < items) {
        const int py = s / pool;
        const Tap a = ty[py], b = tx[s - py * pool];
        live[u] = a.inside && b.inside;
        if (live[u]) {
          k[u] = corners(a.w, b.w);
          const T* r0 = f + a.lo * wc + q * V;
          const T* r1 = f + a.hi * wc + q * V;
          t00[u] = load_words<W>(r0 + b.lo * c);
          t01[u] = load_words<W>(r0 + b.hi * c);
          t10[u] = load_words<W>(r1 + b.lo * c);
          t11[u] = load_words<W>(r1 + b.hi * c);
        }
      }
      s += ds, q += dq;
      if (q >= nvec) q -= nvec, ++s;
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (i + 32 * u >= items) break;
      Words<W> r;
      if (live[u]) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float v[P::kPerWord];
#pragma unroll
          for (int e = 0; e < P::kPerWord; ++e) {
            v[e] = blend(P::get(t00[u].w[j], e), P::get(t01[u].w[j], e),
                         P::get(t10[u].w[j], e), P::get(t11[u].w[j], e), k[u]);
          }
          r.w[j] = P::put(v);
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) r.w[j] = 0u;  // +0.0 in either dtype
      }
      store_words<W>(o + (size_t)(i + 32 * u) * V, r);
    }
  }
}

// Boxes are split into parts (runs of sample rows) until the grid holds
// kFwdWarpsPerSM warps per SM, so that small cases still fill the card.
int forward_parts(int boxes_total, int pool) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int want = (sms * kFwdWarpsPerSM + boxes_total - 1) / boxes_total;
  return want < 1 ? 1 : (want > pool ? pool : want);
}

template <typename T, int W, int POOL>
void launch_forward(cudaStream_t s, const Levels& lv, int c, int n, int boxes_total,
                    const float* boxes, float inv_denom, int pool, void* out) {
  const int parts = forward_parts(boxes_total, pool);
  const unsigned int blocks =
      (unsigned int)(((long)boxes_total * parts + kFwdWarps - 1) / kFwdWarps);
  roi_align_kernel<T, W, POOL><<<blocks, kFwdWarps * 32, 0, s>>>(
      lv, c, n, boxes_total, boxes, inv_denom, pool, parts, static_cast<T*>(out));
}

template <typename T, int W>
void launch_forward_pool(cudaStream_t s, const Levels& lv, int c, int n, int boxes_total,
                         const float* boxes, float inv_denom, int pool, void* out) {
  auto fn = pool == 7 ? launch_forward<T, W, 7>
                      : pool == 14 ? launch_forward<T, W, 14> : launch_forward<T, W, 0>;
  fn(s, lv, c, n, boxes_total, boxes, inv_denom, pool, out);
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
//  - One block per box, 256 threads. Each thread computes the box's level
//    (fpn_level, as the forward does). The block finds the box's footprint
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
                          float inv_denom, int pool,
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
  const int level = caesar::fpn_level(boxes + (size_t)box * 4, inv_denom);
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
                     int n, const float* boxes, float inv_denom, int pool,
                     const void* grad_out) {
  roi_align_backward_kernel<T, V><<<blocks, kBwdThreads, 0, s>>>(
      lv, c, n, boxes, inv_denom, pool, static_cast<const T*>(grad_out));
}

Levels make_levels(const void* l2, const void* l3, const void* l4, const void* l5,
                   int h2, int w2, int h3, int w3, int h4, int w4, int h5, int w5) {
  Levels lv;
  lv.ptr[0] = l2; lv.ptr[1] = l3; lv.ptr[2] = l4; lv.ptr[3] = l5;
  lv.h[0] = h2; lv.h[1] = h3; lv.h[2] = h4; lv.h[3] = h5;
  lv.w[0] = w2; lv.w[1] = w3; lv.w[2] = w4; lv.w[3] = w5;
  return lv;
}

}  // namespace

// Both entry points: boxes [B*N, 4] f32 normalized (y1, x1, y2, x2);
// inv_denom = f32(1 / f32(224 / sqrt(image area))), the level rule's scale
// (fpn_level); dtype 0 = float32, 1 = bfloat16.

// grad_out: [B, N, pool, pool, C] in dtype, C even, 16-byte aligned;
// g2..g5: f32 level gradients [B, H_l, W_l, C], 8-byte aligned (16 where 4
// divides C), zeroed, accumulated into.
extern "C" int caesar_roi_align_backward(void* g2, void* g3, void* g4, void* g5,
                                         int h2, int w2, int h3, int w3,
                                         int h4, int w4, int h5, int w5,
                                         int batch, int c, const float* boxes,
                                         int n, int pool, float inv_denom,
                                         int dtype, const void* grad_out,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(g2, g3, g4, g5, h2, w2, h3, w3, h4, w4, h5, w5);
  if (pool < 2 || pool > kMaxPool || (c & 1)) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)batch * (unsigned int)n;
  if (blocks == 0) return (int)cudaSuccess;
  const bool quads = (c & 3) == 0;
  if (dtype == 0) {
    (quads ? launch_backward<float, 4> : launch_backward<float, 2>)(
        blocks, s, lv, c, n, boxes, inv_denom, pool, grad_out);
  } else if (dtype == 1) {
    (quads ? launch_backward<__nv_bfloat16, 4> : launch_backward<__nv_bfloat16, 2>)(
        blocks, s, lv, c, n, boxes, inv_denom, pool, grad_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// p2..p5: levels [B, H_l, W_l, C] in dtype, each aligned to vec_bytes and
// each image below 2^31 elements; out: [B, N, pool, pool, C], aligned to
// vec_bytes. vec_bytes (16, 8 or 4; 16 or 8 for f32) divides C's bytes:
// the width of each lane's loads and stores.
extern "C" int caesar_roi_align(const void* p2, const void* p3, const void* p4,
                                const void* p5, int h2, int w2, int h3, int w3,
                                int h4, int w4, int h5, int w5, int batch,
                                int c, const float* boxes, int n, int pool,
                                float inv_denom, int dtype, int vec_bytes,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(p2, p3, p4, p5, h2, w2, h3, w3, h4, w4, h5, w5);
  const int itemsize = dtype == 0 ? 4 : 2;
  if (pool < 2 || pool > kMaxPool || (c & 1) || (dtype != 0 && dtype != 1) ||
      (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4) || vec_bytes < 2 * itemsize ||
      (c * itemsize) % vec_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int boxes_total = batch * n;
  if (boxes_total == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    (vec_bytes == 16 ? launch_forward_pool<float, 4> : launch_forward_pool<float, 2>)(
        s, lv, c, n, boxes_total, boxes, inv_denom, pool, out);
  } else {
    (vec_bytes == 16 ? launch_forward_pool<__nv_bfloat16, 4>
     : vec_bytes == 8 ? launch_forward_pool<__nv_bfloat16, 2>
                      : launch_forward_pool<__nv_bfloat16, 1>)(
        s, lv, c, n, boxes_total, boxes, inv_denom, pool, out);
  }
  return (int)cudaGetLastError();
}
