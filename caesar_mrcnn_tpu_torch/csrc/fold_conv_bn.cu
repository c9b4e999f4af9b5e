// Frozen batch norms folded into the convolutions before them: one launch
// for a whole table of (conv, batch norm) pairs.
//
// For pair i, with inv = scale / sqrt(var + eps) per output channel o:
//
//   w'[o, kh, kw, c] = w[o, c, kh, kw] * inv[o]       (OHWI: channels_last)
//   b'[o]            = (bias[o] - mean[o]) * inv[o] + shift[o]
//
// in f32, each operation rounded once (nvcc runs with --fmad=false and IEEE
// sqrt and division), then rounded to the output type: the arithmetic of
// ops/fold.py::fold_conv_bn_plain. The pairs' outputs lie end to end in two
// flat tensors.
//
// Each block folds whole output channels of one pair: it computes their
// inv once into shared memory and writes their biases, then streams their
// weights, reading OIHW and writing OHWI. Bound by bytes: 4 read and 2
// (bf16) written a weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 128;    // pairs a launch takes (the table is a kernel parameter, ~10 KB)
constexpr int kThreads = 256;
constexpr int kPerBlock = 8192;   // weights a block folds, about
constexpr int kMaxRows = 512;     // output channels a block folds, at most

struct Pair {
  const float* w;     // [cout, cin, k, k] contiguous
  const float *bias, *scale, *shift, *mean, *var;  // [cout]: the conv's bias, the batch norm's
  long long w_off;    // into the flat weights, in elements
  int b_off;          // into the flat biases
  int cout, cin, k;
  int rows;           // output channels a block folds
  int block0;         // the pair's first block
};

struct Table {
  Pair p[kMaxPairs];
  int n;
};

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_conv_bn_kernel(const __grid_constant__ Table t, float eps, T* __restrict__ w_out, T* __restrict__ b_out) {
  __shared__ int which;
  __shared__ float inv[kMaxRows];
  if (threadIdx.x == 0) {  // the last pair whose first block is at or before this one
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (t.p[mid].block0 <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
    }
    which = lo;
  }
  __syncthreads();
  const Pair& q = t.p[which];
  const int o0 = ((int)blockIdx.x - q.block0) * q.rows;
  const int rows = min(q.rows, q.cout - o0);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int o = o0 + r;
    const float s = q.scale[o] / sqrtf(q.var[o] + eps);
    inv[r] = s;
    b_out[q.b_off + o] = cast_out<T>((q.bias[o] - q.mean[o]) * s + q.shift[o]);
  }
  __syncthreads();
  const int kk = q.k * q.k;
  const int per_o = q.cin * kk;
  const int count = rows * per_o;
  const float* __restrict__ w = q.w + (long long)o0 * per_o;
  T* __restrict__ out = w_out + q.w_off + (long long)o0 * per_o;
  if (kk == 1) {  // 1x1: OIHW and OHWI are one order
    for (int e = threadIdx.x; e < count; e += kThreads) out[e] = cast_out<T>(__ldg(w + e) * inv[e / per_o]);
    return;
  }
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int r = e / per_o;
    const int rest = e - r * per_o;
    const int hw = rest / q.cin;
    const int c = rest - hw * q.cin;
    out[e] = cast_out<T>(__ldg(w + r * per_o + c * kk + hw) * inv[r]);
  }
}

}  // namespace

// n pairs (1 to kMaxPairs); ptrs: 6 device pointers a pair (w, bias,
// scale, shift, mean, var); w_off, b_off:
// each pair's offset into the flat outputs, in elements; dims: (cout, cin,
// k) a pair. dtype: 0 f32, 1 bf16, of both outputs. One launch.
extern "C" int caesar_fold_conv_bn(const void* const* ptrs, const long long* w_off, const int* b_off,
                                   const int* dims, int n, float eps, int dtype, void* w_out, void* b_out,
                                   void* stream) {
  if (n < 1 || n > kMaxPairs || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Table t;  // the kernel's parameter, copied by the launch
  t.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    const float* const* p = reinterpret_cast<const float* const*>(ptrs) + 6 * (size_t)i;
    Pair& q = t.p[i];
    q.w = p[0];
    q.bias = p[1];
    q.scale = p[2];
    q.shift = p[3];
    q.mean = p[4];
    q.var = p[5];
    q.w_off = w_off[i];
    q.b_off = b_off[i];
    q.cout = dims[3 * i];
    q.cin = dims[3 * i + 1];
    q.k = dims[3 * i + 2];
    if (q.cout < 1 || q.cin < 1 || q.k < 1) return (int)cudaErrorInvalidValue;
    const int per_o = q.cin * q.k * q.k;
    q.rows = kPerBlock / per_o;
    q.rows = q.rows < 1 ? 1 : q.rows > kMaxRows ? kMaxRows : q.rows;
    q.block0 = blocks;
    blocks += (q.cout + q.rows - 1) / q.rows;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fold_conv_bn_kernel<float><<<blocks, kThreads, 0, s>>>(t, eps, static_cast<float*>(w_out),
                                                           static_cast<float*>(b_out));
  } else {
    fold_conv_bn_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        t, eps, static_cast<__nv_bfloat16*>(w_out), static_cast<__nv_bfloat16*>(b_out));
  }
  return (int)cudaGetLastError();
}
