// int8 convolution with int32 accumulation and an f32 epilogue, and the
// per-tensor int8 quantizer in front of it, for Hopper (sm_90a).
//
// Replaces: the int8 convolutions of the JAX package's serving graph,
// caesar_mrcnn_tpu/models/backbone_int8.py:276 and models/heads_int8.py:279
// (lax.conv_general_dilated on int8 NHWC x HWIO with
// preferred_element_type=int32, then acc * sw + b in f32), and the quantizer
// before each (backbone_int8.py:272, heads_int8.py:276: clip(round(x / s_in),
// -127, 127) as int8). XLA compiled both there; PyTorch has no int8
// convolution on CUDA, so both are written here. One detect batch of the
// serving flagship (ResNet-101, 512^2, batch 8, 512 proposals, 100
// detections) runs 123 convolutions and 123 quantizers.
//
// What bounds the convolution on the card: at most sites the int8 tensor
// cores. The batch's 123 sites are 2.14 T int8 operations, 1.08 ms at
// 1,979 TOPS: the mask head 0.74 T (M = 800 x 196, K = 2304, N = 256, four
// times), the RPN's shared conv 0.41 T (N = 512 over the five levels), the
// classifier's fc1 0.11 T (K = 12,544). The f32 output is 4 bytes per
// element against K int8 operations per element, so sites with a small K
// and a large M are bound by their stores instead: the stem (K = 147, 134
// MB of output, 0.04 ms at 3.35 TB/s against 0.005 ms of operations) and
// the 1x1 convs of the first stages (kernel_bench.conv_int8_bound counts
// each site). The quantizer reads 2 or 4 bytes and writes 1 per element:
// bound by memory.
//
// Design of the convolution: an implicit GEMM. M = B Ho Wo output pixels,
// N = Cout, K = kh kw Cin in (ky, kx, ci) order, the order of the packed
// weights [Cout, kh, kw, Cin]. A block of 256 threads (8 warps, 2 x 4)
// computes a 128 x 128 tile of the output, each warp 64 x 32 with
// mma.sync.m16n8k32 (s8 x s8 -> s32), stepping through K 64 bytes at a time
// with two stages in shared memory. A rows are gathered from the NHWC input:
// row m is the pixel (b, oy, ox), column k the tap (ky, kx) and channel ci,
// read at (oy * stride - pad_top + ky, ox * stride - pad_left + kx); taps in
// the padding read 0. Where 16 divides Cin (every site but the stem), a
// 16-byte chunk of K lies inside one tap and comes in one cp.async (zero
// filled where masked); the stem (Cin = 3, K = 147) and any other Cin load
// byte by byte. Shared rows are 80 bytes, so a warp's 32-bit fragment reads
// hit 32 distinct banks. |acc| <= 12,544 x 127^2 < 2^31: no overflow.
// Epilogue: the int32 sum to f32, times sw[n], plus b[n], each rounded
// (__fmul_rn, __fadd_rn: no contraction, so the result equals the plain
// PyTorch version bit for bit), an optional ReLU, stored as f32 NHWC; or
// the raw int32 sums, for the checks. Later work: wgmma and TMA, and the
// next conv's quantizer fused into this epilogue.
//
// The quantizer divides (IEEE division, __fdiv_rn, as the JAX code divides:
// never the product with the reciprocal), rounds half to even (rintf, like
// jnp.round and torch.round) and clips to +-127; 16-byte loads, one grid-
// stride loop.
//
// Triton's rule (elementwise passes and reductions) does not cover the
// convolution, which is neither, so both kernels are CUDA C++.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBN = 128;        // output channels per block
constexpr int kBK = 64;         // bytes of K per stage
constexpr int kRow = kBK + 16;  // shared row pitch: 80 bytes, conflict-free fragment reads
constexpr int kThreads = 256;

struct ConvArgs {
  const int8_t* x;  // [B, H, W, C]
  const int8_t* w;  // [Cout, k, k, C]
  const float* sw;  // [Cout]
  const float* b;   // [Cout]
  void* out;        // [B, Ho, Wo, Cout] f32, or int32 sums
  int h, w_, c, ho, wo, cout, k, stride, pt, pl, m, kdim, relu;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage of A (128 pixels x 64 bytes of K) and B (128 channels x 64
// bytes) with 16-byte cp.async: each thread two chunks of each, all at the
// same k (16 divides Cin, so a chunk never crosses a tap).
__device__ __forceinline__ void load_stage_vec(const ConvArgs& p, int8_t* as, int8_t* bs, int k0, int m0,
                                               int n0, const int8_t* const* arow, const int* iy0,
                                               const int* ix0) {
  const int tid = threadIdx.x;
  const int col = (tid & 3) * 16;
  const int k = k0 + col;
  const bool kval = k < p.kdim;
  int ky = 0, kx = 0, ci = 0;
  if (kval) {
    const int tap = k / p.c;
    ci = k - tap * p.c;
    ky = tap / p.k;
    kx = tap - ky * p.k;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + 64 * i;
    const int iy = iy0[i] + ky, ix = ix0[i] + kx;
    const bool ok = kval && arow[i] != nullptr && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_;
    const int8_t* src = ok ? arow[i] + ((size_t)iy * p.w_ + ix) * p.c + ci : p.x;
    cp_async16(as + row * kRow + col, src, ok);
    const int n = n0 + row;
    const bool okb = kval && n < p.cout;
    cp_async16(bs + row * kRow + col, okb ? p.w + (size_t)n * p.kdim + k : p.w, okb);
  }
}

// The same stage byte by byte, for any Cin: each thread one column of K
// and 32 rows of A and of B.
__device__ __forceinline__ void load_stage_bytes(const ConvArgs& p, int8_t* as, int8_t* bs, int k0, int m0,
                                                 int n0) {
  const int tid = threadIdx.x;
  const int col = tid & 63;
  const int k = k0 + col;
  const bool kval = k < p.kdim;
  int ky = 0, kx = 0, ci = 0;
  if (kval) {
    const int tap = k / p.c;
    ci = k - tap * p.c;
    ky = tap / p.k;
    kx = tap - ky * p.k;
  }
  const int plane = p.ho * p.wo;
  for (int j = 0; j < kBM / 4; ++j) {
    const int row = (tid >> 6) + 4 * j;
    const int m = m0 + row;
    int8_t v = 0;
    if (kval && m < p.m) {
      const int img = m / plane;
      const int r = m - img * plane;
      const int oy = r / p.wo;
      const int iy = oy * p.stride - p.pt + ky;
      const int ix = (r - oy * p.wo) * p.stride - p.pl + kx;
      if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_) {
        v = p.x[(((size_t)img * p.h + iy) * p.w_ + ix) * p.c + ci];
      }
    }
    as[row * kRow + col] = v;
    const int n = n0 + row;
    bs[row * kRow + col] = (kval && n < p.cout) ? p.w[(size_t)n * p.kdim + k] : (int8_t)0;
  }
}

template <bool VEC, bool RAW>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(const ConvArgs p) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm * 64, columns wn * 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // the two pixels whose A chunks this thread loads (vector path)
  const int8_t* arow[2] = {nullptr, nullptr};
  int iy0[2] = {0, 0}, ix0[2] = {0, 0};
  if (VEC) {
    const int plane = p.ho * p.wo;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (tid >> 2) + 64 * i;
      if (m < p.m) {
        const int img = m / plane;
        const int r = m - img * plane;
        const int oy = r / p.wo;
        arow[i] = p.x + (size_t)img * p.h * p.w_ * p.c;
        iy0[i] = oy * p.stride - p.pt;
        ix0[i] = (r - oy * p.wo) * p.stride - p.pl;
      }
    }
  }

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int nk = (p.kdim + kBK - 1) / kBK;
  if (VEC) {
    load_stage_vec(p, As[0], Bs[0], 0, m0, n0, arow, iy0, ix0);
  } else {
    load_stage_bytes(p, As[0], Bs[0], 0, m0, n0);
  }
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      if (VEC) {
        load_stage_vec(p, As[st ^ 1], Bs[st ^ 1], (kt + 1) * kBK, m0, n0, arow, iy0, ix0);
      } else {
        load_stage_bytes(p, As[st ^ 1], Bs[st ^ 1], (kt + 1) * kBK, m0, n0);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = As[st];
    const int8_t* bs = Bs[st];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = as + (wm * 64 + mi * 16 + g) * kRow + kk + t * 4;
        a[mi][0] = ld32(r0);
        a[mi][1] = ld32(r0 + 8 * kRow);
        a[mi][2] = ld32(r0 + 16);
        a[mi][3] = ld32(r0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* r0 = bs + (wn * 32 + ni * 8 + g) * kRow + kk + t * 4;
        b[ni][0] = ld32(r0);
        b[ni][1] = ld32(r0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: the accumulator of (row g [+ 8], columns 2t, 2t + 1) of each
  // 16 x 8 tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (row >= p.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t + j;
          if (n >= p.cout) continue;
          const int v = acc[mi][ni][2 * h + j];
          const size_t o = (size_t)row * p.cout + n;
          if (RAW) {
            static_cast<int*>(p.out)[o] = v;
          } else {
            float y = __fadd_rn(__fmul_rn(__int2float_rn(v), p.sw[n]), p.b[n]);
            if (p.relu) y = fmaxf(y, 0.0f);
            static_cast<float*>(p.out)[o] = y;
          }
        }
      }
    }
  }
}

template <bool VEC, bool RAW>
int launch_conv(const ConvArgs& p, cudaStream_t s) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN);
  conv_int8_kernel<VEC, RAW><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- quantizer

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t q8(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// N elements of T per 16-byte load; VEC false: one element per step.
template <typename T, bool VEC>
__global__ void quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long n, float s) {
  constexpr int N = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long nvec = n / N;
    for (long long i = first; i < nvec; i += stride) {
      const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
      const T* v = reinterpret_cast<const T*>(&raw);
      uint32_t word[2] = {0u, 0u};  // the N int8 results, lowest index in the lowest byte
#pragma unroll
      for (int j = 0; j < N; ++j) {
        word[j / 4] |= (uint32_t)(uint8_t)q8(to_f32(v[j]), s) << (8 * (j % 4));
      }
      if (N == 8) {
        *reinterpret_cast<uint2*>(q + i * N) = make_uint2(word[0], word[1]);
      } else {
        *reinterpret_cast<uint32_t*>(q + i * N) = word[0];
      }
    }
    done = nvec * N;
  }
  for (long long i = done + first; i < n; i += stride) q[i] = q8(to_f32(x[i]), s);
}

template <typename T>
int launch_quantize(const void* x, void* q, long long n, float s, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % N == 0;
  const long long items = vec ? n / N + N : n;
  const long long blocks = (items + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
  if (vec) {
    quantize_int8_kernel<T, true><<<grid, 256, 0, st>>>(static_cast<const T*>(x), static_cast<int8_t*>(q), n, s);
  } else {
    quantize_int8_kernel<T, false><<<grid, 256, 0, st>>>(static_cast<const T*>(x), static_cast<int8_t*>(q), n, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] int8, w [Cout, k, k, C] int8; out [B, Ho, Wo, Cout]: f32
// acc * sw + b (ReLU if relu) or, with raw, the int32 sums (sw and b
// unread). vec: 16-byte loads (16 divides C; x and w 16-byte aligned).
extern "C" int caesar_conv2d_int8(const void* x, const void* w, const void* sw, const void* b, void* out,
                                  int batch, int h, int wd, int c, int ho, int wo, int cout, int k,
                                  int stride, int pt, int pl, int relu, int raw, int vec, void* stream) {
  const long long m = (long long)batch * ho * wo;
  const long long kdim = (long long)k * k * c;
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || ho < 1 || wo < 1 || cout < 1 || k < 1 || stride < 1 ||
      m >= (1LL << 31) || kdim >= (1LL << 31) || (vec && c % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const ConvArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(sw),
                   static_cast<const float*>(b), out, h, wd, c, ho, wo, cout, k, stride, pt, pl, (int)m,
                   (int)kdim, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return raw ? launch_conv<true, true>(p, s) : launch_conv<true, false>(p, s);
  return raw ? launch_conv<false, true>(p, s) : launch_conv<false, false>(p, s);
}

// x: n f32 (is_bf16 0) or bf16 (1) values; q: n int8.
extern "C" int caesar_quantize_int8(const void* x, void* q, long long n, int is_bf16, float s, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_quantize<__nv_bfloat16>(x, q, n, s, st) : launch_quantize<float>(x, q, n, s, st);
}
