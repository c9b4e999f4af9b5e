// int8 convolution with int32 accumulation and an f32 epilogue, and the
// per-tensor int8 quantizer in front of it, for Hopper (sm_90a).
//
// Replaces: the int8 convolutions of the JAX package's serving graph,
// caesar_mrcnn_tpu/models/backbone_int8.py:276 and models/heads_int8.py:279
// (lax.conv_general_dilated on int8 NHWC x HWIO with
// preferred_element_type=int32, then acc * sw + b in f32), and the quantizer
// before each (backbone_int8.py:272, heads_int8.py:276: clip(round(x / s_in),
// -127, 127) as int8), which XLA fuses into the convolution before it
// (backbone_int8.py:263-267). PyTorch has no int8 convolution on CUDA, so
// both are written here. One detect batch of the serving flagship
// (ResNet-101, 512^2, batch 8, 512 proposals, 100 detections) runs 123
// convolutions and 53 quantizer passes (70 in convolution epilogues).
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
// One kernel (namespace hop below) runs every convolution: warp-specialized
// wgmma with a TMA and cp.async ring, split-K for the small grids, and an
// epilogue that can requantize for the next convolution, so 70 of the 123
// quantizer passes of a batch are gone. It takes 16 | Cin and 16-byte
// aligned tensors; ops/quant.py::hopper_operands pads and copies any other
// operands to that (a no-op at every serving site: the stem's image is
// quantized with its 3 channels padded to 16 by the padding quantizer at
// the end, and its weights are padded once when the graph is built, which
// adds 0 x w products only).
//
// It computes M = B Ho Wo output pixels, N = Cout, K = kh kw Cin in (ky,
// kx, ci) order, the order of the packed weights [Cout, kh, kw, Cin]. A row
// m is the pixel (b, oy, ox), column k the tap (ky, kx) and channel ci, read
// at (oy * stride - pad_top + ky, ox * stride - pad_left + kx); taps in the
// padding read 0. |acc| <= 12,544 x 127^2 < 2^31: no overflow. Epilogue:
// the int32 sum to f32, times sw[n], plus b[n], each rounded (__fmul_rn,
// __fadd_rn: no contraction, so the result equals the plain PyTorch version
// bit for bit), an optional ReLU; stored as f32 NHWC, or requantized
// (below), or the raw int32 sums, for the checks.
//
// The quantizer divides (IEEE division, __fdiv_rn, as the JAX code divides:
// never the product with the reciprocal), rounds half to even (rintf, like
// jnp.round and torch.round) and clips to +-127; 16-byte loads, one grid-
// stride loop. The requantizing epilogue applies the same function to the
// same rounded f32 value, so a fused pair equals the unfused pair bit for
// bit.
//
// Triton's rule (elementwise passes and reductions) does not cover the
// convolution, which is neither, so both kernels are CUDA C++.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>
#include <stdint.h>

namespace {

// Epilogue modes: the raw int32 sums (the checks), f32 acc * sw + b (+
// ReLU), or that f32 value requantized by the next site's quantizer, int8.
enum Mode { kRaw = 0, kF32 = 1, kQ8 = 2 };

__device__ __forceinline__ int8_t q8(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// acc * sw + b, the product and the sum each rounded, then the ReLU
__device__ __forceinline__ float dequant(int acc, float sw, float b, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), sw), b);
  return relu ? fmaxf(y, 0.0f) : y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// ------------------------------------------------ Hopper main loop (wgmma)
//
// The implicit GEMM. A block of three warpgroups
// computes 128 x BN tiles (BN 64, 128 or 256, chosen per site by
// ops/quant.py::conv_plan): warpgroups 0 and 1 consume, 64 rows each, with
// wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared memory; warpgroup 2
// produces. K runs in 128-byte stages, a ring of kStages in shared memory
// in the 128-byte swizzled K-major layout wgmma reads (16-byte chunk j of
// row r at r * 128 + ((j ^ (r & 7)) * 16)), with a full and an empty
// mbarrier per stage. B, the packed weights as a 2-D [Cout, K] int8 tensor,
// comes by TMA (one thread, zero fill past K and Cout; the tensor map is
// encoded once per weight, caesar_conv_int8_weight_map). A is the im2col
// gather: each producer thread copies 16-byte chunks with cp.async (zero
// filled in the padding and past M and K) straight into the swizzled layout
// and arrives on the stage's full barrier when they land
// (cp.async.mbarrier.arrive.noinc). Each row's pixel is decoded once per
// tile, through a table in shared memory, into the producer's registers
// (56 a thread; the consumers keep 224).
//
// The blocks are persistent, one per SM: each walks tiles (and K shares)
// with the ring running on from one to the next, and the epilogue writes
// from the accumulators, so the producer loads the next tile's first
// stages while the consumers finish this one. Measured on the card, the
// epilogue's stores take about a third of a block's time at the large
// f32 sites either way; the persistent walk gained up to a tenth.
//
// Split-K: where the output tiles do not fill the card, the work units are
// (K share, tile) pairs; each writes its int32 partial tile to a scratch
// buffer, and the last to arrive (a counter per tile, reset by that block)
// adds the others' partials to its own and runs the epilogue once on the
// complete sum. int32 sums are exact in any order, so the result does not
// depend on the split.
//
// Epilogue: the raw sums, the f32 values, or, where one quantized
// convolution alone reads the output, those values quantized at that
// convolution's input scale (int8, 16-byte stores gathered across each
// quad of lanes by shuffles): the next site's quantizer pass is gone.
//
// What bounds it (PERF.md, measured with clock64 counters in a copy of
// this kernel): the two consumer warpgroups spend most of a stage waiting
// for it to fill, while their wgmma runs near the tensor cores' rate once
// issued; the producer is busy about 1,900 cycles a stage, with or without
// the A gather, the B TMA, or 128 arrivals cut to 4, so no single load
// explains it. Clusters of two multicasting B, six stages, and BN = 128
// were each measured no faster (conv_int8_variants.py times the variants
// that still apply to this file).

namespace hop {

constexpr int kBM = 128;        // output pixels per block: two consumer warpgroups of 64 rows
constexpr int kBK = 128;        // bytes of K per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = 384;   // warpgroup 2 produces

struct Args {
  const int8_t* x;  // [B, H, W, C], 16 | C
  const float* sw;
  const float* b;
  void* out;
  int* ws;          // split-K partial tiles [splits, tiles, kBM * BN]
  int* counters;    // split-K arrivals per tile, 0 between launches
  int h, w, c, ho, wo, cout, k, stride, pt, pl, m, kdim, relu, mode, nk, kps, splits;
  float s_next;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits for the barrier's phase to pass parity. A watchdog: a wait that
// outlasts 2^24 polls (a third of a second at the least; a stage lands in
// microseconds) traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls > (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// one arrival on the barrier once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n256(d, da, db);
  }
}

__device__ __forceinline__ float dq(const Args& p, int v, int n) {
  const int nc = min(n, p.cout - 1);  // columns past Cout compute a value that is never stored
  return dequant(v, __ldg(p.sw + nc), __ldg(p.b + nc), p.relu);
}

__device__ __forceinline__ uint32_t q8x2(const Args& p, int v0, int v1, int n) {
  return (uint32_t)(uint8_t)q8(dq(p, v0, n), p.s_next) | (uint32_t)(uint8_t)q8(dq(p, v1, n + 1), p.s_next) << 8;
}

// The epilogue, from the accumulator registers (no shared memory, so the
// producer refills the ring meanwhile). Thread (warp w of warpgroup g,
// lane l) holds rows r0 = 64g + 16w + l / 4 and r0 + 8, columns 8i + 2(l %
// 4) and + 1 of every 8-column chunk i: acc[4i], acc[4i + 1] (row r0),
// acc[4i + 2], acc[4i + 3] (row r0 + 8). f32 and int32 leave as 8-byte
// pairs (a warp fills whole 32-byte sectors); int8 as 16-byte vectors,
// each lane of a quad gathering one row's 16 columns from the other three
// by four shuffles.
template <int BN>
__device__ __forceinline__ void epilogue(const Args& p, const int* acc, int m0, int n0, int r0, int lane) {
  const int q = lane & 3;
  const int ma = m0 + r0, mb = ma + 8;
  if (p.mode != kQ8 || (p.cout & 15) != 0) {
    const bool pairs = (p.cout & 1) == 0;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? mb : ma;
        if (n >= p.cout || m >= p.m) continue;
        const size_t o = (size_t)m * p.cout + n;
        const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        const bool two = n + 1 < p.cout;
        if (p.mode == kRaw) {
          int* out = static_cast<int*>(p.out) + o;
          if (two && pairs) {
            *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
          } else {
            out[0] = v0;
            if (two) out[1] = v1;
          }
        } else if (p.mode == kF32) {
          float* out = static_cast<float*>(p.out) + o;
          const float y0 = dq(p, v0, n), y1 = dq(p, v1, n + 1);
          if (two && pairs) {
            *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
          } else {
            out[0] = y0;
            if (two) out[1] = y1;
          }
        } else {
          int8_t* out = static_cast<int8_t*>(p.out) + o;
          out[0] = q8(dq(p, v0, n), p.s_next);
          if (two) out[1] = q8(dq(p, v1, n + 1), p.s_next);
        }
      }
    }
    return;
  }
  // int8, 16 | Cout: per group of 32 columns, lane q of a quad stores row
  // r0 + 8 (q / 2), columns 16 (q % 2) .. + 15; word[2h + c] is what this
  // lane holds of that: chunks 2c and 2c + 1 of the group, row half h
#pragma unroll
  for (int g = 0; g < BN / 32; ++g) {
    uint32_t word[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int a = 4 * g + 2 * c;
        const int n = n0 + 8 * a + 2 * q;
        word[2 * h + c] = q8x2(p, acc[4 * a + 2 * h], acc[4 * a + 2 * h + 1], n) |
                          q8x2(p, acc[4 * a + 4 + 2 * h], acc[4 * a + 5 + 2 * h], n + 8) << 16;
      }
    }
    uint32_t got[4];  // got[t]: the word of lane (q + t) % 4 of the quad
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int to = (q - t) & 3;  // the lane reading from this one in round t
      const uint32_t send = to == 0 ? word[0] : to == 1 ? word[1] : to == 2 ? word[2] : word[3];
      got[t] = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((q + t) & 3));
    }
    uint32_t from[4];  // from[src]: the word of lane src
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const int t = (src - q) & 3;
      from[src] = t == 0 ? got[0] : t == 1 ? got[1] : t == 2 ? got[2] : got[3];
    }
    const int m = (q >> 1) ? mb : ma;
    const int n = n0 + 32 * g + 16 * (q & 1);
    if (m < p.m && n < p.cout) {
      const uint4 v = make_uint4((from[0] & 0xffffu) | (from[1] << 16), (from[2] & 0xffffu) | (from[3] << 16),
                                 (from[0] >> 16) | (from[1] & 0xffff0000u), (from[2] >> 16) | (from[3] & 0xffff0000u));
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + (size_t)m * p.cout + n) = v;
    }
  }
}

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM + BN) * kBK + 1024;  // the ring, and slack to align it to 1024 bytes
}

// Persistent: gridDim.x blocks (at most one per SM) walk the work units,
// u = (split z, N tile, M tile) with the M tile fastest, u = blockIdx.x,
// blockIdx.x + gridDim.x, ..; the ring's stages and phases run on across
// units, so the next unit's loads overlap this unit's epilogue.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int4 rows[kBM];  // per row of the unit: input offset of its image, iy0, ix0
  __shared__ int last;
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* As = reinterpret_cast<int8_t*>(ring);                         // [kStages][kBM * kBK]
  int8_t* Bs = reinterpret_cast<int8_t*>(ring + kStages * kBM * kBK);   // [kStages][BN * kBK]
  const int tid = threadIdx.x;
  const int mt = (p.m + kBM - 1) / kBM;
  const int tiles = mt * ((p.cout + BN - 1) / BN);
  const int units = tiles * p.splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128 + 1);  // each producer thread's cp.asyncs, and the TMA's arrival with its bytes
      mbar_init(&empty[s], 2);       // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - kConsumers;
    const int j = t & 7, rg = t >> 3;  // chunk j of rows rg, rg + 16, .., rg + 112
    int it = 0;                        // stages so far, over all units
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles, tile = u - z * tiles;
      const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * BN;
      const int kt0 = z * p.kps, kt1 = min(p.nk, kt0 + p.kps);
      named_sync(2, 128);  // every producer thread is done with the previous unit's rows
      {
        const int m = m0 + t;
        int4 r = make_int4(0, -(1 << 28), -(1 << 28), 0);  // past M: every tap in the padding
        if (m < p.m) {
          const int plane = p.ho * p.wo;
          const int img = m / plane;
          const int rem = m - img * plane;
          const int oy = rem / p.wo;
          r = make_int4(img * p.h * p.w * p.c, oy * p.stride - p.pt, (rem - oy * p.wo) * p.stride - p.pl, 0);
        }
        rows[t] = r;
      }
      named_sync(2, 128);
      int4 mine[8];  // this thread's rows, in registers: a shared-memory read per stage measured slower
#pragma unroll
      for (int i = 0; i < 8; ++i) mine[i] = rows[rg + 16 * i];
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        if (t == 0) {
          mbar_expect_tx(&full[s], BN * kBK);
          tma_load_2d(Bs + s * BN * kBK, &wmap, &full[s], kt * kBK, n0);
        }
        const int k = kt * kBK + 16 * j;
        const bool kval = k < p.kdim;
        int ky = 0, kx = 0, ci = 0;
        if (kval) {  // 16 | C: the chunk lies inside one tap
          const int tap = k / p.c;
          ci = k - tap * p.c;
          ky = tap / p.k;
          kx = tap - ky * p.k;
        }
        int8_t* as = As + s * kBM * kBK;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rg + 16 * i;
          const int4 ri = mine[i];
          const int iy = ri.y + ky, ix = ri.z + kx;
          const bool ok = kval && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w;
          const int8_t* src = ok ? p.x + ri.x + ((size_t)iy * p.w + ix) * p.c + ci : p.x;
          cp_async16(as + r * kBK + ((j ^ (r & 7)) << 4), src, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles, tile = u - z * tiles;
      const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * BN;
      const int kt0 = z * p.kps, kt1 = min(p.nk, kt0 + p.kps);
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0;
        fence_reg(acc[i]);
      }
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        // the A chunks were written through the generic proxy (cp.async); wgmma reads through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wgmma_fence();
        const uint64_t da = desc_sw128(As + s * kBM * kBK + wg * 64 * kBK);
        const uint64_t db = desc_sw128(Bs + s * BN * kBK);
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > kt0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      if ((tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);  // the unit's last stage

      if (p.splits > 1) {
        const size_t per = (size_t)kBM * BN;
        int4* mine = reinterpret_cast<int4*>(p.ws + ((size_t)z * tiles + tile) * per);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          mine[i * kConsumers + tid] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
        __threadfence();
        named_sync(1, kConsumers);
        if (tid == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
        named_sync(1, kConsumers);
        if (!last) continue;  // another block completes this tile
        __threadfence();
        for (int o = 0; o < p.splits; ++o) {
          if (o == z) continue;
          const int4* other = reinterpret_cast<const int4*>(p.ws + ((size_t)o * tiles + tile) * per);
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int4 v = __ldcg(other + i * kConsumers + tid);
            acc[4 * i] += v.x;
            acc[4 * i + 1] += v.y;
            acc[4 * i + 2] += v.z;
            acc[4 * i + 3] += v.w;
          }
        }
        if (tid == 0) p.counters[tile] = 0;
      }
      epilogue<BN>(p, acc, m0, n0, r0, lane);
    }
  }
}

template <int BN>
int launch_wgmma(const CUtensorMap& map, const Args& a, int sms, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(conv_int8_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long units = (long long)((a.m + kBM - 1) / kBM) * ((a.cout + BN - 1) / BN) * a.splits;
  const int grid = (int)(units < sms ? units : sms);
  conv_int8_wgmma_kernel<BN><<<grid, kThreads, bytes, s>>>(map, a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                          &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace hop

// ------------------------------------------------------------- quantizer

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// The quantizer with the channels padded by zeros: pixel p's c_in values
// to c_out int8 (16 | c_out), one 16-byte store per 16 channels. The stem's
// image (C = 3) leaves as 16 channels, so the stem takes the 16-byte gather
// of the Hopper path (its weights carry 13 zero channels to match).
template <typename T>
__global__ void quantize_int8_pad_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long npix, int c_in,
                                         int c_out, float s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x; px < npix; px += stride) {
    const T* src = x + px * c_in;
    for (int g = 0; g < c_out; g += 16) {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (g + j < c_in) word[j / 4] |= (uint32_t)(uint8_t)q8(to_f32(src[g + j]), s) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(q + px * c_out + g) = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

template <typename T>
int launch_quantize_pad(const void* x, void* q, long long npix, int c_in, int c_out, float s, cudaStream_t st) {
  const long long blocks = (npix + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
  quantize_int8_pad_kernel<T><<<grid, 256, 0, st>>>(static_cast<const T*>(x), static_cast<int8_t*>(q), npix, c_in,
                                                    c_out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The TMA descriptor of packed weights w, [cout, kdim] int8 (16 | kdim, w
// 16-byte aligned), in boxes of 128 bytes of K by bn rows, 128-byte
// swizzled, zero filled past K and Cout: 128 bytes written to map. 0, or
// 1000 + the CUresult of the encoding.
extern "C" int caesar_conv_int8_weight_map(void* map, const void* w, int kdim, int cout, int bn) {
  if (kdim < 16 || kdim % 16 != 0 || cout < 1 || (bn != 64 && bn != 128 && bn != 256) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {(cuuint64_t)kdim, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)kdim};
  const cuuint32_t box[2] = {(cuuint32_t)hop::kBK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  memcpy(map, &tmap, sizeof(tmap));
  return 0;
}

// x [B, H, W, C] int8 with 16 | C, 16-byte aligned; map from
// caesar_conv_int8_weight_map at this bn (the packed weights [Cout, k, k,
// C]); out [B, Ho, Wo, Cout]: mode 0 the int32 sums (sw and b unread), 1
// f32 acc * sw + b (ReLU if relu), 2 that value quantized at s_next
// (int8); at most sms blocks (the card's SMs). With splits > 1, ws holds
// splits x tiles x 128 x bn int32 and counters one zeroed int per output
// tile (left zeroed).
extern "C" int caesar_conv2d_int8_wgmma(const void* x, const void* map, const void* sw, const void* b, void* out,
                                        void* ws, void* counters, int batch, int h, int wd, int c, int ho, int wo,
                                        int cout, int k, int stride, int pt, int pl, int relu, int mode,
                                        float s_next, int bn, int splits, int sms, void* stream) {
  const long long m = (long long)batch * ho * wo;
  const long long kdim = (long long)k * k * c;
  if (batch < 1 || h < 1 || wd < 1 || c < 16 || c % 16 != 0 || ho < 1 || wo < 1 || cout < 1 || k < 1 ||
      stride < 1 || m >= (1LL << 31) || kdim >= (1LL << 31) || (long long)batch * h * wd * c >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || mode < kRaw || mode > kQ8 || splits < 1 || splits > 8 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int nk = (int)((kdim + hop::kBK - 1) / hop::kBK);
  const int kps = (nk + splits - 1) / splits;
  splits = (nk + kps - 1) / kps;  // every split a share of K
  const hop::Args a{static_cast<const int8_t*>(x), static_cast<const float*>(sw), static_cast<const float*>(b), out,
                    static_cast<int*>(ws), static_cast<int*>(counters), h, wd, c, ho, wo, cout, k, stride, pt, pl,
                    (int)m, (int)kdim, relu, mode, nk, kps, splits, s_next};
  CUtensorMap tmap;
  memcpy(&tmap, map, sizeof(tmap));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return hop::launch_wgmma<64>(tmap, a, sms, s);
    case 128: return hop::launch_wgmma<128>(tmap, a, sms, s);
    case 256: return hop::launch_wgmma<256>(tmap, a, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: n f32 (is_bf16 0) or bf16 (1) values; q: n int8.
extern "C" int caesar_quantize_int8(const void* x, void* q, long long n, int is_bf16, float s, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_quantize<__nv_bfloat16>(x, q, n, s, st) : launch_quantize<float>(x, q, n, s, st);
}

// x: npix x c_in f32 (is_bf16 0) or bf16 (1) values; q: npix x c_out int8,
// channels c_in.. c_out - 1 zero (16 | c_out, c_in <= c_out, q 16-byte
// aligned).
extern "C" int caesar_quantize_int8_pad(const void* x, void* q, long long npix, int c_in, int c_out, int is_bf16,
                                        float s, void* stream) {
  if (npix < 0 || c_in < 1 || c_out < c_in || c_out % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (npix == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_quantize_pad<__nv_bfloat16>(x, q, npix, c_in, c_out, s, st)
                 : launch_quantize_pad<float>(x, q, npix, c_in, c_out, s, st);
}
