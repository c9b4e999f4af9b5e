// Batched greedy NMS over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: caesar_mrcnn_tpu/ops/nms.py::nms_padded_seq (reached through
// nms_padded_auto from models/proposals.py and models/detection.py). The
// JAX version resolves 128-box blocks with a fixpoint and sweeps each block
// forward over the rest with a dense [128, N] IoU pass; it is exact greedy
// NMS and so is this.
//
// What bounds it on the card: the IoU test is N^2/2 pairs per image
// (8 x 18M at 6000 boxes), cheap arithmetic; the greedy decision itself is a
// serial chain over the sorted boxes.
//
// Design: two kernels.
//  1. nms_mask_kernel: every thread takes one sorted box and tests it
//     against the 64 boxes of one column block held in shared memory,
//     writing one 64-bit word with bit j set where IoU > threshold. Only the
//     upper triangle is computed. This is all the N^2 work, fully parallel.
//  2. nms_sweep_kernel: one block per image walks the sorted boxes in order
//     with the removed-bits (N/64 words) in shared memory. Dead stretches
//     are skipped a word at a time with __ffsll; each kept box ORs its mask
//     row into the removed-bits, one word per thread. It stops at
//     max_output survivors and writes their input-order indices.
//
// The IoU is computed exactly like _pairwise_iou (union = a1 + a2 - inter,
// union > 0 guard, strict >) with explicitly rounded operations, so no FMA
// contraction can move a box across the threshold: the keep decisions agree
// bit for bit with the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // boxes per mask word

__device__ __forceinline__ float iou_rn(const float* a, const float* b) {
  float y1 = fmaxf(a[0], b[0]);
  float x1 = fmaxf(a[1], b[1]);
  float y2 = fminf(a[2], b[2]);
  float x2 = fminf(a[3], b[3]);
  float inter = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.0f),
                          fmaxf(__fsub_rn(x2, x1), 0.0f));
  float area_a = __fmul_rn(__fsub_rn(a[2], a[0]), __fsub_rn(a[3], a[1]));
  float area_b = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// grid (words, words, B), block kBlock. mask: [B, N, words].
__global__ void nms_mask_kernel(const float* __restrict__ sboxes, int n,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  if (cb < rb) return;  // the sweep reads only words at or right of the row
  __shared__ float cbox[kBlock * 4];
  const float* boxes = sboxes + (size_t)b * n * 4;
  const int cstart = cb * kBlock;
  const int ccount = min(kBlock, n - cstart);
  if (threadIdx.x < ccount) {
    for (int k = 0; k < 4; ++k)
      cbox[threadIdx.x * 4 + k] = boxes[(size_t)(cstart + threadIdx.x) * 4 + k];
  }
  __syncthreads();
  const int row = rb * kBlock + threadIdx.x;
  if (row >= n) return;
  float rbox[4];
  for (int k = 0; k < 4; ++k) rbox[k] = boxes[(size_t)row * 4 + k];
  unsigned long long bits = 0ull;
  const int jstart = (cb == rb) ? threadIdx.x + 1 : 0;
  for (int j = jstart; j < ccount; ++j) {
    if (iou_rn(rbox, cbox + j * 4) > thr) bits |= 1ull << j;
  }
  mask[((size_t)b * n + row) * words + cb] = bits;
}

// grid B, block threads; dynamic shared memory: words * 8 bytes.
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ svalid,
                                 const int32_t* __restrict__ order, int n,
                                 int words, int max_output,
                                 int32_t* __restrict__ out_idx,
                                 uint8_t* __restrict__ out_valid) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const uint8_t* valid = svalid + (size_t)b * n;
  // Invalid boxes and the tail past n start out removed.
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long bits = 0ull;
    for (int j = 0; j < kBlock; ++j) {
      const int pos = w * kBlock + j;
      if (pos >= n || !valid[pos]) bits |= 1ull << j;
    }
    removed[w] = bits;
  }
  __syncthreads();

  const unsigned long long* rows = mask + (size_t)b * n * words;
  int32_t* idx = out_idx + (size_t)b * max_output;
  uint8_t* ok = out_valid + (size_t)b * max_output;
  int count = 0;
  int i = 0;
  // Every thread runs the same walk: `removed` only changes at a kept box,
  // whose row sets bits strictly after it, and a __syncthreads follows.
  while (count < max_output && i < n) {
    const int w = i >> 6;
    const unsigned long long avail = ~removed[w] & (~0ull << (i & 63));
    if (avail == 0ull) {
      i = (w + 1) << 6;
      continue;
    }
    i = (w << 6) + __ffsll((long long)avail) - 1;
    if (threadIdx.x == 0) {
      idx[count] = order[(size_t)b * n + i];
      ok[count] = 1;
    }
    ++count;
    const unsigned long long* row = rows + (size_t)i * words;
    for (int k = w + threadIdx.x; k < words; k += blockDim.x) removed[k] |= row[k];
    __syncthreads();
    ++i;
  }
  for (int s = count + threadIdx.x; s < max_output; s += blockDim.x) {
    idx[s] = 0;
    ok[s] = 0;
  }
}

}  // namespace

extern "C" int caesar_nms(const float* sboxes, const uint8_t* svalid,
                          const int32_t* order, int batch, int n, float thr,
                          int max_output, unsigned long long* mask_scratch,
                          int32_t* out_idx, uint8_t* out_valid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kBlock - 1) / kBlock;
  dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(sboxes, n, words, thr, mask_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = words >= 256 ? 256 : ((words + 31) / 32) * 32;
  nms_sweep_kernel<<<batch, threads, words * sizeof(unsigned long long), s>>>(
      mask_scratch, svalid, order, n, words, max_output, out_idx, out_valid);
  return (int)cudaGetLastError();
}
