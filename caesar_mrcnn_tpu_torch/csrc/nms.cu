// Batched greedy NMS over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: caesar_mrcnn_tpu/ops/nms.py::nms_padded_seq (reached through
// nms_padded_auto from models/proposals.py and models/detection.py). The
// JAX version resolves 128-box blocks with a fixpoint and sweeps each block
// forward over the rest with a dense [128, N] IoU pass; it is exact greedy
// NMS and so is this.
//
// What bounds it on the card: the IoU test is N^2/2 pairs per image
// (8 x 18M at 6000 boxes), ~20 f32 operations each: ~0.04 ms at the f32
// peak. The greedy decision is a serial chain over the sorted boxes, and at
// the flagship's RPN threshold (0.9) nearly every valid box survives, so
// the chain runs to max_output (1000 at detect, 2000 in training). A sweep
// that waits on one dependent load from device memory per kept box, in one
// block per image (8 of 132 SMs), takes ~1 us per kept box.
//
// Design: two kernels, and nothing but the sort outside them.
//  1. nms_mask_kernel reads boxes[order] and scores[order] itself (the
//     wrapper gathers nothing), zeroes invalid boxes and writes one 64-bit
//     validity word per 64 sorted boxes. Each block takes one row word (64
//     sorted boxes, one per thread) against kColWords column words (64
//     boxes each, staged in shared memory), 256 threads; blocks enumerate
//     only the upper triangle, so none exits idle. Bit j of word
//     mask[row][w] is set when IoU(row, 64w + j) > threshold, j > row.
//  2. nms_sweep_kernel, one block per image, walks the sorted boxes in
//     chunks of 64 with the removed-bits in shared memory:
//       a. warp 0 holds the chunk's 64 diagonal words (two per lane,
//          loaded while the chunk before resolved) and resolves its keeps
//          in registers: it walks, in order, only the available boxes that
//          suppress another box of the chunk, OR-ing each one's diagonal
//          word into the chunk's removed-bits through a warp shuffle, and
//          keeps every box left: no memory access in the serial part;
//       b. warp 0 writes the kept boxes' input indices, and ORs their words
//          of the next chunk into its removed-bits itself;
//       c. after one barrier, the other 15 warps OR the kept rows' words
//          of every later chunk into the removed-bits, with shared-memory
//          atomics: coalesced loads, all in flight together, while warp 0
//          already resolves the next chunk.
//     One barrier per chunk (<= 94 at 6000 boxes), and the walk stops as
//     soon as max_output boxes are kept.
//  Both run in two phases (caesar_nms, below): the walk reads only the
//  boxes up to the one at which max_output are kept, about max_output of
//  6000 at the flagship's thresholds, so the pairs among the first
//  2 * max_output boxes are tested and walked first, and the rest of the
//  upper triangle only for an image whose walk that did not end.
//
// The IoU is computed exactly like _pairwise_iou (union = a1 + a2 - inter,
// union > 0 guard, strict >) with explicitly rounded operations, so no FMA
// contraction can move a box across the threshold: the keep decisions agree
// bit for bit with the plain PyTorch version. A pair with no intersection
// has IoU exactly 0, and the rounded division runs only where the quotient
// lies within 2^-16 of the threshold (iou_above).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;       // boxes per mask word
constexpr int kColWords = 4;     // column words per mask block
constexpr int kMaskThreads = kBlock * kColWords;
constexpr int kSweepThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

struct Box {
  float y1, x1, y2, x2;
};

__device__ __forceinline__ float area_rn(const Box& a) {
  return __fmul_rn(__fsub_rn(a.y2, a.y1), __fsub_rn(a.x2, a.x1));
}

// The threshold and two bounds around it: a quotient inter / union above
// `hi` (below `lo`) rounds to a float above (not above) `t`, so the rounded
// division is needed only between them. uni * hi rounds by at most 2^-24
// relative, and hi - t is 2^-16 |t| (or 1e-30 at t = 0): far more than the
// 64 ulp of t that the rounding of the quotient could cross.
struct Thr {
  float t, hi, lo;
};

__device__ __forceinline__ Thr make_thr(float t) {
  const float m = __fadd_rn(__fmul_rn(fabsf(t), 0x1p-16f), 1e-30f);
  return {t, __fadd_rn(t, m), __fsub_rn(t, m)};
}

// IoU(a, b) > t, with the IoU of _pairwise_iou: union = a1 + a2 - inter,
// 0 where there is no intersection or no union, rounded division.
__device__ __forceinline__ bool iou_above(const Box& a, float area_a, const Box& b,
                                          float area_b, const Thr& th) {
  const float y1 = fmaxf(a.y1, b.y1);
  const float x1 = fmaxf(a.x1, b.x1);
  const float y2 = fminf(a.y2, b.y2);
  const float x2 = fminf(a.x2, b.x2);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.0f),
                                fmaxf(__fsub_rn(x2, x1), 0.0f));
  if (inter == 0.0f) return 0.0f > th.t;  // 0 / union, or the guard's 0
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.0f)) return 0.0f > th.t;
  if (inter > __fmul_rn(uni, th.hi)) return true;
  if (inter < __fmul_rn(uni, th.lo)) return false;
  return __fdiv_rn(inter, uni) > th.t;
}

// Sorted box `pos` of image b: the input box order[pos], zeroed when its
// score is -inf (invalid); `valid` reports which.
__device__ __forceinline__ Box sorted_box(const float* __restrict__ boxes,
                                          const float* __restrict__ scores,
                                          const int64_t* __restrict__ order,
                                          int b, int n, int pos, bool& valid) {
  Box box = {0.0f, 0.0f, 0.0f, 0.0f};
  valid = false;
  if (pos < n) {
    const int64_t src = order[(size_t)b * n + pos];
    valid = scores[(size_t)b * n + src] > -INFINITY;
    if (valid) {
      const float* p = boxes + ((size_t)b * n + src) * 4;
      box = {p[0], p[1], p[2], p[3]};
    }
  }
  return box;
}

// Per image, between the two phases: kept count and whether the walk is
// done. The sorted positions of the kept boxes follow the B states in the
// same buffer (kept_pos).
struct SweepState {
  int count;
  int done;
};

// Column words [max(rb, cw_begin), cw_end) of row word rb < rw_end, in
// blocks of kColWords.
__device__ __forceinline__ int row_segments(int rb, int cw_begin, int cw_end) {
  const int first = max(rb, cw_begin);
  return first < cw_end ? (cw_end - first + kColWords - 1) / kColWords : 0;
}

// grid (blocks, B), block kMaskThreads. The blocks enumerate, row word by
// row word, the pairs (rb < rw_end, cb in [max(rb, cw_begin), cw_end)),
// kColWords column words each: the upper triangle only. A block of an
// image whose walk is already done (state) exits at once.
// mask: [B, N, words]; validbits: [B, words], written where cb == rb.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const int64_t* __restrict__ order, int n, int words, float thr,
                int rw_end, int cw_begin, int cw_end, const SweepState* __restrict__ state,
                unsigned long long* __restrict__ mask,
                unsigned long long* __restrict__ validbits) {
  __shared__ Box cbox[kMaskThreads];
  __shared__ float carea[kMaskThreads];
  __shared__ unsigned int vhalf[2];
  const int b = blockIdx.y;
  if (state != nullptr && state[b].done) return;
  int rem = blockIdx.x, rb = 0;
  for (; rb < rw_end; ++rb) {  // uniform: every thread finds the same (rb, seg)
    const int segs = row_segments(rb, cw_begin, cw_end);
    if (rem < segs) break;
    rem -= segs;
  }
  if (rb >= rw_end) return;
  const int cb0 = max(rb, cw_begin) + rem * kColWords;
  const bool diagonal = cb0 == rb;
  bool cvalid;
  const Box mine = sorted_box(boxes, scores, order, b, n, cb0 * kBlock + threadIdx.x, cvalid);
  cbox[threadIdx.x] = mine;
  carea[threadIdx.x] = area_rn(mine);
  if (diagonal && threadIdx.x < kBlock) {  // column word cb0 is the row word
    const unsigned int bits = __ballot_sync(kFull, cvalid);
    if ((threadIdx.x & 31) == 0) vhalf[threadIdx.x >> 5] = bits;
  }
  const int r = threadIdx.x & (kBlock - 1);
  const int row = rb * kBlock + r;
  bool rvalid;
  const Box rbox = sorted_box(boxes, scores, order, b, n, row, rvalid);
  __syncthreads();
  if (diagonal && threadIdx.x == 0)
    validbits[(size_t)b * words + rb] =
        (unsigned long long)vhalf[0] | ((unsigned long long)vhalf[1] << 32);

  const int g = threadIdx.x / kBlock;
  const int cb = cb0 + g;
  if (row >= n || cb >= cw_end) return;
  const Box* cols = cbox + g * kBlock;
  const float* areas = carea + g * kBlock;
  const float rarea = area_rn(rbox);
  const Thr th = make_thr(thr);
  const int ccount = min(kBlock, n - cb * kBlock);
  unsigned long long bits = 0ull;
  for (int j = (cb == rb) ? r + 1 : 0; j < ccount; ++j) {
    if (iou_above(rbox, rarea, cols[j], areas[j], th)) bits |= 1ull << j;
  }
  mask[((size_t)b * n + row) * words + cb] = bits;
}

// What warp 0 needs of one chunk c: each lane's two rows (lane, lane + 32)
// of the chunk, their words of chunk c (the diagonal) and c + 1, and their
// input indices. Loaded one chunk ahead, so that they are in flight while
// the chunk before resolves. Chunks at or past c_end read nothing.
struct ChunkRows {
  unsigned long long d0, d1, e0, e1;
  int64_t o0, o1;
};

__device__ __forceinline__ ChunkRows load_chunk(const unsigned long long* __restrict__ rows,
                                                const int64_t* __restrict__ ord, int n, int words,
                                                int c_end, int c, int lane) {
  ChunkRows r = {0ull, 0ull, 0ull, 0ull, 0, 0};
  if (c >= c_end) return r;
  const int r0 = c * kBlock + lane, r1 = r0 + 32;
  const bool next = c + 1 < c_end;
  if (r0 < n) {
    r.d0 = rows[(size_t)r0 * words + c];
    r.e0 = next ? rows[(size_t)r0 * words + c + 1] : 0ull;
    r.o0 = ord[r0];
  }
  if (r1 < n) {
    r.d1 = rows[(size_t)r1 * words + c];
    r.e1 = next ? rows[(size_t)r1 * words + c + 1] : 0ull;
    r.o1 = ord[r1];
  }
  return r;
}

// grid B, block kSweepThreads; dynamic shared memory: words * 8 bytes.
// Walks chunks [c_begin, c_end) with the mask words of columns below c_end.
// A walk that starts past chunk 0 resumes from `state` and `kept_pos` (the
// sorted positions of the boxes kept so far), and first ORs the kept rows'
// words of its chunks into the removed-bits. The call that ends the walk
// (max_output kept, or the last chunk done) pads the output.
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const unsigned long long* __restrict__ validbits,
                 const int64_t* __restrict__ order, int n, int words,
                 int c_begin, int c_end, int max_output, SweepState* __restrict__ state,
                 int32_t* __restrict__ kept_pos, int32_t* __restrict__ out_idx,
                 uint8_t* __restrict__ out_valid) {
  extern __shared__ unsigned long long removed[];
  __shared__ int kept_rows[2][kBlock];  // chunk-local rows kept, by rank
  __shared__ int kept_count[2];
  __shared__ int finished[2];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned long long* rows = mask + (size_t)b * n * words;
  const int64_t* ord = order + (size_t)b * n;
  int32_t* idx = out_idx + (size_t)b * max_output;
  uint8_t* ok = out_valid + (size_t)b * max_output;
  int32_t* kpos = kept_pos + (size_t)b * max_output;
  int count = 0;  // kept so far; warp 0's copy is the one that counts
  if (c_begin > 0) {
    if (state[b].done) return;
    count = state[b].count;
  }
  for (int w = c_begin + threadIdx.x; w < c_end; w += blockDim.x)
    removed[w] = ~validbits[(size_t)b * words + w];  // invalid and tail bits
  __syncthreads();
  if (c_begin > 0) {  // the boxes kept before c_begin suppress from here on
    for (int k = c_begin + lane; k < c_end; k += 32) {
      unsigned long long acc = 0ull;
#pragma unroll 4
      for (int t = warp; t < count; t += nwarps) acc |= rows[(size_t)kpos[t] * words + k];
      if (acc) atomicOr(&removed[k], acc);
    }
    __syncthreads();
  }

  ChunkRows cur = {0ull, 0ull, 0ull, 0ull, 0, 0};
  if (warp == 0) cur = load_chunk(rows, ord, n, words, c_end, c_begin, lane);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = c & 1;
    if (warp == 0) {
      const ChunkRows nxt = load_chunk(rows, ord, n, words, c_end, c + 1, lane);
      // removed[c] is final: chunk c - 1's rows were OR-ed in by this warp,
      // earlier chunks' by the other warps before the last barrier.
      unsigned long long rem = removed[c];
      // Only boxes that suppress another box of the chunk need the serial
      // walk; every other available box is kept as it is.
      const unsigned long long nz = (unsigned long long)__ballot_sync(kFull, cur.d0 != 0ull) |
                                    ((unsigned long long)__ballot_sync(kFull, cur.d1 != 0ull) << 32);
      unsigned long long walk = nz & ~rem;
      while (walk != 0ull) {  // uniform across the warp
        const int j = __ffsll((long long)walk) - 1;
        rem |= __shfl_sync(kFull, j < 32 ? cur.d0 : cur.d1, j & 31);  // bits after j only
        walk &= ~rem & ~(1ull << j);
      }
      unsigned long long keep = ~rem;
      const int budget = max_output - count;
      while (__popcll(keep) > budget) keep &= ~(1ull << (63 - __clzll((long long)keep)));
      const unsigned long long below0 = (1ull << lane) - 1ull;
      if ((keep >> lane) & 1ull) {
        const int rank = __popcll(keep & below0);
        idx[count + rank] = (int32_t)cur.o0;
        ok[count + rank] = 1;
        kpos[count + rank] = c * kBlock + lane;
        kept_rows[buf][rank] = lane;
      }
      if ((keep >> (lane + 32)) & 1ull) {
        const int rank = __popcll(keep & ((below0 << 32) | 0xffffffffull));
        idx[count + rank] = (int32_t)cur.o1;
        ok[count + rank] = 1;
        kpos[count + rank] = c * kBlock + lane + 32;
        kept_rows[buf][rank] = lane + 32;
      }
      const int nk = __popcll(keep);
      count += nk;
      if (c + 1 < c_end) {
        unsigned long long v = (((keep >> lane) & 1ull) ? cur.e0 : 0ull) |
                               (((keep >> (lane + 32)) & 1ull) ? cur.e1 : 0ull);
        for (int s = 16; s > 0; s >>= 1) v |= __shfl_xor_sync(kFull, v, s);
        if (lane == 0 && v) atomicOr(&removed[c + 1], v);
      }
      if (lane == 0) {
        kept_count[buf] = nk;
        finished[buf] = count >= max_output;
      }
      cur = nxt;
      __syncwarp();
    }
    __syncthreads();
    if (finished[buf]) break;
    const int nk = kept_count[buf];
    if (warp != 0 && nk > 0) {
      // words c + 2 .. c_end - 1: lanes across words, warps across kept rows
      const int* kr = kept_rows[buf];
      for (int k = c + 2 + lane; k < c_end; k += 32) {
        unsigned long long acc = 0ull;
#pragma unroll 4
        for (int t = warp - 1; t < nk; t += nwarps - 1)
          acc |= rows[(size_t)(c * kBlock + kr[t]) * words + k];
        if (acc) atomicOr(&removed[k], acc);
      }
    }
  }
  if (warp == 0) {
    const bool done = count >= max_output;
    if (lane == 0) state[b] = {count, done ? 1 : 0};
    if (done || c_end == words) {
      for (int s = count + lane; s < max_output; s += 32) {
        idx[s] = 0;
        ok[s] = 0;
      }
    }
  }
}


// Mask blocks of the pairs (rb < rw_end, cb in [max(rb, cw_begin), cw_end)).
int mask_blocks(int rw_end, int cw_begin, int cw_end) {
  int blocks = 0;
  for (int rb = 0; rb < rw_end; ++rb) {
    const int first = rb > cw_begin ? rb : cw_begin;
    if (first < cw_end) blocks += (cw_end - first + kColWords - 1) / kColWords;
  }
  return blocks;
}

}  // namespace

// boxes [B, N, 4] f32, scores [B, N] f32, order [B, N] int64 (stable
// descending sort of scores); scratch: B*N*words + B*words 64-bit words;
// state: B SweepStates then B*max_output int32 kept positions.
//
// Two phases. The greedy walk reads only the boxes before the one at which
// max_output are kept; at the flagship's thresholds nearly every valid box
// survives, so that is about max_output boxes into 6000. Phase 1 tests the
// pairs among the first `head` boxes (the first 2 * max_output, in whole
// words) and walks them; phase 2 (the pairs of every later column, and the
// rest of the walk) runs only for an image whose walk phase 1 did not end:
// its blocks exit at once otherwise. With head >= N there is one phase.
extern "C" int caesar_nms(const float* boxes, const float* scores,
                          const int64_t* order, int batch, int n, float thr,
                          int max_output, unsigned long long* scratch, void* state,
                          int32_t* out_idx, uint8_t* out_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1 || max_output < 1) return (int)cudaErrorInvalidValue;
  const int words = (n + kBlock - 1) / kBlock;
  const long long head_boxes = 2LL * max_output;
  const int head = head_boxes >= n ? words : (int)((head_boxes + kBlock - 1) / kBlock);
  unsigned long long* mask = scratch;
  unsigned long long* validbits = scratch + (size_t)batch * n * words;
  SweepState* st = static_cast<SweepState*>(state);
  int32_t* kept_pos = reinterpret_cast<int32_t*>(st + batch);
  const size_t smem = words * sizeof(unsigned long long);
  for (int phase = 0; phase < (head < words ? 2 : 1); ++phase) {
    const int rw_end = phase == 0 ? head : words;
    const int cw_begin = phase == 0 ? 0 : head;
    const int cw_end = phase == 0 ? head : words;
    nms_mask_kernel<<<dim3(mask_blocks(rw_end, cw_begin, cw_end), batch), kMaskThreads, 0, s>>>(
        boxes, scores, order, n, words, thr, rw_end, cw_begin, cw_end,
        phase == 0 ? nullptr : st, mask, validbits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(
        mask, validbits, order, n, words, cw_begin, cw_end, max_output, st, kept_pos,
        out_idx, out_valid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
