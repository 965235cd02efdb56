// Greedy NMS suppression for Hopper (sm_90a): keep mask of score-sorted boxes.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/nms_pallas.py::_nms_kernel
// (entry pallas_suppress). Same function: boxes [B,K,4] fp32 xyxy, sorted by
// descending score, class offsets already added by the caller; valid [B,K]
// bool -> alive [B,K] bool, equal bit for bit to the greedy result of
// pl_yolo_tpu_torch/ops/nms.py::greedy_suppress.
//
// Design. The TPU kernel holds a [K,K] fp32 overlap matrix (4 MB at K=1024)
// in VMEM and iterates a matvec to a fixpoint. A Hopper block has 227 KB of
// shared memory, so the work is split in two launches:
//   1. nms_mask_kernel: grid (column block, row block, image), 64 threads.
//      Thread t of block (cb, rb) owns row i = 64*rb + t and writes one
//      uint64 word: bit c is set iff column j = 64*cb + c has j > i and
//      IoU(i, j) > threshold. Blocks below the diagonal (cb < rb) exit
//      without writing; the sweep never reads their words. Scratch
//      [B, K, ceil(K/64)] words: 128 KB per image at K=1024.
//   2. nms_sweep_kernel: one warp per image walks the rows in score order
//      with the "removed" mask (ceil(K/64) words) in shared memory; invalid
//      rows start out removed. Row i is kept iff its removed bit is clear,
//      and a kept row removes the later rows its mask row names. Each mask
//      word names only later rows, so this sequential sweep gives the greedy
//      answer, which is also the fixpoint the TPU kernel reaches (the
//      argument at ops/nms.py::greedy_suppress). The sweep goes one 64-row
//      block at a time: the rows of the block are decided in registers from
//      the block's diagonal words (a chain of 64 register operations, not
//      64 trips through memory), then each lane ORs the kept rows' words
//      into its own later removed words, with all 64 of its loads in flight
//      at once. Per block the warp waits two load latencies (the diagonal
//      words, then the later words), not one per row.
//
// Bound. The IoU pass does 14 fp32 operations per pair (4 min/max for the
// intersection, 2 subtractions, 2 clamps, 1 product, 1 add and 1
// subtraction for the union, 1 clamp, 1 division, 1 compare) over K(K-1)/2
// pairs per image: 117 MFLOP at B=16, K=1024, about 1.75 us at the H100's
// 67 TFLOP/s of non-tensor fp32. Its bytes (17 KB in, 1 KB out per image)
// are negligible, so it is bound by operations. The sweep is a serial chain
// of K steps per image and is what this simple kernel's time is made of.
//
// Exactness. The IoU is the formula of ops/nms.py::_iou_matrix, operation
// for operation: sides clamped at 0, area from the clamped sides,
// union = (area_i + area_j) - inter, inter / max(union, 1e-12), and a strict
// > against the fp32 threshold. Every product, sum and quotient uses the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// and the build passes -fmad=false and no --use_fast_math: a contracted FMA
// or an approximate division moves an IoU by an ulp, and one ulp flips a
// box that sits at the threshold. The class offsets (class * 4096, up to
// about 80 * 4096, where fp32 spacing is 1/32) are added by the caller in
// fp32 before this kernel, the same add on the card and on the CPU.
// Non-finite coordinates (a decode whose exp overflowed gives boxes of
// infinite width) follow the plain version too. torch.maximum, minimum and
// clamp, like jnp's, return NaN for a NaN operand, where fmaxf and fminf
// return the other one; on the CPU any NaN in a pair's arithmetic makes
// its IoU NaN, which suppresses nothing. Here the areas (once a box) and
// the union's clamp (clamp_min) pass a NaN on, and that is enough: a NaN
// coordinate, or a side of inf - inf, makes its box's area NaN and so the
// union; a NaN width or height of the intersection needs such a side; an
// inf - inf union is NaN itself; and a 0 * inf intersection is NaN in
// both versions, which the inter > 0 test rejects. So every pair the CPU
// finds NaN has a NaN union here, and the others see the same numbers.
// K need not be a multiple of 64: the ragged last block is masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 64;  // rows (and columns) per mask block
constexpr int kMaxK = 16384;    // mask scratch: K * K / 8 bytes per image

__device__ __forceinline__ float clamp_min(float x, float lo) {  // NaN stays
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(clamp_min(__fsub_rn(x2, x1), 0.0f), clamp_min(__fsub_rn(y2, y1), 0.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int K, int nwords,
                                float threshold, unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;  // strictly below the diagonal: no pair with j > i
  __shared__ float cols[kBlockRows][5];  // x1, y1, x2, y2, area
  const int t = threadIdx.x;
  const int j0 = cb * kBlockRows;
  const int ncols = min(kBlockRows, K - j0);
  const float* base = boxes + (size_t)b * K * 4;
  if (t < ncols) {
    const float* p = base + (size_t)(j0 + t) * 4;
    cols[t][0] = p[0]; cols[t][1] = p[1]; cols[t][2] = p[2]; cols[t][3] = p[3];
    cols[t][4] = box_area(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();
  const int i = rb * kBlockRows + t;
  if (i >= K) return;
  const float* p = base + (size_t)i * 4;
  const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
  const float area_i = box_area(x1, y1, x2, y2);
  unsigned long long bits = 0ull;
  for (int c = (cb == rb) ? t + 1 : 0; c < ncols; ++c) {
    const float w = fmaxf(__fsub_rn(fminf(x2, cols[c][2]), fmaxf(x1, cols[c][0])), 0.0f);
    const float h = fmaxf(__fsub_rn(fminf(y2, cols[c][3]), fmaxf(y1, cols[c][1])), 0.0f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_i, cols[c][4]), inter);
    // 0 / max(union, 1e-12) is 0 (or NaN, which no more than 0 passes the
    // threshold): the many disjoint pairs (every pair of two classes) skip
    // the IEEE division and its slow-path check; a NaN inter does too
    const float iou = inter > 0.0f ? __fdiv_rn(inter, clamp_min(uni, 1e-12f)) : 0.0f;
    if (iou > threshold) bits |= 1ull << c;
  }
  mask[((size_t)b * K + i) * nwords + cb] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int K, int nwords,
                                 uint8_t* __restrict__ alive) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;         // [nwords]
  unsigned long long* diag = smem + nwords;   // [kBlockRows]
  const int b = blockIdx.x, lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  const unsigned long long* m = mask + (size_t)b * K * nwords;
  const uint8_t* v = valid + (size_t)b * K;
  uint8_t* out = alive + (size_t)b * K;

  // invalid rows start out removed: they are never kept and never suppress
#pragma unroll 8
  for (int w = 0; w < nwords; ++w) {
    const int lo = w * 64 + lane, hi = lo + 32;
    const unsigned vlo = __ballot_sync(full, lo < K && v[lo]);
    const unsigned vhi = __ballot_sync(full, hi < K && v[hi]);
    if (lane == 0) removed[w] = ~(((unsigned long long)vhi << 32) | vlo);
  }

  for (int rb = 0; rb < nwords; ++rb) {
    const int r0 = rb * kBlockRows, nrows = min(kBlockRows, K - r0);
    const unsigned long long* rows = m + (size_t)r0 * nwords;  // this row block
    diag[lane] = lane < nrows ? rows[lane * nwords + rb] : 0ull;
    diag[lane + 32] = lane + 32 < nrows ? rows[(lane + 32) * nwords + rb] : 0ull;
    __syncwarp();  // `diag` is written and `removed` is current

    // 1. Greedy inside the block, in registers (every lane the same): row r
    //    is kept iff its removed bit is clear; a kept row removes the later
    //    rows of the block that its diagonal word names. The 64 diagonal
    //    words are read first, all at once, so the chain is register
    //    operations only (rows past K are zero words and removed bits).
    unsigned long long d[kBlockRows];
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) d[r] = diag[r];
    unsigned long long rem = removed[rb], kept = 0ull;
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      const unsigned long long bit = 1ull << r;
      if (!(rem & bit)) {
        kept |= bit;
        rem |= d[r];
      }
    }
    if (lane < nrows) out[r0 + lane] = (kept >> lane) & 1ull;
    if (lane + 32 < nrows) out[r0 + lane + 32] = (kept >> (lane + 32)) & 1ull;

    // 2. The kept rows remove later rows of later blocks: each lane ORs
    //    the kept rows' words of its own columns of blocks, its 64 loads
    //    unrolled so that they are all in flight together.
    for (int w = rb + 1 + lane; w < nwords; w += 32) {
      unsigned long long acc = 0ull;
#pragma unroll
      for (int r = 0; r < kBlockRows; ++r)
        if (r < nrows) acc |= rows[r * nwords + w] & (0ull - ((kept >> r) & 1ull));
      removed[w] |= acc;
    }
    __syncwarp();  // `removed` is current, and `diag` may be rewritten
  }
}

}  // namespace

extern "C" {

// boxes [B,K,4] fp32, valid [B,K] uint8 (0/1), mask scratch [B,K,ceil(K/64)]
// uint64, alive [B,K] uint8: all contiguous on the current device. Launches
// on `stream`; returns the cudaError_t of the launches (0 on success).
// K may be at most kMaxK = 16384.
int nms_suppress(const float* boxes, const uint8_t* valid, unsigned long long* mask,
                 uint8_t* alive, int B, int K, float threshold, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK || B > 65535) return (int)cudaErrorInvalidValue;
  const int nwords = (K + kBlockRows - 1) / kBlockRows;
  const dim3 grid(nwords, nwords, B);
  nms_mask_kernel<<<grid, kBlockRows, 0, stream>>>(boxes, K, nwords, threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(nwords + kBlockRows) * sizeof(unsigned long long);
  nms_sweep_kernel<<<B, 32, smem, stream>>>(mask, valid, K, nwords, alive);
  return (int)cudaGetLastError();
}

}  // extern "C"
