// Row top-k values for Hopper (sm_90a): the k largest values of every row,
// descending, duplicates included, k <= 16.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/topk_pallas.py::_topk_kernel
// (entry topk_pallas). Same function: x [rows, A] fp32 -> out [rows, k] fp32,
// equal bit for bit to torch.topk(x, k, dim=-1).values for inputs without
// NaN (-inf entries are fine). No indices: SimOTA's dynamic-k consumes only
// the values (the sum of the top-10 IoUs, the k-th smallest cost).
//
// Design. The TPU kernel holds a 128-row x A tile in VMEM and reduces along
// lanes, k times. Here one thread block owns one row: the row (33.6 KB at
// A=8400) is copied from device memory into shared memory once, and every
// extraction pass reads only shared memory. Rows are independent, so the
// grid is `rows` blocks and nothing carries between them.
//
// The extraction is by distinct value, as in the TPU kernel, but without
// its erase step. With m the current maximum, one scan of the row computes
// both the number of entries equal to m and the largest entry strictly
// below m, which is the next pass's maximum; the row is never written. A
// pass is one scan plus one block reduction (warp shuffles, then one
// shared-memory step across the warps, double buffered so that a pass needs
// one __syncthreads). Slots [filled, filled + count) of the output take m.
// The loop ends as soon as k slots are filled, so the rows SimOTA really
// sends finish early: a row of exact zeros but a few entries (pair IoU of
// an invalid or far label) or of exact ties near -1e9 (the negated cost of
// a masked label) fills all k slots in one or two passes; a row of distinct
// values takes k passes. Once the scan reaches -inf the count covers every
// remaining entry, so rows with fewer than k finite entries end with -inf,
// as torch.topk gives them. A row without NaN is done after at most k scans.
// NaN is outside the contract, but the kernel ends on it all the same: a NaN
// entry equals nothing and is below nothing, so it is never counted, and
// after k scans the slots still open take NaN.
//
// Bound. Bytes: every input value is read once and k values per row are
// written, (rows*A + rows*k) * 4 bytes; at rows=800, A=8400, k=10 that is
// 26.9 MB, 8.0 us at the H100's 3.35 TB/s. The operations (at most k scans
// of one compare-and-max per entry, 0.13 GFLOP-equivalents) are far below
// that, so the kernel is bound by bytes. Values are selected, never computed:
// there is no arithmetic whose rounding could differ.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;
// the row in dynamic shared memory: 227 KB a block, less the static buffers
constexpr int kMaxA = 57344;

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, int A, int k, float* __restrict__ out) {
  extern __shared__ float row[];             // [A]
  __shared__ float warp_max[2][kWarps];      // double buffered by pass parity
  __shared__ int warp_cnt[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const float* src = x + (size_t)blockIdx.x * A;
  float* dst = out + (size_t)blockIdx.x * k;

  // load the row once; the first maximum comes with the load
  float next = -CUDART_INF_F;
  for (int i = tid; i < A; i += kThreads) {
    const float v = src[i];
    row[i] = v;
    next = fmaxf(next, v);
  }
  int cnt = 0;   // entries equal to the previous maximum (none yet)
  int filled = 0;
  float m = 0.0f;
  // Pass p reduces (next, cnt) over the block: `next` becomes the maximum m
  // of this pass and `cnt` the tie count of the previous one. Pass 0 only
  // finds the first maximum; pass k only counts.
  for (int pass = 0; pass <= k; ++pass) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      next = fmaxf(next, __shfl_xor_sync(full, next, off));
      cnt += __shfl_xor_sync(full, cnt, off);
    }
    const int buf = pass & 1;
    if (lane == 0) {
      warp_max[buf][warp] = next;
      warp_cnt[buf][warp] = cnt;
    }
    __syncthreads();  // also orders the row's stores before the first scan
    float bm = warp_max[buf][0];
    int bc = warp_cnt[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      bm = fmaxf(bm, warp_max[buf][w]);
      bc += warp_cnt[buf][w];
    }
    if (pass > 0) {
      // the previous maximum m had bc ties: they take the next bc slots
      const int slot = filled + tid;
      if (tid < bc && slot < k) dst[slot] = m;
      filled += bc;
      if (filled >= k) return;
    }
    if (pass == k) break;  // only a row holding NaN comes here
    m = bm;
    // one scan: ties of m, and the largest value strictly below m
    next = -CUDART_INF_F;
    cnt = 0;
    for (int i = tid; i < A; i += kThreads) {
      const float v = row[i];
      cnt += (v == m);
      if (v < m) next = fmaxf(next, v);
    }
  }
  if (tid >= filled && tid < k) dst[tid] = CUDART_NAN_F;
}

}  // namespace

extern "C" {

// x [rows, A] fp32 and out [rows, k] fp32, contiguous on the current device.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
// 1 <= k <= 16, k <= A <= kMaxA = 57344 (the row lives in shared memory).
int topk_rows(const float* x, float* out, int rows, int A, int k, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > kMaxK || A < k || A > kMaxA) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_rows_kernel<<<rows, kThreads, smem, stream>>>(x, A, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
