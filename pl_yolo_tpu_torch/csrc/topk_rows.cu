// Row top-k values for Hopper (sm_90a): the k largest values of every row,
// descending, duplicates included, 1 <= k <= 16.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/topk_pallas.py::_topk_kernel
// (entry topk_pallas). Same function: x [rows, A] fp32 -> out [rows, k] fp32,
// equal bit for bit to torch.topk(x, k, dim=-1).values for inputs without
// NaN (-inf entries are fine). No indices: SimOTA's dynamic-k consumes only
// the values (the sum of the top-10 IoUs, the k-th smallest cost).
//
// Bound. Bytes: every input value is read once and k values per row are
// written, (rows*A + rows*k) * 4 bytes; at the training path's [16,50,8400]
// (800 rows, k=10) that is 26.9 MB, 8.03 us at the H100's 3.35 TB/s, and
// at the augmented step's [16,100,8400] 53.8 MB, 16.07 us. The operations
// (one compare per entry in the common case) are far below that, so the
// kernel is bound by bytes. Values are selected, never computed: no
// arithmetic whose rounding could differ, and every slot holds an entry of
// the row.
//
// Design: one streaming pass, the selection in registers. A block of
// kWarps = 3 warps owns a row. Each thread reads its share of the row once
// from device memory in 16-byte loads (__ldcs: every byte is read once,
// and evict-first lines spare the L2's other lines), the next batch of
// kUnroll loads in flight while it selects among the last. Each warp keeps
// its running top K spread over its lanes (lane i holds the i-th value),
// so the K-th is one register, the same in every lane. For each value the
// common case is one compare against a bar of at least that K-th, and one
// vote a batch. The values above the bar are packed by ballots into a
// 32-slot queue in shared memory and merged with the list in one step:
// each value's new slot is its rank, counted against the queue and the
// list (smaller than K: it stays), so a batch costs one step however many
// of its values rise, and a batch of ties one step too. The warps of a row
// share their K-ths through shared memory: the largest is everyone's bar,
// since the lists already hold K values at least as large, and a list's
// count of values at or above any x never falls; a stale bar is only lower.
// The warps' lists are merged by rank at the end (ties to the lower warp).
// K is a template parameter (one kernel for each k), so the lists index no
// registers at run time and nothing spills.
//
// Against the PR 2 version. That version copied the row into 33.6 KB of
// shared memory (6 blocks an SM, so rows ran in waves) and then scanned it
// once per distinct value among the top k, with a block reduction and a
// __syncthreads each: up to 11 scans of a row after its load. Measured on
// an H100 (chip_topk_ab.py) its waves cost nothing measurable (the first
// 792 rows of 800 take as long as all 800) and its passes most of the
// time: 41 us for 800 rows of distinct values against 19 us for 800 rows
// of zeros, L2 cold. Here there are no passes and no staging: a block of
// 96 threads holds under 1 KB of shared memory, so shared memory no longer
// sets how many rows are resident (registers do: 40-51 a thread), and the
// selection overlaps the loads. What a row of the training path costs
// beyond the loads is its list's rises: a valid label's row rises some 40
// times a warp (its IoUs and costs climb across the image); one merge step
// a batch takes those together.
//
// Row starts off 16-byte alignment (odd A, or a view's offset) are handled
// by a scalar head before the vector loads and a scalar tail after them.
// Entries of -inf never rise above the lists' initial -inf, so rows with
// fewer than k finite entries end with -inf, as torch.topk gives them. NaN
// is outside the contract; all the same, a NaN entry is never selected but
// counted, and the slots at or beyond the row's count of non-NaN entries
// come back NaN.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 3;   // warps a row
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;  // 16-byte loads a batch a thread
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }

__device__ __forceinline__ void load_batch(float4 (&v)[kUnroll],
                                           const float4* __restrict__ p,
                                           int first, int n) {
  const float m = neg_inf();
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = first + u * kThreads;
    v[u] = i < n ? __ldcs(p + i) : make_float4(m, m, m, m);
  }
}

// The warp's running top K, spread over its lanes: lane i < K holds the
// i-th largest value taken so far (lanes from K on hold -inf), and `kth`,
// the same in every lane, is lane K-1's.
template <int K>
struct WarpTop {
  float mine, kth;
  int nans;  // NaN entries this lane has seen

  __device__ WarpTop() : mine(neg_inf()), kth(neg_inf()), nans(0) {}

  // Every lane's values v[0..N) at once. Those above `bar` (>= kth; see
  // the kernel) are packed, up to 32 at a time, into q by ballots, and
  // merged with the list in one step: each value's new slot is its rank,
  // counted against the others (list entries before candidates of the
  // same value, candidates by queue order). One step a batch whose new
  // values fit in q; a batch of ties takes one as well, since the bar
  // rises to their value after the first 32.
  template <int N>
  __device__ __forceinline__ void take(float (&v)[N], int lane, float bar,
                                       float* q, float* lst, float* nl) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (v[j] != v[j]) { ++nans; v[j] = neg_inf(); }
    const unsigned below = (1u << lane) - 1u;
    for (;;) {
      int n = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool c = v[j] > bar;
        const unsigned b = __ballot_sync(kFull, c);
        const int pos = n + __popc(b & below);
        if (c && pos < 32) { q[pos] = v[j]; v[j] = neg_inf(); }
        n += __popc(b);
      }
      if (n == 0) return;
      const int count = min(n, 32);
      if (lane < K) lst[lane] = mine;
      __syncwarp();
      const float cand = lane < count ? q[lane] : neg_inf();
      int rank_c = 0, rank_l = lane;
#pragma unroll 8
      for (int i = 0; i < count; ++i) {
        const float qi = q[i];
        rank_c += (qi > cand) | ((qi == cand) & (i < lane));
        rank_l += qi > mine;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) rank_c += lst[j] >= cand;
      if (lane < count && rank_c < K) nl[rank_c] = cand;
      if (lane < K && rank_l < K) nl[rank_l] = mine;
      __syncwarp();
      if (lane < K) mine = nl[lane];
      kth = __shfl_sync(kFull, mine, K - 1);
      bar = fmaxf(bar, kth);
      __syncwarp();  // q, lst and nl are read before they are written again
      if (n <= 32) return;
    }
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, int A, float* __restrict__ out) {
  __shared__ float part[kWarps][K];
  __shared__ int part_nans[kWarps];
  // each warp's kth as it rises: the largest is every warp's bar
  __shared__ volatile float kths[kWarps];
  __shared__ float queue[kWarps][32], lists[kWarps][kMaxK], merged[kWarps][kMaxK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = x + (size_t)blockIdx.x * A;
  WarpTop<K> top;
  if (lane == 0) kths[warp] = neg_inf();
  __syncthreads();

  // scalar head up to 16-byte alignment, the float4 body, the scalar tail
  const int head = min((int)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2), A);
  const int nvec = (A - head) >> 2;
  const int tail = head + 4 * nvec;
  float ends[2] = {tid < head ? row[tid] : neg_inf(),
                   tail + tid < A ? row[tail + tid] : neg_inf()};
  float* const q = queue[warp];
  float* const lst = lists[warp];
  float* const nl = merged[warp];
  top.take(ends, lane, top.kth, q, lst, nl);

  const float4* body = reinterpret_cast<const float4*>(row + head);
  float4 cur[kUnroll];
  load_batch(cur, body, tid, nvec);
  // the block's trip count, so that every lane of a warp takes part
  for (int first = 0; first < nvec; first += kUnroll * kThreads) {
    float4 nxt[kUnroll];
    load_batch(nxt, body, first + kUnroll * kThreads + tid, nvec);
    float v[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[4 * u] = cur[u].x;
      v[4 * u + 1] = cur[u].y;
      v[4 * u + 2] = cur[u].z;
      v[4 * u + 3] = cur[u].w;
    }
    // one compare a value against the bar and one vote a batch
    float bar = top.kth;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bar = fmaxf(bar, kths[w]);
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4 * kUnroll; ++j) any |= !(v[j] <= bar);
    if (__any_sync(kFull, any)) {
      top.take(v, lane, bar, q, lst, nl);
      if (lane == 0) kths[warp] = top.kth;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }

  const int nans = __reduce_add_sync(kFull, top.nans);
  if (lane < K) part[warp][lane] = top.mine;
  if (lane == 0) part_nans[warp] = nans;
  __syncthreads();

  // merge the warps' lists by rank: ties go to the lower warp first
  if (tid < kWarps * K) {
    const int w = tid / K, r = tid % K;
    const float v = part[w][r];
    int rank = r, row_nans = 0;
#pragma unroll
    for (int o = 0; o < kWarps; ++o) {
      row_nans += part_nans[o];
      if (o == w) continue;
#pragma unroll
      for (int j = 0; j < K; ++j)
        rank += o < w ? (part[o][j] >= v) : (part[o][j] > v);
    }
    if (rank < K)
      out[(size_t)blockIdx.x * K + rank] =
          rank < A - row_nans ? v : CUDART_NAN_F;
  }
}

template <int K>
int launch(const float* x, float* out, int rows, int A, cudaStream_t stream) {
  topk_rows_kernel<K><<<rows, kThreads, 0, stream>>>(x, A, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, A] fp32 and out [rows, k] fp32, contiguous on the current device.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
// 1 <= k <= 16 and k <= A; a row has no length limit beyond int.
int topk_rows(const float* x, float* out, int rows, int A, int k, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > kMaxK || A < k) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return launch<1>(x, out, rows, A, stream);
    case 2: return launch<2>(x, out, rows, A, stream);
    case 3: return launch<3>(x, out, rows, A, stream);
    case 4: return launch<4>(x, out, rows, A, stream);
    case 5: return launch<5>(x, out, rows, A, stream);
    case 6: return launch<6>(x, out, rows, A, stream);
    case 7: return launch<7>(x, out, rows, A, stream);
    case 8: return launch<8>(x, out, rows, A, stream);
    case 9: return launch<9>(x, out, rows, A, stream);
    case 10: return launch<10>(x, out, rows, A, stream);
    case 11: return launch<11>(x, out, rows, A, stream);
    case 12: return launch<12>(x, out, rows, A, stream);
    case 13: return launch<13>(x, out, rows, A, stream);
    case 14: return launch<14>(x, out, rows, A, stream);
    case 15: return launch<15>(x, out, rows, A, stream);
    default: return launch<16>(x, out, rows, A, stream);
  }
}

}  // extern "C"
