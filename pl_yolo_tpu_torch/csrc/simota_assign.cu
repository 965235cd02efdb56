// Fused SimOTA label assignment for Hopper (sm_90a): per image, the in-box
// and in-centre gates, the pair IoU, the cls x obj BCE cost, dynamic-k from
// the sum of the 10 largest IoUs, the k-th smallest cost as each label's
// threshold, and the resolution of anchors claimed by more than one label.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/simota_pallas.py::
// _simota_kernel (entry simota_assign_pallas). Inputs: labels gt [B,M,4]
// cxcywh, classes [B,M] int64, validity [B,M] bool; predictions [B,A,4]
// cxcywh, obj logits [B,A], cls logits [B,A,C], all fp32; anchors x_shifts,
// y_shifts, strides [A]. Outputs: fg [B,A] bool, matched [B,A] int64 (the
// matched label slot, 0 where not fg), pred_iou [B,A] fp32.
//
// Arithmetic. The formulas are the port's dense path (models/losses/
// yolox.py: _gates, pairwise_iou on cxcywh2xyxy with areas from the xyxy
// corners, _cls_cost_terms, _cost_and_claims), operation for operation in
// fp32, built with -fmad=false: nothing is contracted, nothing reassociated.
// Where the dense path leaves an order to a library reduction, the kernel
// fixes one and the plain version (ops/cuda/simota.py::simota_fused_plain)
// repeats it: S = -sum_c log(1 - p_c) adds c = 0..C-1 in order from 0, and
// the top-10 IoU sum adds from 0 in descending order. Not carried over from
// the TPU kernel: its bf16 rounding of log p and log(1 - p) (the TPU's
// default matmul precision) and its padding of M, A and C to the TPU's tiles.
// NaN: a NaN cost counts as +inf where costs are ranked (the threshold, the
// argmin) and claims nothing; a NaN IoU ranks as -inf. Every loop is bounded,
// so an input with NaN ends like any other.
//
// Of a row's costs, only the pairs inside both gates matter, as a rule. An
// anchor outside both gates of every valid label of its image (not
// fg_cand) has IoU 0 with every label and a cost of at least 1e9 + 1e5
// (INVALID_PENALTY and CENTER_PENALTY on top of a cls cost that is >= 0 up
// to rounding), or NaN; a candidate pair outside both gates of its label
// costs at least 1e5 - 0.01; a pair inside both costs less than kBothBound
// = 5e4 (at most C * 16.7 + 73.8). So a row's 10 smallest costs are the 10
// smallest of its pairs inside both gates whenever the tenth of those is
// below 5e4. A row with fewer than ten such pairs computes every anchor's
// cost; a row where the rule fails (NaN or huge costs) takes the full scan
// of the first version. Either way every row keeps the answer of the full
// scan. An IoU needs no transcendental; a cost needs five.
//
// Design. The TPU kernel keeps one image's [M', A'] working set in ~100 MB
// of VMEM. Here nothing [M, A]-shaped exists anywhere (at B=16, M=100 it
// would be 53.8 MB a tensor): every pair's IoU and cost is recomputed in
// registers where it is needed. The first version streamed all A anchors
// for every label row in one block a row (few blocks with work, ten block
// barriers a row, a cost with its transcendentals for every pair) and
// recomputed every pair again in the claims pass. Four passes, launched in
// order on one stream after a memset of the both-gate counts:
//  (a) anchor_pass, one thread per anchor: sigmoid(obj), S over the C
//      classes (the cls logits staged through shared memory in 32-class
//      chunks, so that a warp reads whole rows), fg_cand (the OR over the
//      image's valid labels of the two gates) and each label's count of
//      anchors inside both its gates. Writes S, sigmoid(obj) and fg_cand
//      [B,A], and clears the claims.
//  (b1) label_pass, a block per (image, 8 label rows, 512 anchors), a warp
//      a row: the block stages the anchors' boxes, S, sigmoid(obj) and
//      fg_cand once in shared memory for all 8 rows; each lane keeps its 10
//      largest IoUs and 10 smallest costs (with their anchors) sorted in
//      registers, and ten warp arg-max rounds (shuffles, no barrier) write
//      the chunk's lists of the row. Where the row has ten or more pairs
//      inside both gates, only those pairs' costs are computed and only
//      their logits gathered (a 32-byte sector each).
//  (b2) label_merge_pass, a warp per valid row: merges the chunks' lists by
//      the same rounds (or takes the full scan where the rule fails);
//      dynamic_k = clamp(trunc(sum), 1, 10) and kth_cost. The row claims
//      the candidates whose cost is <= kth_cost: while fewer than 10 listed
//      costs are <= kth_cost these are all listed (one atomic add of a
//      claim count and one atomic min of the first claimer each); with ties
//      at kth_cost the warp tests every candidate.
//  (c) assign_pass, a thread per anchor: no claim gives nothing; one claim
//      gives its label, with the pair recomputed for its IoU; several give
//      the label of least cost, a running strict-< argmin over the valid
//      labels in order (the first minimum wins): over the labels whose both
//      gates hold first (the claims cost <= kth_cost), over all valid
//      labels where that minimum is not below 5e4. The argmin of the dense
//      path runs over all M rows; an invalid row's cost is >= 1e9, so the
//      invalid rows are visited only for a multiply-claimed anchor whose
//      best valid cost is not below 1e9 (a NaN, or logits so large that p
//      rounds to 1). (b) and (c) compute a pair by the same two __device__
//      functions, so every IoU and cost bit agrees.
// The claims are counted by atomic add and the first claimer kept by
// atomic min, so no result depends on the order of the warps.
//
// Bound (B=16, A=8400, C=80, M=100). Bytes: the cls logits are read once,
// 43.0 MB of the 47.6 MB that the function must move, 14.2 us at 3.35 TB/s.
// Operations, a transcendental counted as one: 11 a class term (B*A*C =
// 10.75 M) and 55 a pair of a valid label and an anchor (B*A a valid label
// slot), some 270 MFLOP with 325 valid labels, 4 us at 67 TFLOP/s. So the
// function is bound by bytes. The kernel is not: the IEEE-exact expf,
// division, sqrtf and log1pf of a class term take tens of instructions
// (not measured: no hardware counters on the card's machine), and one
// thread an anchor fills half of the card's thread slots at B=16, so pass
// (a) alone takes ~4x the bound. The both-gate rule takes the
// transcendentals out of all but a few per cent of the pairs. On the train
// step's M=50 / M=100 inputs the four passes take 6.9x / 10.1x the bound
// (the first version 8.6x / 13.9x), pass (a) half of it (chip_smoke.py on
// an H100 80GB HBM3 at 700 W; numbers in PERF.md). A compact list of the
// candidate anchors did not pay for itself there: 65-100% of the anchors
// are candidates. A simple kernel: no TMA, no tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTop = 10;         // SimOTA's top-k: dynamic_k <= 10
constexpr int kLabChunk = 128;   // labels staged in shared memory at a time
constexpr int kClsChunk = 32;    // classes staged in shared memory at a time
constexpr int kChunk = 512;      // anchors a block in pass (b1)
constexpr int kPart = 3 * kTop;  // a chunk's lists: IoUs, costs, their anchors
// an anchor's fields as pass (b1) stages them: its Anchor (xc, yc, rad, x1,
// y1, x2, y2, area), S, sigmoid(obj) and fg_cand
constexpr int kFields = 11;
constexpr int kUnroll = 4;       // labels whose logits (c) gathers ahead
constexpr float kCenterPenalty = 100000.0f;
constexpr float kInvalidPenalty = 1e9f;
// A pair inside both gates costs less than this (C * 16.7 + 73.8 for C
// classes, as long as C < 2990), any other candidate pair at least
// CENTER_PENALTY - 0.01, a non-candidate at least INVALID_PENALTY.
constexpr float kBothBound = 50000.0f;
constexpr float kIouEps = 1e-8f;
constexpr float kUnionMin = 1e-12f;
constexpr float kPLo = 1e-8f;
// 1 - 1e-8 rounds to 1.0f, as the plain version's fp32 clamp rounds it
constexpr float kPHi = static_cast<float>(1.0 - 1e-8);

struct Args {
  const float* gt; int64_t gt_sb, gt_sm;        // [B,M,4], unit stride in the box
  const int64_t* gcls;                          // [B,M] contiguous
  const uint8_t* gvalid;                        // [B,M] contiguous
  const float* pred; int64_t pred_sb, pred_sa;  // [B,A,4], unit stride in the box
  const float* obj; int64_t obj_sb, obj_sa;     // [B,A]
  const float* cls; int64_t cls_sb, cls_sa;     // [B,A,C], unit stride in C
  const float* xs; const float* ys; const float* st;  // [A] contiguous
  int B, M, A, C;
  float radius;
  float* s_all; float* sig_obj; float* cand;    // workspace [B,A] each
  int* claims; int* first;                      // workspace [B,A] each
  int* nboth;                                   // workspace [B,M]: pairs in both gates
  float* part;                                  // workspace [B,M,Q,kPart]
  int Q;                                        // chunks of kChunk: ceil(A/kChunk)
  uint8_t* fg; int64_t* matched; float* piou;   // outputs [B,A]
};

// torch.maximum / torch.minimum / clamp(min=): NaN propagates
__device__ __forceinline__ float t_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float t_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));   // torch's sigmoid on the card
}

// p = clip(sqrt(sigmoid(cls) * sigmoid(obj)), 1e-8, 1 - 1e-8)
__device__ __forceinline__ float class_p(float logit, float sig_obj) {
  const float p = sqrtf(sigmoid(logit) * sig_obj);
  return p != p ? p : fminf(fmaxf(p, kPLo), kPHi);
}

struct Label {  // a label's box as both gates and the IoU read it
  float cx, cy, x1, y1, x2, y2, area;
  int cls;  // clipped to [0, C-1]
};

__device__ __forceinline__ Label make_label(const Args& g, int b, int m) {
  const float* box = g.gt + b * g.gt_sb + m * g.gt_sm;
  const float cx = box[0], cy = box[1], w = box[2], h = box[3];
  Label L;
  L.cx = cx;
  L.cy = cy;
  L.x1 = cx - w * 0.5f;
  L.y1 = cy - h * 0.5f;
  L.x2 = cx + w * 0.5f;
  L.y2 = cy + h * 0.5f;
  L.area = clamp_lo(L.x2 - L.x1, 0.0f) * clamp_lo(L.y2 - L.y1, 0.0f);
  const int64_t c = g.gcls[(int64_t)b * g.M + m];
  L.cls = (int)(c < 0 ? 0 : (c > g.C - 1 ? g.C - 1 : c));
  return L;
}

struct Anchor {  // an anchor's centre and gate radius, and its predicted box
  float xc, yc, rad, x1, y1, x2, y2, area;
};

__device__ __forceinline__ Anchor make_anchor(const Args& g, int b, int a) {
  const float s = g.st[a];
  const float* p = g.pred + b * g.pred_sb + a * g.pred_sa;
  const float cx = p[0], cy = p[1], w = p[2], h = p[3];
  Anchor an;
  an.xc = (g.xs[a] + 0.5f) * s;
  an.yc = (g.ys[a] + 0.5f) * s;
  an.rad = g.radius * s;
  an.x1 = cx - w * 0.5f;
  an.y1 = cy - h * 0.5f;
  an.x2 = cx + w * 0.5f;
  an.y2 = cy + h * 0.5f;
  an.area = clamp_lo(an.x2 - an.x1, 0.0f) * clamp_lo(an.y2 - an.y1, 0.0f);
  return an;
}

__device__ __forceinline__ void gates(const Label& L, const Anchor& an,
                                      bool& in_box, bool& in_center) {
  in_box = t_min(t_min(an.xc - L.x1, L.x2 - an.xc),
                 t_min(an.yc - L.y1, L.y2 - an.yc)) > 0.0f;
  in_center = t_min(t_min(an.xc - (L.cx - an.rad), (L.cx + an.rad) - an.xc),
                    t_min(an.yc - (L.cy - an.rad), (L.cy + an.rad) - an.yc)) > 0.0f;
}

// The pair (label L, anchor an) in two steps: the gates and the IoU masked
// by `cand` (valid label and fg_cand anchor), then the cost, which takes
// the transcendentals. Passes (b) and (c) both call these two functions, so
// they agree on every cost bit for bit.
struct Geo {
  float iou;
  bool both, cand;  // inside both gates of a valid label; a candidate pair
};

__device__ __forceinline__ Geo pair_geo(const Label& L, bool valid, const Anchor& an,
                                        bool fg_cand) {
  bool in_box, in_center;
  gates(L, an, in_box, in_center);
  Geo q;
  q.both = valid && in_box && in_center;
  q.cand = valid && fg_cand;
  q.iou = 0.0f;
  if (q.cand) {
    const float iw = clamp_lo(t_min(L.x2, an.x2) - t_max(L.x1, an.x1), 0.0f);
    const float ih = clamp_lo(t_min(L.y2, an.y2) - t_max(L.y1, an.y1), 0.0f);
    const float inter = iw * ih;
    q.iou = inter / clamp_lo((L.area + an.area) - inter, kUnionMin);
  }
  return q;
}

__device__ __forceinline__ float pair_cost(const Geo& q, float logit, float sig_obj,
                                           float s_all) {
  const float p = class_p(logit, sig_obj);
  const float cls_cost = (s_all - logf(p)) + log1pf(-p);
  float c = cls_cost + 3.0f * (-logf(q.iou + kIouEps));
  if (!q.both) c = c + kCenterPenalty;
  if (!q.cand) c = c + kInvalidPenalty;
  return c;
}

__device__ __forceinline__ float pair(const Label& L, bool valid, const Anchor& an,
                                      bool fg_cand, float logit, float sig_obj,
                                      float s_all, float* cost) {
  const Geo q = pair_geo(L, valid, an, fg_cand);
  *cost = pair_cost(q, logit, sig_obj, s_all);
  return q.iou;
}

__device__ __forceinline__ float logit_at(const Args& g, int b, int a, int c) {
  return g.cls[b * g.cls_sb + a * g.cls_sa + c];
}

// Stage labels [m0, m0+n) of image b in shared memory (n <= kLabChunk).
__device__ __forceinline__ void stage_labels(const Args& g, int b, int m0, int n,
                                             Label* lab, int* valid) {
  const int t = threadIdx.x;
  if (t < n) {
    lab[t] = make_label(g, b, m0 + t);
    valid[t] = g.gvalid[(int64_t)b * g.M + m0 + t] != 0;
  }
}

// v keeps the N largest values seen, in descending order (NaN never enters)
__device__ __forceinline__ void push_top(float (&v)[kTop], float x) {
  if (x > v[kTop - 1]) {
    v[kTop - 1] = x;
#pragma unroll
    for (int j = kTop - 1; j > 0; --j) {
      if (v[j] > v[j - 1]) {
        const float t = v[j]; v[j] = v[j - 1]; v[j - 1] = t;
      }
    }
  }
}

// v keeps the N smallest values seen, in ascending order, with their
// anchors in id (NaN never enters)
__device__ __forceinline__ void push_low(float (&v)[kTop], int (&id)[kTop], float x, int a) {
  if (x < v[kTop - 1]) {
    v[kTop - 1] = x;
    id[kTop - 1] = a;
#pragma unroll
    for (int j = kTop - 1; j > 0; --j) {
      if (v[j] < v[j - 1]) {
        const float t = v[j]; v[j] = v[j - 1]; v[j - 1] = t;
        const int u = id[j]; id[j] = id[j - 1]; id[j - 1] = u;
      }
    }
  }
}

__device__ __forceinline__ void clear_lists(float (&top)[kTop], float (&low)[kTop],
                                            int (&id)[kTop]) {
#pragma unroll
  for (int i = 0; i < kTop; ++i) {
    top[i] = -CUDART_INF_F;
    low[i] = CUDART_INF_F;
    id[i] = 0;
  }
}

// Ten rounds over the lanes' sorted lists: the warp's largest remaining IoU
// and smallest remaining cost are the best of the lanes' heads; the winning
// lane (the lowest on ties) drops its head. Every lane ends with the warp's
// 10 largest IoUs (descending, -inf where there are fewer) and 10 smallest
// costs (ascending, +inf where fewer) with their anchors.
__device__ __forceinline__ void warp_rounds(float (&top)[kTop], float (&low)[kTop],
                                            int (&id)[kTop], float (&tops)[kTop],
                                            float (&lows)[kTop], int (&ids)[kTop]) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < kTop; ++r) {
    float hv = top[0], lv = low[0];
    int hi = lane, li = lane, la = id[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(full, hv, off);
      const int oi = __shfl_xor_sync(full, hi, off);
      if (ov > hv || (ov == hv && oi < hi)) { hv = ov; hi = oi; }
      const float pv = __shfl_xor_sync(full, lv, off);
      const int pi = __shfl_xor_sync(full, li, off);
      const int pa = __shfl_xor_sync(full, la, off);
      if (pv < lv || (pv == lv && pi < li)) { lv = pv; li = pi; la = pa; }
    }
    tops[r] = hv;
    lows[r] = lv;
    ids[r] = la;
    if (lane == hi) {
#pragma unroll
      for (int j = 0; j < kTop - 1; ++j) top[j] = top[j + 1];
      top[kTop - 1] = -CUDART_INF_F;
    }
    if (lane == li) {
#pragma unroll
      for (int j = 0; j < kTop - 1; ++j) { low[j] = low[j + 1]; id[j] = id[j + 1]; }
      low[kTop - 1] = CUDART_INF_F;
    }
  }
}

// (a) one thread per anchor: sigmoid(obj), S, fg_cand, the both-gate
// counts, and the claims cleared.
__global__ void __launch_bounds__(kThreads) anchor_pass(Args g) {
  __shared__ float tile[kThreads][kClsChunk + 1];  // +1: no bank conflicts
  __shared__ Label lab[kLabChunk];
  __shared__ int lvalid[kLabChunk];
  __shared__ int nboth[kLabChunk];
  const int tid = threadIdx.x;
  const int b = blockIdx.y, a0 = blockIdx.x * kThreads, a = a0 + tid;
  const bool live = a < g.A;
  const float sig_obj = live ? sigmoid(g.obj[b * g.obj_sb + a * g.obj_sa]) : 0.0f;

  float acc = 0.0f;  // sum_c log(1 - p_c), c in order
  const float* cls_b = g.cls + b * g.cls_sb;
  for (int c0 = 0; c0 < g.C; c0 += kClsChunk) {
    const int cw = min(kClsChunk, g.C - c0);
    __syncthreads();  // the previous chunk is consumed
    if (cw == kClsChunk) {  // a full chunk: a warp a row, no division
      for (int i = threadIdx.x; i < kThreads * kClsChunk; i += kThreads) {
        const int r = i / kClsChunk, c = i % kClsChunk;
        tile[r][c] = a0 + r < g.A ? cls_b[(int64_t)(a0 + r) * g.cls_sa + c0 + c] : 0.0f;
      }
    } else {
      for (int i = threadIdx.x; i < kThreads * cw; i += kThreads) {
        const int r = i / cw, c = i - r * cw;
        tile[r][c] = a0 + r < g.A ? cls_b[(int64_t)(a0 + r) * g.cls_sa + c0 + c] : 0.0f;
      }
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < cw; ++c)
        acc = acc + log1pf(-class_p(tile[tid][c], sig_obj));
    }
  }

  Anchor an;
  if (live) an = make_anchor(g, b, a);
  bool fg_cand = false;
  for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
    const int n = min(kLabChunk, g.M - m0);
    __syncthreads();
    stage_labels(g, b, m0, n, lab, lvalid);
    if (threadIdx.x < n) nboth[threadIdx.x] = 0;
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        if (!lvalid[j]) continue;
        bool in_box, in_center;
        gates(lab[j], an, in_box, in_center);
        fg_cand = fg_cand || in_box || in_center;
        if (in_box && in_center) atomicAdd(nboth + j, 1);
      }
    }
    __syncthreads();
    if (threadIdx.x < n && nboth[threadIdx.x] > 0)
      atomicAdd(g.nboth + (int64_t)b * g.M + m0 + threadIdx.x, nboth[threadIdx.x]);
  }
  if (!live) return;
  const int64_t i = (int64_t)b * g.A + a;
  g.s_all[i] = -acc;
  g.sig_obj[i] = sig_obj;
  g.cand[i] = fg_cand ? 1.0f : 0.0f;
  g.claims[i] = 0;
  g.first[i] = g.M;
}

// (b1) a block per (image, 8 label rows, kChunk anchors), a warp a row: the
// chunk's 10 largest IoUs and 10 smallest costs of each valid row, with the
// costs' anchors. The block stages each anchor's box, S, sigmoid(obj) and
// fg_cand once, for all 8 rows.
__global__ void __launch_bounds__(kThreads) label_pass(Args g) {
  __shared__ float f_sh[kFields][kChunk];
  __shared__ Label lab[kWarps];
  __shared__ int lvalid[kWarps], lall[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, m0 = blockIdx.x * kWarps, q = blockIdx.y;
  const int e0 = q * kChunk, n = min(kChunk, g.A - e0);
  if (tid < kWarps) {
    const int m = m0 + tid;
    lvalid[tid] = m < g.M && g.gvalid[(int64_t)b * g.M + m] != 0;
    if (lvalid[tid]) {
      lab[tid] = make_label(g, b, m);
      lall[tid] = g.nboth[(int64_t)b * g.M + m] < kTop;
    }
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int r = 0; r < kWarps; ++r) any = any || lvalid[r];
  if (!any) return;  // the whole block: empty label slots
  for (int e = tid; e < n; e += kThreads) {
    const int a = e0 + e;
    const Anchor an = make_anchor(g, b, a);
    const int64_t i = (int64_t)b * g.A + a;
    const float f[kFields] = {an.xc, an.yc, an.rad, an.x1, an.y1, an.x2, an.y2,
                              an.area, g.s_all[i], g.sig_obj[i], g.cand[i]};
#pragma unroll
    for (int k = 0; k < kFields; ++k) f_sh[k][e] = f[k];
  }
  __syncthreads();
  if (!lvalid[warp]) return;  // no barrier follows
  const Label L = lab[warp];
  // With 10 or more pairs inside both gates, only those pairs' costs can be
  // among the row's 10 smallest (kBothBound); (b2) checks that it holds.
  const bool all_costs = lall[warp];
  float top[kTop], low[kTop];
  int id[kTop];
  clear_lists(top, low, id);
  for (int e = lane; e < n; e += 32) {
    Anchor an;
    an.xc = f_sh[0][e]; an.yc = f_sh[1][e]; an.rad = f_sh[2][e];
    an.x1 = f_sh[3][e]; an.y1 = f_sh[4][e]; an.x2 = f_sh[5][e];
    an.y2 = f_sh[6][e]; an.area = f_sh[7][e];
    const Geo geo = pair_geo(L, true, an, f_sh[10][e] != 0.0f);
    push_top(top, geo.iou);
    if (all_costs || geo.both) {  // the logit gathered only for a cost
      push_low(low, id,
               pair_cost(geo, logit_at(g, b, e0 + e, L.cls), f_sh[9][e], f_sh[8][e]),
               e0 + e);
    }
  }
  float tops[kTop], lows[kTop];
  int ids[kTop];
  warp_rounds(top, low, id, tops, lows, ids);
  if (lane == 0) {
    float* out = g.part + (((int64_t)b * g.M + m0 + warp) * g.Q + q) * kPart;
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      out[j] = tops[j];
      out[kTop + j] = lows[j];
      out[2 * kTop + j] = __int_as_float(ids[j]);
    }
  }
}

// (b2) a warp per valid label row: dynamic_k, the k-th smallest cost, and
// the row's claims on its anchors.
__global__ void __launch_bounds__(kThreads) label_merge_pass(Args g) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)g.B * g.M || !g.gvalid[row]) return;  // the whole warp
  const int b = (int)(row / g.M), m = (int)(row - (int64_t)b * g.M);
  const Label L = make_label(g, b, m);
  const float* cand = g.cand + (int64_t)b * g.A;

  float top[kTop], low[kTop], tops[kTop], lows[kTop];
  int id[kTop], ids[kTop];
  clear_lists(top, low, id);
  for (int q = lane; q < g.Q; q += 32) {  // a chunk's lists are sorted already
    const float* in = g.part + (row * g.Q + q) * kPart;
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      if (q == lane) {
        top[j] = in[j];
        low[j] = in[kTop + j];
        id[j] = __float_as_int(in[2 * kTop + j]);
      } else {
        push_top(top, in[j]);
        push_low(low, id, in[kTop + j], __float_as_int(in[2 * kTop + j]));
      }
    }
  }
  warp_rounds(top, low, id, tops, lows, ids);
  if (g.nboth[row] >= kTop && !(lows[kTop - 1] < kBothBound)) {
    // the costs of the pairs inside both gates did not settle the row (NaN
    // or huge costs): the full scan of the first version, over all A anchors
    clear_lists(top, low, id);
    for (int a = lane; a < g.A; a += 32) {
      const int64_t i = (int64_t)b * g.A + a;
      float cost;
      const float iou = pair(L, true, make_anchor(g, b, a), cand[a] != 0.0f,
                             logit_at(g, b, a, L.cls), g.sig_obj[i], g.s_all[i], &cost);
      push_top(top, iou);
      push_low(low, id, cost, a);
    }
    warp_rounds(top, low, id, tops, lows, ids);
  }
  float iou_sum = 0.0f;
#pragma unroll
  for (int r = 0; r < kTop; ++r) iou_sum = iou_sum + tops[r];
  // clamp(trunc(sum), 1, 10); a NaN or -inf sum gives 1
  const int k = iou_sum >= 1.0f ? (int)fminf(iou_sum, 10.0f) : 1;
  float kth = lows[0];
#pragma unroll
  for (int r = 1; r < kTop; ++r)
    if (r == k - 1) kth = lows[r];

  // The claims: the candidates with cost <= kth (NaN claims nothing). While
  // fewer than 10 listed costs are <= kth, every such anchor is listed;
  // else (ties at kth) the warp tests every candidate.
  int n_le = 0;
#pragma unroll
  for (int r = 0; r < kTop; ++r) n_le += lows[r] <= kth ? 1 : 0;
  int* claims = g.claims + (int64_t)b * g.A;
  int* first = g.first + (int64_t)b * g.A;
  if (n_le < kTop) {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kTop; ++r) {
        if (lows[r] <= kth && cand[ids[r]] != 0.0f) {
          atomicAdd(claims + ids[r], 1);
          atomicMin(first + ids[r], m);
        }
      }
    }
  } else {
    for (int a = lane; a < g.A; a += 32) {
      if (cand[a] == 0.0f) continue;
      const int64_t i = (int64_t)b * g.A + a;
      float cost;
      pair(L, true, make_anchor(g, b, a), true, logit_at(g, b, a, L.cls),
           g.sig_obj[i], g.s_all[i], &cost);
      if (cost <= kth) {
        atomicAdd(claims + a, 1);
        atomicMin(first + a, m);
      }
    }
  }
}

// (c) a thread per anchor: the three outputs. One claim: its label (the
// pair recomputed for its IoU). Several: the argmin cost over the labels,
// as the dense path resolves the conflict.
__global__ void __launch_bounds__(kThreads) assign_pass(Args g) {
  __shared__ Label lab[kLabChunk];
  __shared__ int lvalid[kLabChunk];
  const int b = blockIdx.y, a = blockIdx.x * kThreads + threadIdx.x;
  const bool live = a < g.A;
  const int64_t i = (int64_t)b * g.A + a;
  const int claims = live ? g.claims[i] : 0;
  const bool multi = claims > 1;
  Anchor an;
  float sig_obj = 0.0f, s_all = 0.0f;
  if (claims > 0) {
    an = make_anchor(g, b, a);
    s_all = g.s_all[i];
    sig_obj = g.sig_obj[i];
  }

  // the argmin of an anchor claimed more than once: a running strict-<
  // minimum over the valid labels in order (the first minimum wins). Its
  // claims cost <= kth_cost, so first over the labels whose both gates hold
  // (the others cost >= CENTER_PENALTY - 0.01); only if that minimum is not
  // below kBothBound, over every valid label.
  int arg = -1;
  float best = CUDART_INF_F, best_iou = 0.0f;
  bool arg_valid = true;
  if (__syncthreads_or(multi)) {
    bool full = false;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        full = multi && !(best < kBothBound);
        if (!__syncthreads_or(full)) break;
        if (full) { arg = -1; best = CUDART_INF_F; best_iou = 0.0f; }
      }
      for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
        const int n = min(kLabChunk, g.M - m0);
        __syncthreads();
        stage_labels(g, b, m0, n, lab, lvalid);
        __syncthreads();
        if (!(pass == 0 ? multi : full)) continue;
        for (int j0 = 0; j0 < n; j0 += kUnroll) {
          Geo geo[kUnroll];
          float lgt[kUnroll];  // the gathered logits first, then the costs
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u;
            const bool use = j < n && lvalid[j];
            if (use) geo[u] = pair_geo(lab[j], true, an, true);
            lgt[u] = use && (pass == 1 || geo[u].both)
                         ? logit_at(g, b, a, lab[j].cls) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u;
            if (j >= n || !lvalid[j] || (pass == 0 && !geo[u].both)) continue;
            const float cost = pair_cost(geo[u], lgt[u], sig_obj, s_all);
            const float key = cost != cost ? CUDART_INF_F : cost;
            if (arg < 0 || key < best) { best = key; arg = m0 + j; best_iou = geo[u].iou; }
          }
        }
      }
    }
    // The argmin runs over all M rows; an invalid row can only tie or beat a
    // best valid cost that is not below INVALID_PENALTY.
    const bool recheck = multi && !(best < kInvalidPenalty);
    if (__syncthreads_or(recheck)) {
      for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
        const int n = min(kLabChunk, g.M - m0);
        __syncthreads();
        stage_labels(g, b, m0, n, lab, lvalid);
        __syncthreads();
        if (!recheck) continue;
        for (int j = 0; j < n; ++j) {
          if (lvalid[j]) continue;
          float cost;
          pair(lab[j], false, an, true, logit_at(g, b, a, lab[j].cls), sig_obj,
               s_all, &cost);
          const float key = cost != cost ? CUDART_INF_F : cost;
          const int mm = m0 + j;
          if (key < best || (key == best && mm < arg)) {
            best = key; arg = mm; arg_valid = false;
          }
        }
      }
    }
  }

  if (!live) return;
  bool fg = false;
  int64_t matched = 0;
  float piou = 0.0f;
  if (multi) {
    fg = arg_valid;  // forced to the argmin label, if it is a valid one
    if (fg) { matched = arg; piou = best_iou; }
  } else if (claims == 1) {
    const int m = g.first[i];
    const Label L = make_label(g, b, m);
    float cost;
    fg = true;
    matched = m;
    piou = pair(L, true, an, true, logit_at(g, b, a, L.cls), sig_obj, s_all, &cost);
  }
  g.fg[i] = fg ? 1 : 0;
  g.matched[i] = matched;
  g.piou[i] = piou;
}

}  // namespace

extern "C" {

// Floats of workspace that simota_assign needs for these sizes.
long long simota_workspace_floats(int B, int M, int A) {
  const long long ba = (long long)B * A, bm = (long long)B * M;
  const long long q = (A + kChunk - 1) / kChunk;
  return 5 * ba + bm + bm * q * kPart;
}

// Pointers on the current device; strides in elements. `workspace` holds
// simota_workspace_floats(B, M, A) floats. Launches the passes on `stream`
// and returns the cudaError_t of the launches (0 on success). Needs M >= 1,
// C >= 1, 10 <= A <= 65535 * 512, B <= 65535 and B*M < 2^31.
int simota_assign(const float* gt, long long gt_sb, long long gt_sm,
                  const int64_t* gcls, const uint8_t* gvalid,
                  const float* pred, long long pred_sb, long long pred_sa,
                  const float* obj, long long obj_sb, long long obj_sa,
                  const float* cls, long long cls_sb, long long cls_sa,
                  const float* xs, const float* ys, const float* st,
                  int B, int M, int A, int C, float radius, float* workspace,
                  uint8_t* fg, int64_t* matched, float* piou, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  if (M < 1 || C < 1 || A < kTop || B > 65535 || (int64_t)B * M > 0x7fffffff ||
      (A + kChunk - 1) / kChunk > 65535)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.gt = gt; g.gt_sb = gt_sb; g.gt_sm = gt_sm;
  g.gcls = gcls; g.gvalid = gvalid;
  g.pred = pred; g.pred_sb = pred_sb; g.pred_sa = pred_sa;
  g.obj = obj; g.obj_sb = obj_sb; g.obj_sa = obj_sa;
  g.cls = cls; g.cls_sb = cls_sb; g.cls_sa = cls_sa;
  g.xs = xs; g.ys = ys; g.st = st;
  g.B = B; g.M = M; g.A = A; g.C = C; g.radius = radius;
  g.Q = (A + kChunk - 1) / kChunk;
  const int64_t ba = (int64_t)B * A, bm = (int64_t)B * M;
  g.s_all = workspace;
  g.sig_obj = workspace + ba;
  g.cand = workspace + 2 * ba;
  g.claims = reinterpret_cast<int*>(workspace + 3 * ba);
  g.first = reinterpret_cast<int*>(workspace + 4 * ba);
  g.nboth = reinterpret_cast<int*>(workspace + 5 * ba);
  g.part = workspace + 5 * ba + bm;
  g.fg = fg; g.matched = matched; g.piou = piou;

  cudaError_t err = cudaMemsetAsync(g.nboth, 0, sizeof(int) * bm, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 anchors((A + kThreads - 1) / kThreads, B);
  anchor_pass<<<anchors, kThreads, 0, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  label_pass<<<dim3((M + kWarps - 1) / kWarps, g.Q, B), kThreads, 0, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  label_merge_pass<<<(unsigned)((bm + kWarps - 1) / kWarps), kThreads, 0, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assign_pass<<<anchors, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
