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
// Design. The TPU kernel keeps one image's [M', A'] working set in ~100 MB
// of VMEM. Here nothing [M, A]-shaped exists anywhere (at B=16, M=100 it
// would be 53.8 MB a tensor): every pair's IoU and cost is recomputed in
// registers where it is needed, and the cross-block reductions are three
// passes, launched in order on one stream:
//  (a) anchor_pass, one thread per anchor: sigmoid(obj), S over the C
//      classes (the cls logits staged through shared memory in 32-class
//      chunks, so that a warp reads whole rows), and fg_cand, the OR over the
//      image's valid labels of the two gates (labels staged in shared memory).
//      Writes S, sigmoid(obj) and fg_cand [B,A] to a workspace.
//  (b) label_pass, one block per (image, label) row; a row of an invalid
//      label ends at once (most label slots are empty). The block streams the
//      A anchors; each thread keeps its 10 largest IoUs and 10 smallest costs
//      in sorted registers, duplicates kept. Ten rounds of a block arg-max
//      over the threads' list heads then give the row's top-10 IoUs in
//      descending order and its 10 smallest costs in ascending order: hence
//      dynamic_k = clamp(trunc(sum), 1, 10) and kth_cost [B,M].
//  (c) assign_pass, one thread per anchor; an anchor outside every gate ends
//      at once. A loop over the valid labels recomputes each cost (the same
//      __device__ function as (b), so the k-th anchor of a row always meets
//      cost <= kth_cost), counts the claims, keeps the first claimer and a
//      running strict-< argmin (the first minimum wins). The argmin of the
//      dense path runs over all M rows; an invalid row's cost is >= 1e9 (a
//      sum of non-negative terms and INVALID_PENALTY), so the invalid rows are
//      visited only for a multiply-claimed anchor whose best valid cost is
//      not below 1e9 (a NaN, or logits so large that p rounds to 1).
//
// Bound (B=16, A=8400, C=80, M=100). Bytes: the cls logits are read once,
// 43.0 MB of the 47.6 MB that the function must move, 14.2 us at 3.35 TB/s.
// Operations, a transcendental counted as one: 11 a class term (B*A*C =
// 10.75 M) and 55 a pair of a valid label and an anchor (B*A a valid label
// slot), some 270 MFLOP with 325 valid labels, 4 us at 67 TFLOP/s. So the
// function is bound by bytes. This first version likely is not: pass (a)
// spends tens of instructions a class term (the IEEE-exact expf, division,
// sqrtf and log1pf), and pass (b) re-reads every anchor's strided
// prediction and gathers one logit a pair for each valid row, from the
// 43 MB that stay in the 50 MB L2. Pass (a) reads the logits coalesced. A
// simple kernel: no TMA, no tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTop = 10;         // SimOTA's top-k: dynamic_k <= 10
constexpr int kLabChunk = 128;   // labels staged in shared memory at a time
constexpr int kClsChunk = 32;    // classes staged in shared memory at a time
constexpr float kCenterPenalty = 100000.0f;
constexpr float kInvalidPenalty = 1e9f;
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
  float* kth;                                   // workspace [B,M]
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

// The pair (label L, anchor an): returns the IoU masked by `cand` (valid
// label and fg_cand anchor) and sets the cost. Passes (b) and (c) both call
// this one function, so they agree on every cost bit for bit.
__device__ __forceinline__ float pair(const Label& L, bool valid, const Anchor& an,
                                      bool fg_cand, float logit, float sig_obj,
                                      float s_all, float* cost) {
  bool in_box, in_center;
  gates(L, an, in_box, in_center);
  const bool both = valid && in_box && in_center;
  const bool cand = valid && fg_cand;
  float iou = 0.0f;
  if (cand) {
    const float iw = clamp_lo(t_min(L.x2, an.x2) - t_max(L.x1, an.x1), 0.0f);
    const float ih = clamp_lo(t_min(L.y2, an.y2) - t_max(L.y1, an.y1), 0.0f);
    const float inter = iw * ih;
    iou = inter / clamp_lo((L.area + an.area) - inter, kUnionMin);
  }
  const float p = class_p(logit, sig_obj);
  const float cls_cost = (s_all - logf(p)) + log1pf(-p);
  float c = cls_cost + 3.0f * (-logf(iou + kIouEps));
  if (!both) c = c + kCenterPenalty;
  if (!cand) c = c + kInvalidPenalty;
  *cost = c;
  return iou;
}

__device__ __forceinline__ float logit_at(const Args& g, int b, int a, int c) {
  return g.cls[b * g.cls_sb + a * g.cls_sa + c];
}

// Stage labels [m0, m0+n) of image b in shared memory (n <= kLabChunk).
__device__ __forceinline__ void stage_labels(const Args& g, int b, int m0, int n,
                                             Label* lab, int* valid, float* kth) {
  const int t = threadIdx.x;
  if (t < n) {
    const int64_t row = (int64_t)b * g.M + m0 + t;
    lab[t] = make_label(g, b, m0 + t);
    valid[t] = g.gvalid[row] != 0;
    if (kth != nullptr) kth[t] = valid[t] ? g.kth[row] : 0.0f;
  }
}

// (a) one thread per anchor: sigmoid(obj), S and fg_cand.
__global__ void __launch_bounds__(kThreads) anchor_pass(Args g) {
  __shared__ float tile[kThreads][kClsChunk + 1];  // +1: no bank conflicts
  __shared__ Label lab[kLabChunk];
  __shared__ int lvalid[kLabChunk];
  const int b = blockIdx.y, a0 = blockIdx.x * kThreads, a = a0 + threadIdx.x;
  const bool live = a < g.A;
  const float sig_obj = live ? sigmoid(g.obj[b * g.obj_sb + a * g.obj_sa]) : 0.0f;

  float acc = 0.0f;  // sum_c log(1 - p_c), c in order
  const float* cls_b = g.cls + b * g.cls_sb;
  for (int c0 = 0; c0 < g.C; c0 += kClsChunk) {
    const int cw = min(kClsChunk, g.C - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kThreads * cw; i += kThreads) {
      const int r = i / cw, c = i - r * cw;
      tile[r][c] = a0 + r < g.A ? cls_b[(int64_t)(a0 + r) * g.cls_sa + c0 + c] : 0.0f;
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < cw; ++c)
        acc = acc + log1pf(-class_p(tile[threadIdx.x][c], sig_obj));
    }
  }

  Anchor an;
  if (live) an = make_anchor(g, b, a);
  bool fg_cand = false;
  for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
    const int n = min(kLabChunk, g.M - m0);
    __syncthreads();
    stage_labels(g, b, m0, n, lab, lvalid, nullptr);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        if (!lvalid[j]) continue;
        bool in_box, in_center;
        gates(lab[j], an, in_box, in_center);
        fg_cand = fg_cand || in_box || in_center;
      }
    }
  }
  if (live) {
    const int64_t i = (int64_t)b * g.A + a;
    g.s_all[i] = -acc;
    g.sig_obj[i] = sig_obj;
    g.cand[i] = fg_cand ? 1.0f : 0.0f;
  }
}

// (b) one block per (image, label) row: dynamic_k and the k-th smallest cost.
__global__ void __launch_bounds__(kThreads) label_pass(Args g) {
  __shared__ float red_v[2][2][kWarps];  // [round parity][iou, cost][warp]
  __shared__ int red_i[2][2][kWarps];
  const int64_t row = blockIdx.x;
  if (!g.gvalid[row]) return;  // the whole block: an empty label slot
  const int b = (int)(row / g.M), m = (int)(row - (int64_t)b * g.M);
  const Label L = make_label(g, b, m);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float top[kTop], low[kTop];  // this thread's largest IoUs / smallest costs
#pragma unroll
  for (int i = 0; i < kTop; ++i) {
    top[i] = -CUDART_INF_F;
    low[i] = CUDART_INF_F;
  }
  for (int a = tid; a < g.A; a += kThreads) {
    const int64_t i = (int64_t)b * g.A + a;
    float cost;
    const float iou = pair(L, true, make_anchor(g, b, a), g.cand[i] != 0.0f,
                           logit_at(g, b, a, L.cls), g.sig_obj[i], g.s_all[i], &cost);
    if (iou > top[kTop - 1]) {  // NaN never enters
      top[kTop - 1] = iou;
#pragma unroll
      for (int j = kTop - 1; j > 0; --j) {
        if (top[j] > top[j - 1]) {
          const float t = top[j]; top[j] = top[j - 1]; top[j - 1] = t;
        }
      }
    }
    if (cost < low[kTop - 1]) {
      low[kTop - 1] = cost;
#pragma unroll
      for (int j = kTop - 1; j > 0; --j) {
        if (low[j] < low[j - 1]) {
          const float t = low[j]; low[j] = low[j - 1]; low[j - 1] = t;
        }
      }
    }
  }

  // Ten rounds: the block's largest remaining IoU and smallest remaining
  // cost are the best of the threads' list heads; the winning thread (the
  // lowest tid on ties) drops its head. Double-buffered: one sync a round.
  const unsigned full = 0xffffffffu;
  float iou_sum = 0.0f, lows[kTop];
#pragma unroll
  for (int r = 0; r < kTop; ++r) {
    float hv = top[0], lv = low[0];
    int hi = tid, li = tid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(full, hv, off);
      const int oi = __shfl_xor_sync(full, hi, off);
      if (ov > hv || (ov == hv && oi < hi)) { hv = ov; hi = oi; }
      const float pv = __shfl_xor_sync(full, lv, off);
      const int pi = __shfl_xor_sync(full, li, off);
      if (pv < lv || (pv == lv && pi < li)) { lv = pv; li = pi; }
    }
    const int buf = r & 1;
    if (lane == 0) {
      red_v[buf][0][warp] = hv; red_i[buf][0][warp] = hi;
      red_v[buf][1][warp] = lv; red_i[buf][1][warp] = li;
    }
    __syncthreads();
    hv = red_v[buf][0][0]; hi = red_i[buf][0][0];
    lv = red_v[buf][1][0]; li = red_i[buf][1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float ov = red_v[buf][0][w], pv = red_v[buf][1][w];
      const int oi = red_i[buf][0][w], pi = red_i[buf][1][w];
      if (ov > hv || (ov == hv && oi < hi)) { hv = ov; hi = oi; }
      if (pv < lv || (pv == lv && pi < li)) { lv = pv; li = pi; }
    }
    iou_sum = iou_sum + hv;
    lows[r] = lv;
    if (tid == hi) {
#pragma unroll
      for (int j = 0; j < kTop - 1; ++j) top[j] = top[j + 1];
      top[kTop - 1] = -CUDART_INF_F;
    }
    if (tid == li) {
#pragma unroll
      for (int j = 0; j < kTop - 1; ++j) low[j] = low[j + 1];
      low[kTop - 1] = CUDART_INF_F;
    }
  }
  if (tid == 0) {
    // clamp(trunc(sum), 1, 10); a NaN or -inf sum gives 1
    const int k = iou_sum >= 1.0f ? (int)fminf(iou_sum, 10.0f) : 1;
    float kth = lows[0];
#pragma unroll
    for (int r = 1; r < kTop; ++r)
      if (r == k - 1) kth = lows[r];
    g.kth[row] = kth;
  }
}

// (c) one thread per anchor: claims, conflicts and the three outputs.
__global__ void __launch_bounds__(kThreads) assign_pass(Args g) {
  __shared__ Label lab[kLabChunk];
  __shared__ int lvalid[kLabChunk];
  __shared__ float lkth[kLabChunk];
  const int b = blockIdx.y, a = blockIdx.x * kThreads + threadIdx.x;
  const int64_t i = (int64_t)b * g.A + a;
  const bool fg_cand = a < g.A && g.cand[i] != 0.0f;
  Anchor an;
  float sig_obj = 0.0f, s_all = 0.0f;
  if (fg_cand) {
    an = make_anchor(g, b, a);
    sig_obj = g.sig_obj[i];
    s_all = g.s_all[i];
  }

  int claims = 0, first = 0, arg = -1;
  float first_iou = 0.0f, best = CUDART_INF_F, best_iou = 0.0f;
  for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
    const int n = min(kLabChunk, g.M - m0);
    __syncthreads();
    stage_labels(g, b, m0, n, lab, lvalid, lkth);
    __syncthreads();
    if (!fg_cand) continue;
    for (int j = 0; j < n; ++j) {
      if (!lvalid[j]) continue;
      float cost;
      const float iou = pair(lab[j], true, an, true, logit_at(g, b, a, lab[j].cls),
                             sig_obj, s_all, &cost);
      if (cost <= lkth[j]) {  // NaN claims nothing
        if (claims == 0) { first = m0 + j; first_iou = iou; }
        ++claims;
      }
      const float key = cost != cost ? CUDART_INF_F : cost;
      if (arg < 0 || key < best) { best = key; arg = m0 + j; best_iou = iou; }
    }
  }

  // The argmin runs over all M rows; an invalid row can only tie or beat a
  // best valid cost that is not below INVALID_PENALTY.
  const bool recheck = fg_cand && claims > 1 && !(best < kInvalidPenalty);
  bool arg_valid = true;
  if (__syncthreads_or(recheck)) {
    for (int m0 = 0; m0 < g.M; m0 += kLabChunk) {
      const int n = min(kLabChunk, g.M - m0);
      __syncthreads();
      stage_labels(g, b, m0, n, lab, lvalid, nullptr);
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

  if (a >= g.A) return;
  bool fg = false;
  int64_t matched = 0;
  float piou = 0.0f;
  if (claims > 1) {
    fg = arg_valid;  // forced to the argmin label, if it is a valid one
    if (fg) { matched = arg; piou = best_iou; }
  } else if (claims == 1) {
    fg = true;
    matched = first;
    piou = first_iou;
  }
  g.fg[i] = fg ? 1 : 0;
  g.matched[i] = matched;
  g.piou[i] = piou;
}

}  // namespace

extern "C" {

// Pointers on the current device; strides in elements. `workspace` holds
// 3*B*A + B*M floats. Launches the three passes on `stream` and returns the
// cudaError_t of the launches (0 on success). Needs M >= 1, C >= 1,
// A >= 10, B <= 65535 and B*M < 2^31.
int simota_assign(const float* gt, long long gt_sb, long long gt_sm,
                  const int64_t* gcls, const uint8_t* gvalid,
                  const float* pred, long long pred_sb, long long pred_sa,
                  const float* obj, long long obj_sb, long long obj_sa,
                  const float* cls, long long cls_sb, long long cls_sa,
                  const float* xs, const float* ys, const float* st,
                  int B, int M, int A, int C, float radius, float* workspace,
                  uint8_t* fg, int64_t* matched, float* piou, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  if (M < 1 || C < 1 || A < kTop || B > 65535 || (int64_t)B * M > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.gt = gt; g.gt_sb = gt_sb; g.gt_sm = gt_sm;
  g.gcls = gcls; g.gvalid = gvalid;
  g.pred = pred; g.pred_sb = pred_sb; g.pred_sa = pred_sa;
  g.obj = obj; g.obj_sb = obj_sb; g.obj_sa = obj_sa;
  g.cls = cls; g.cls_sb = cls_sb; g.cls_sa = cls_sa;
  g.xs = xs; g.ys = ys; g.st = st;
  g.B = B; g.M = M; g.A = A; g.C = C; g.radius = radius;
  const int64_t ba = (int64_t)B * A;
  g.s_all = workspace;
  g.sig_obj = workspace + ba;
  g.cand = workspace + 2 * ba;
  g.kth = workspace + 3 * ba;
  g.fg = fg; g.matched = matched; g.piou = piou;

  const dim3 anchors((A + kThreads - 1) / kThreads, B);
  anchor_pass<<<anchors, kThreads, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  label_pass<<<(unsigned)((int64_t)B * M), kThreads, 0, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assign_pass<<<anchors, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
