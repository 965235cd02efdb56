// Greedy NMS suppression for Hopper (sm_90a): keep mask of score-sorted boxes.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/nms_pallas.py::_nms_kernel
// (entry pallas_suppress). Same function: boxes [B,K,4] fp32 xyxy, sorted by
// descending score, class offsets already added by the caller; valid [B,K]
// bool -> alive [B,K] bool, equal bit for bit to the greedy result of
// pl_yolo_tpu_torch/ops/nms.py::greedy_suppress.
//
// Design. The TPU kernel holds a [K,K] fp32 overlap matrix (4 MB at K=1024)
// in VMEM and iterates a matvec to a fixpoint. Here the overlaps are one bit
// a pair: word (row i, column block w) has bit c set iff IoU(i, j) >
// threshold for column j = 64*w + c. Row i is kept iff no kept row before
// it names it, so the rows are decided in score order, one 64-row block at
// a time, from a "removed" word for each block (invalid rows start out
// removed).
//
// nms_cluster_kernel, for K <= kClusterMaxK: one launch a call, one thread
// block cluster of 8 CTAs an image (grid (8, B), 256 threads a CTA). CTA c
// owns column blocks w = 8*l + c for even slots l and w = 8*l + 7 - c for
// odd ones: a snake over the rounds of 8, because column block w has w + 1
// tiles above the diagonal and the snake gives the 8 CTAs equal shares of
// that triangle (17 tiles each at K=1024), where w = c (mod 8) alone gives
// CTA 7 2.4 times CTA 0's share. The mask words never leave shared memory.
//   1. IoU pass, warps 1-7. A CTA computes, into its own shared memory, the
//      words of every valid row above and on each owned block's diagonal:
//      the tiles (row block rb, slot l), rb <= w, laid out [slot][row] so
//      that neighbouring lanes store neighbouring words, in the order of rb,
//      dealt out to the warps in turn, a lane taking two rows side by side
//      and loading its rows of the warp's next tile while it computes this
//      one. A flag in shared memory marks each finished tile (st.release /
//      ld.acquire at CTA scope). The pairs of a tile that can meet are found
//      without testing all 4,096: each slot's columns are sorted once by
//      x1, and a column can overlap a row only if its x1 lies in [row x1 -
//      the widest column, row x2), a run found by a binary search (two
//      loads deep) in the sorted x1; with the class offsets, a run holds the
//      few columns of the row's class nearby. Only the pairs of a run whose
//      boxes overlap on both axes take the exact formula below, and a pair
//      whose intersection is well below threshold * union skips its
//      division.
//   2. Sweep, warp 0, beside the IoU pass. It keeps the removed word of
//      each owned block in a register. For each block rb before its last
//      owned block it waits for rb's kept word, which rb's owner stores into
//      this CTA's shared memory over distributed shared memory (mapa +
//      st.relaxed.cluster.shared::cluster, two tagged 8-byte halves, each
//      one store, so no fence orders it behind another; the receiver polls
//      its own inbox with volatile shared loads), and ORs the kept rows'
//      words of its later blocks into their removed words (two shared loads
//      a lane and two __reduce_or_sync). The owner of block rb + 1 does so
//      for that block first, with its tiles' words loaded before the kept
//      word comes, then decides the block's 64 rows (`decide`: the rows
//      that no earlier row of the block overlaps at once, the others in
//      parallel rounds), stores its kept word into the CTAs that own later
//      blocks, and goes on. Only the owner of the next block is on the
//      critical path, and alive is written once the sweep is through.
//   One cluster barrier before the sweep and one before exit, none inside
//   it. The first orders the clearing of every inbox before any store into
//   it: warps 1-7 arrive without a fence once a CTA barrier follows the
//   clearing, warp 0 arrives with release (a fence GPU-wide, about 0.7 us,
//   that only it waits for, while the first tiles are computed) and waits
//   before its first store into another CTA. At the second, every store
//   into a CTA has been awaited by that CTA in its sweep, so no CTA's shared
//   memory goes away while another may still store into it.
// nms_mask_kernel + nms_sweep_kernel, for kClusterMaxK < K <= kMaxK: the
// two-launch kernels of the first version, unchanged. The mask words go
// through a [B, K, ceil(K/64)] uint64 scratch in device memory (128 KB an
// image at K=1024) and one warp an image sweeps it. The choice depends on
// K alone; the wrapper (ops/cuda/nms_suppress.py, CLUSTER_MAX_K) allocates
// the scratch only on that path, and `mask` may be null below it.
//
// What the cluster design does about the first version's three costs
// (78.95 us at [16,1024], of it the sweep 56.31 us and the mask pass 17.18):
//   - the sweep ran on 16 of the 132 SMs, one warp each, and waited two L2
//     round trips a block: here each step waits one DSMEM hand-off and
//     reads shared memory only, and it runs beside the IoU pass;
//   - the mask made a round trip through device memory with uncoalesced
//     8-byte stores, and 1,920 of 4,096 blocks exited at once: here it
//     never leaves shared memory, neighbouring lanes store neighbouring
//     words, 128 CTAs share the triangle evenly, and the pairs that cannot
//     meet are never tested;
//   - two launches and two host allocations a call: here one launch, and
//     the wrapper allocates only alive.
//
// Capacity. A CTA holds K * ceil(ceil(K/64)/8) words, its slots' columns
// (boxes, test boxes, areas, sorted x1 and their order), a word and a flag
// for each block and tile: 221,632 bytes at kClusterMaxK = 3584 (56 blocks,
// 7 slots), within the 232,448 a block may use; a K above it needs 8 slots,
// 253,264 bytes at K = 3585, so 3584 is the largest K that fits. At
// K=1024: 22,112 bytes.
//
// Hopper traps, each handled here:
//   - dynamic shared memory above 48 KB needs cudaFuncSetAttribute(...,
//     cudaFuncAttributeMaxDynamicSharedMemorySize, ...): set once a device
//     for the capacity's size (prepare_cluster_kernel);
//   - a cluster launch needs cudaLaunchKernelEx with
//     cudaLaunchAttributeClusterDimension; cudaOccupancyMaxActiveClusters
//     is asked once a device, at the capacity's shared memory, and the
//     entry returns an error if not one cluster of 8 fits
//     (nms_cluster_fit(K) reports the count for any K). On an H100 SXM 15
//     clusters of 8 fit at one CTA an SM (the GPCs' sizes), so the kernel
//     asks for at most 128 registers a thread (__launch_bounds__(256, 2)):
//     the 16th image of a batch shares SMs rather than waiting a wave;
//   - a ragged last block (K % 64 != 0) is masked, and when ceil(K/64) is
//     not a multiple of 8 some CTAs own fewer blocks or none: such a CTA
//     takes no tile and still takes both cluster barriers, as every thread
//     does;
//   - B up to 65,535 images is grid.y, and clusters beyond those resident
//     queue in waves.
//
// Bound. The IoU of all pairs costs 14 fp32 operations per pair (4 min/max
// for the intersection, 2 subtractions, 2 clamps, 1 product, 1 add and 1
// subtraction for the union, 1 clamp, 1 division, 1 compare) over K(K-1)/2
// pairs per image: 117 MFLOP at B=16, K=1024, about 1.75 us at the H100's
// 67 TFLOP/s of non-tensor fp32. Its bytes (17 KB in, 1 KB out per image)
// are negligible, so it is bound by operations. Two floors lie outside
// that bound. (1) The 67 TFLOP/s count a fused multiply-add as two
// operations; none of the 14 is one (and the build forbids contraction),
// so the pass at that rate needs twice that, about 3.5 us (this kernel
// skips most pairs, so its pass is held by latency instead). (2) The sweep
// is a chain of K/64 dependent steps (16 at K=1024), each a DSMEM hand-off
// (a store into another SM's shared memory, seen by its polling warp about
// 350 cycles later), an OR across a warp and a decision of 64 rows; no
// block can be decided before the one ahead of it.
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
// The filters only skip pairs whose IoU the formula makes 0 or leaves below
// the threshold: the overlap test runs on test boxes (a NaN x1 or y1 as
// -inf, a NaN x2 or y2 as +inf, as fmaxf and fminf take a NaN beside a
// number), whose overlap is implied by inter > 0. IoU is symmetric in
// this formula, so a row's word in a diagonal tile also names the earlier
// rows that overlap it. The words of invalid rows are never read (an
// invalid row is never kept), so they are left 0 without being computed.
//
// Built with -DNMS_CUT_AFTER_IOU, the cluster kernel's sweep warp stops
// after the first cluster barrier, and the kernel after its IoU pass:
// chip_nms_ab.py times that copy against the whole kernel to split the
// device time into the IoU pass and the rest.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kBlockRows = 64;      // rows (and columns) per mask block
constexpr int kMaxK = 16384;        // mask scratch: K * K / 8 bytes per image
constexpr int kClusterCtas = 8;     // CTAs a cluster: one cluster an image
constexpr int kClusterThreads = 256;  // warp 0 sweeps, warps 1-7 take the IoU tiles
constexpr int kIouWarps = kClusterThreads / 32 - 1;
constexpr int kClusterMaxK = 3584;  // ops/cuda/nms_suppress.py CLUSTER_MAX_K
constexpr int kMaxSlots = (kClusterMaxK / kBlockRows + kClusterCtas - 1) / kClusterCtas;  // 7
constexpr int kMaxRounds = 8;       // parallel rounds of a block before the serial chain
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float clamp_min(float x, float lo) {  // NaN stays
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(clamp_min(__fsub_rn(x2, x1), 0.0f), clamp_min(__fsub_rn(y2, y1), 0.0f));
}

// ---------------------------------------------------------------------------
// The cluster kernel (K <= kClusterMaxK).

// Column block of CTA `cta`'s slot `l`: a snake over rounds of 8 blocks.
__host__ __device__ __forceinline__ int owned_block(int cta, int l) {
  return l * kClusterCtas + ((l & 1) ? kClusterCtas - 1 - cta : cta);
}

__host__ __device__ __forceinline__ int slots_of(int nwords) {
  return (nwords + kClusterCtas - 1) / kClusterCtas;
}

// [slots*64] float4 column boxes, [slots*64] float4 the same as test boxes,
// [slots*64] float areas, [slots*64] float test x1 in ascending order,
// [8] float each slot's widest test box, [8] the kept word of each owned
// block, [slots*64] uint8 the column of each sorted x1, [slots][K] words,
// [nwords] kept words as two tagged halves, [slots][nwords] tile flags
__host__ __device__ __forceinline__ size_t cluster_smem_bytes(int K) {
  const int nwords = (K + kBlockRows - 1) / kBlockRows, slots = slots_of(nwords);
  return (size_t)slots * kBlockRows * (2 * sizeof(float4) + 2 * sizeof(float) + 1)
         + 8 * (sizeof(float) + sizeof(u64)) + (size_t)slots * K * sizeof(u64)
         + (size_t)nwords * 2 * sizeof(u64) + (size_t)slots * nwords * sizeof(unsigned);
}

// A block's kept word travels as two tagged halves, each one 8-byte store
// (single-copy atomic) into the receiver's shared memory: bit 32 says the
// half is there, so no fence has to order it behind another store.
constexpr u64 kPresent = 1ull << 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `addr` (this CTA's shared memory) in the shared memory of cluster CTA `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned addr, u64 v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;" :: "r"(addr), "l"(v)
               : "memory");
}

// A poll of this CTA's own inbox: a volatile load (relaxed at system scope,
// so it sees the other CTAs' stores) that stays a plain shared load.
__device__ __forceinline__ u64 ld_volatile(unsigned addr) {
  u64 v;
  asm volatile("ld.volatile.shared::cta.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ u64 wait_kept(unsigned addr) {
  u64 lo, hi;
  do {
    lo = ld_volatile(addr);
    hi = ld_volatile(addr + 8);
  } while (((lo & hi) & kPresent) == 0ull);
  return (hi << 32) | (lo & 0xffffffffull);
}

// A tile's flag: set by the IoU warp that wrote the tile, once its words
// are in shared memory; awaited by the sweep warp.
__device__ __forceinline__ void set_flag(unsigned* flag) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], 1;" :: "r"(smem_addr(flag)) : "memory");
}

__device__ __forceinline__ void wait_flag(const unsigned* flag) {
  unsigned v;
  do {
    asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(flag))
                 : "memory");
  } while (v == 0u);
}

// The cluster barrier in its two halves. `release` orders this thread's
// earlier stores before every thread's return from the wait.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The last column block that CTA `cta` owns, or -1.
__device__ __forceinline__ int last_owned(int cta, int nwords) {
  int last = -1;
  for (int l = 0; owned_block(cta, l) < nwords; ++l) last = owned_block(cta, l);
  return last;
}

// The box as the overlap test takes it: a NaN x1 or y1 as -inf and a NaN x2
// or y2 as +inf (what fmaxf and fminf make of a NaN beside a number), and a
// box of no positive width or height as one that meets nothing.
__device__ __forceinline__ float4 test_box(float4 p) {
  const float inf = __int_as_float(0x7f800000);
  float x1 = p.x, y1 = p.y, x2 = p.z, y2 = p.w;
  x1 = x1 != x1 ? -inf : x1;
  y1 = y1 != y1 ? -inf : y1;
  x2 = x2 != x2 ? inf : x2;
  y2 = y2 != y2 ? inf : y2;
  if (!(x2 > x1 && y2 > y1)) x1 = y1 = inf;
  return make_float4(x1, y1, x2, y2);
}

struct TileRows {  // a lane's two rows of a tile
  float4 a, b;
  bool va, vb;
};

__device__ __forceinline__ float4 load_box(const float* bx, int i) {
  return make_float4(bx[i * 4], bx[i * 4 + 1], bx[i * 4 + 2], bx[i * 4 + 3]);
}

// A test box's width, rounded up; -inf for a box that meets nothing.
__device__ __forceinline__ float test_width(float4 t) {
  return t.x == __int_as_float(0x7f800000) ? -__int_as_float(0x7f800000) : __fsub_ru(t.z, t.x);
}

// How many of the 64 ascending `sx` are < each of the two v: the count of
// whole groups of 8 below v from the groups' last values (loaded once for
// both), then the count inside v's group from its 8 values.
__device__ __forceinline__ void count_below(const float* sx, float va, float vb, int& na,
                                            int& nb) {
  float last[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) last[k] = sx[8 * k + 7];
  const float v[2] = {va, vb};
  int n[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int g = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) g += last[k] < v[q];
    g = min(g, 7);  // all 64 below: group 7 counts its 8
    const float4 lo = reinterpret_cast<const float4*>(sx)[2 * g];
    const float4 hi = reinterpret_cast<const float4*>(sx)[2 * g + 1];
    n[q] = 8 * g + (lo.x < v[q]) + (lo.y < v[q]) + (lo.z < v[q]) + (lo.w < v[q])
           + (hi.x < v[q]) + (hi.y < v[q]) + (hi.z < v[q]) + (hi.w < v[q]);
  }
  na = n[0];
  nb = n[1];
}

__device__ __forceinline__ bool overlap(float4 t, float4 q) {
  return t.z > q.x && q.z > t.x && t.w > q.y && q.w > t.y;
}

// The overlapping columns of a lane's two rows (test boxes ta, tb): those
// whose test boxes overlap the row's on both axes (min(x2) > max(x1), and
// the same in y), a superset of the pairs with inter > 0. Such a column
// has x1 < the row's x2 and x2 > the row's x1, so x1 >= the row's x1 - its
// width >= the row's x1 - the widest: only the run of the sorted x1 in
// [x1 - widest, x2), rounded down, is tested (all of them when a column or
// the row reaches -inf or +inf); the two rows' runs side by side. A row
// that meets nothing (x1 = +inf) has an empty run.
__device__ __forceinline__ void candidates(float4 ta, float4 tb, const float* sx,
                                           const uint8_t* perm, const float4* cs, float widest,
                                           u64& cand_a, u64& cand_b) {
  const float inf = __int_as_float(0x7f800000);
  float la = __fsub_rd(ta.x, widest), lb = __fsub_rd(tb.x, widest);
  la = la != la ? -inf : la;  // -inf - -inf: no column meets anything
  lb = lb != lb ? -inf : lb;
  int ka, kb;
  count_below(sx, la, lb, ka, kb);
  bool ga = ta.x != inf, gb = tb.x != inf;
  cand_a = cand_b = 0ull;
  for (;;) {
    ga = ga && ka < kBlockRows && sx[ka] < ta.z;
    gb = gb && kb < kBlockRows && sx[kb] < tb.z;
    if (!(ga || gb)) break;
    if (ga) {
      const int c = perm[ka++];
      if (overlap(ta, cs[c])) cand_a |= 1ull << c;
    }
    if (gb) {
      const int c = perm[kb++];
      if (overlap(tb, cs[c])) cand_b |= 1ull << c;
    }
  }
}

// IoU(p, q) > threshold by the formula of ops/nms.py::_iou_matrix (see the
// note): 0 / max(union, 1e-12) is 0 (or NaN, which no more than 0 passes
// the threshold), so a pair whose inter is not positive skips the
// division. So does one whose inter is below threshold * union by more
// than the rounding of that product and of the quotient (a relative 1e-5,
// with the threshold in [1e-6, 1] and union at least 1e-12, so that both
// products are normal): its quotient rounds below the threshold.
__device__ __forceinline__ bool over_threshold(float4 p, float area_p, float4 q, float area_q,
                                               float threshold) {
  const float w = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  if (!(inter > 0.0f)) return 0.0f > threshold;
  const float u = clamp_min(__fsub_rn(__fadd_rn(area_p, area_q), inter), 1e-12f);
  if (threshold >= 1e-6f && threshold <= 1.0f
      && inter < __fmul_rn(__fmul_rn(threshold, u), 0.99999f))
    return false;
  return __fdiv_rn(inter, u) > threshold;
}

// The words of a lane's two rows (boxes pa, pb): their candidates' bits by
// the exact formula, the two rows' candidates side by side; every other
// column has IoU 0 (`zero_passes`: whether 0 > threshold).
__device__ __forceinline__ void exact_words(float4 pa, u64 ma, float4 pb, u64 mb,
                                            const float4* cb, const float* ca, float threshold,
                                            u64 zero_passes, u64& wa, u64& wb) {
  const float area_a = box_area(pa.x, pa.y, pa.z, pa.w);
  const float area_b = box_area(pb.x, pb.y, pb.z, pb.w);
  wa = zero_passes & ~ma;
  wb = zero_passes & ~mb;
  while ((ma | mb) != 0ull) {
    if (ma != 0ull) {
      const int c = __ffsll((long long)ma) - 1;
      if (over_threshold(pa, area_a, cb[c], ca[c], threshold)) wa |= 1ull << c;
      ma &= ma - 1ull;
    }
    if (mb != 0ull) {
      const int c = __ffsll((long long)mb) - 1;
      if (over_threshold(pb, area_b, cb[c], ca[c], threshold)) wb |= 1ull << c;
      mb &= mb - 1ull;
    }
  }
}

// Decides a block's rows from its removed word `rem` (invalid rows, rows
// past K and rows removed by earlier blocks set) and its diagonal words
// (`diag`, `nrows` of them: bit c iff row c of the block overlaps; no row
// names itself; da and db, the lane's rows' words, loaded by the caller),
// as the greedy sweep would: row r is kept iff no kept row
// before it names it. First in parallel rounds, a lane for rows lane and
// lane + 32: an undecided row none of whose earlier overlaps is kept or
// undecided is kept, one with a kept earlier overlap is removed; each round
// decides at least the first undecided row, and most blocks take one or
// two. A block still undecided after kMaxRounds (a long chain of overlaps)
// takes the serial greedy from the start: a chain of 64 register steps.
__device__ __forceinline__ u64 decide(const u64* diag, int nrows, u64 rem, unsigned pre_a,
                                      u64 pre_b, u64 alone, int lane) {
  const unsigned full = 0xffffffffu;
  u64 und = ~rem;
  u64 kept = und & alone;  // no row before it in the block names it
  und &= ~alone;
  for (int round = 0; round < kMaxRounds && und != 0ull; ++round) {
    const bool ua = (und >> lane) & 1ull, ub = (und >> (lane + 32)) & 1ull;
    const bool ka = ua && (pre_a & (unsigned)(kept | und)) == 0u;
    const bool xa = ua && (pre_a & (unsigned)kept) != 0u;
    const bool kb = ub && (pre_b & (kept | und)) == 0ull;
    const bool xb = ub && (pre_b & kept) != 0ull;
    const u64 newk = ((u64)__ballot_sync(full, kb) << 32) | __ballot_sync(full, ka);
    const u64 newx = ((u64)__ballot_sync(full, xb) << 32) | __ballot_sync(full, xa);
    kept |= newk;
    und &= ~(newk | newx);
  }
  if (und == 0ull) return kept;
  // the serial greedy: row r's bit no longer changes after its turn, so
  // the kept rows are the clear bits at the end; rows 0-31 decide on the
  // low half alone, rows 32-63 on the high half
  unsigned lo = (unsigned)rem, hi = (unsigned)(rem >> 32);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const u64 d = r < nrows ? diag[r] & (~0ull << (r + 1)) : 0ull;  // later rows
    if (!(lo & (1u << r))) {
      lo |= (unsigned)d;
      hi |= (unsigned)(d >> 32);
    }
  }
#pragma unroll
  for (int r = 32; r < kBlockRows; ++r) {
    const unsigned d = r < nrows && r < 63 ? (unsigned)(diag[r] >> 32) & (~0u << (r - 31)) : 0u;
    if (!(hi & (1u << (r - 32)))) hi |= d;
  }
  return ~(((u64)hi << 32) | lo);
}

__global__ void __launch_bounds__(kClusterThreads, 2)
nms_cluster_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                   int K, int nwords, float threshold, uint8_t* __restrict__ alive) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = (int)cg::this_cluster().block_rank(), b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int slots = slots_of(nwords);
  float4* col_box = reinterpret_cast<float4*>(smem);                   // [slots*64]
  float4* col_test = col_box + slots * kBlockRows;                     // [slots*64]
  float* col_area = reinterpret_cast<float*>(col_test + slots * kBlockRows);
  float* col_sx = col_area + slots * kBlockRows;                       // [slots*64]
  float* col_maxw = col_sx + slots * kBlockRows;                       // [8]
  u64* kept_own = reinterpret_cast<u64*>(col_maxw + 8);                // [8]
  uint8_t* col_perm = reinterpret_cast<uint8_t*>(kept_own + 8);        // [slots*64]
  u64* words = reinterpret_cast<u64*>(col_perm + slots * kBlockRows);  // [slots][K]
  u64* inbox = words + (size_t)slots * K;                              // [2*nwords]
  unsigned* done = reinterpret_cast<unsigned*>(inbox + 2 * nwords);    // [slots][nwords]
  const float* bx = boxes + (size_t)b * K * 4;
  const uint8_t* v = valid + (size_t)b * K;
  const u64 zero_passes = 0.0f > threshold ? ~0ull : 0ull;  // IoU 0 > threshold

  int owned = 0;  // owned_block rises with the slot: the first `owned` are < nwords
  while (owned < slots && owned_block(cta, owned) < nwords) ++owned;

  // 1. IoU pass: the tiles (row block rb, slot l), rb <= the slot's
  //    block, in the order of rb, dealt out to the IoU warps (1-7) in turn;
  //    a lane takes rows 64*rb + lane and + 32 against the tile's 64
  //    columns, and loads its rows of the warp's next tile while it
  //    computes this one (the first beside the columns below). The sweep
  //    follows a tile's flag, so it starts on the first row blocks while
  //    the later ones are computed.
  int trb = 0, tl = -1, tt = -1;  // the warp's current tile, and its count
  auto advance = [&]() {          // to the warp's next tile; false at the end
    if (owned == 0) return false;
    for (;;) {
      if (++tl >= owned) {
        tl = 0;
        if (++trb >= nwords) return false;
      }
      if (owned_block(cta, tl) >= trb && ++tt % kIouWarps == warp - 1) return true;
    }
  };
  auto fetch = [&](int rb) {
    const int ra = rb * kBlockRows + lane;
    TileRows x;
    x.va = ra < K && v[ra];
    x.vb = ra + 32 < K && v[ra + 32];
    x.a = ra < K ? load_box(bx, ra) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x.b = ra + 32 < K ? load_box(bx, ra + 32) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return x;
  };
  bool more = warp > 0 && advance();
  TileRows cur = {};
  if (more) cur = fetch(trb);

  for (int s = tid; s < 2 * nwords; s += kClusterThreads) inbox[s] = 0ull;
  for (int s = tid; s < slots * nwords; s += kClusterThreads) done[s] = 0u;
  for (int s = tid; s < owned * kBlockRows; s += kClusterThreads) {
    const int j = owned_block(cta, s / kBlockRows) * kBlockRows + s % kBlockRows;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < K) q = make_float4(bx[j * 4], bx[j * 4 + 1], bx[j * 4 + 2], bx[j * 4 + 3]);
    col_box[s] = q;
    col_test[s] = test_box(j < K ? q : make_float4(1.0f, 1.0f, 0.0f, 0.0f));
    col_area[s] = box_area(q.x, q.y, q.z, q.w);
  }
  __syncthreads();
  // the first half of the one cluster barrier before the sweep, for warps
  // 1-7 (warp 0 arrives below)
  if (warp > 0) cluster_arrive_relaxed();
  // each slot's columns in the order of their test box's x1, and its widest
  // test box, rounded up: a row's candidates are then the columns whose x1
  // lies in (row x1 - widest, row x2), a run of the sorted order
  for (int s = tid; s < owned * kBlockRows; s += kClusterThreads) {
    const float* xs = &col_test[s - s % kBlockRows].x;
    const float x = col_test[s].x;
    int part[4] = {0, 0, 0, 0};  // four sums, so that the adds overlap
#pragma unroll 16
    for (int c = 0; c < kBlockRows; ++c) {
      const float y = xs[4 * c];
      part[c % 4] += (int)(y < x) | ((int)(y == x) & (int)(c < s % kBlockRows));
    }
    const int rank = part[0] + part[1] + part[2] + part[3];
    col_sx[s - s % kBlockRows + rank] = x;
    col_perm[s - s % kBlockRows + rank] = (uint8_t)(s % kBlockRows);
  }
  if (warp < owned) {
    float m = fmaxf(test_width(col_test[warp * kBlockRows + lane]),
                    test_width(col_test[warp * kBlockRows + lane + 32]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) col_maxw[warp] = m;
  }
  __syncthreads();

  if (warp > 0) {
    // 1. IoU pass (see above for the rows of the warp's first tile)
    while (more) {
      const int rb = trb, l = tl;
      const TileRows here = cur;
      more = advance();
      if (more) cur = fetch(trb);  // the next tile's rows, while this one runs
      const int w = owned_block(cta, l);
      const float4* cb = col_box + l * kBlockRows;
      const float4* cs = col_test + l * kBlockRows;
      const float* ca = col_area + l * kBlockRows;
      const float* sx = col_sx + l * kBlockRows;
      const uint8_t* perm = col_perm + l * kBlockRows;
      const float widest = col_maxw[l];
      u64 cand_a = 0ull, cand_b = 0ull;
      candidates(test_box(here.va ? here.a : make_float4(1.0f, 1.0f, 0.0f, 0.0f)),
                 test_box(here.vb ? here.b : make_float4(1.0f, 1.0f, 0.0f, 0.0f)),
                 sx, perm, cs, widest, cand_a, cand_b);
      // the mask: no row against itself; no column past K
      const int j0 = w * kBlockRows;
      const u64 cols = K - j0 < kBlockRows ? (1ull << (K - j0)) - 1ull : ~0ull;
      const u64 self_a = w == rb ? 1ull << lane : 0ull, self_b = self_a << 32;
      cand_a &= cols & ~self_a;
      cand_b &= cols & ~self_b;
      u64 wa, wb;
      exact_words(here.a, cand_a, here.b, cand_b, cb, ca, threshold, zero_passes, wa, wb);
      wa = here.va ? wa & cols & ~self_a : 0ull;
      wb = here.vb ? wb & cols & ~self_b : 0ull;
      u64* out = words + (size_t)l * K;
      const int ra = rb * kBlockRows + lane;
      if (ra < K) out[ra] = wa;
      if (ra + 32 < K) out[ra + 32] = wb;
      __syncwarp();
      if (lane == 0) set_flag(&done[l * nwords + rb]);
    }
    cluster_wait();
  } else {
    // warp 0's half of the barrier: its release orders the inbox's clearing,
    // which it has seen through the CTA barriers, before any other CTA's
    // store into it (a fence GPU-wide, about 0.7 us, that only this warp
    // waits for, while the first tiles are computed)
    cluster_arrive_release();
    cluster_wait();  // every inbox of the cluster is clear
#ifndef NMS_CUT_AFTER_IOU
    // 2. Sweep, warp 0: the removed word of each owned block in a register;
    //    each block's kept word, from its owner, ORed into the later ones;
    //    the owned block after it decided, written out and handed on.
    const unsigned full = 0xffffffffu;
    u64 rem[kMaxSlots];
#pragma unroll
    for (int l = 0; l < kMaxSlots; ++l) {
      rem[l] = ~0ull;
      if (l < owned) {  // invalid rows and rows past K start out removed
        const int r0 = owned_block(cta, l) * kBlockRows;
        const unsigned vlo = __ballot_sync(full, r0 + lane < K && v[r0 + lane]);
        const unsigned vhi = __ballot_sync(full, r0 + lane + 32 < K && v[r0 + lane + 32]);
        rem[l] = ~(((u64)vhi << 32) | vlo);
      }
    }
    const unsigned box = smem_addr(inbox);
    // lanes t and t + 8 hand a kept word's halves to CTA t if it owns a
    // later block: every store is then awaited by its receiver
    const int to = lane % kClusterCtas, to_last = last_owned(to, nwords);
    const unsigned to_box = map_rank(box, to) + 8 * (lane / kClusterCtas);
    const int last = last_owned(cta, nwords);
    for (int rb = -1; rb < last; ++rb) {
      // the slot of block rb + 1, if this CTA owns it
      int next = -1;
      u64 r_next = ~0ull;
#pragma unroll
      for (int l = 0; l < kMaxSlots; ++l) {
        if (l < owned && owned_block(cta, l) == rb + 1) {
          next = l;
          r_next = rem[l];
        }
      }
      u64 kept = 0ull;
      if (next >= 0) {
        // its words first, all local: the diagonal tile, and row block rb's
        const int w = rb + 1, r0 = w * kBlockRows, nrows = min(kBlockRows, K - r0);
        const u64* col = words + (size_t)next * K;
        wait_flag(&done[next * nwords + w]);
        const u64 da = lane < nrows ? col[r0 + lane] : 0ull;
        const u64 db = lane + 32 < nrows ? col[r0 + lane + 32] : 0ull;
        const unsigned pre_a = (unsigned)da & ((1u << lane) - 1u);  // earlier rows
        const u64 pre_b = db & ((1ull << (lane + 32)) - 1ull);
        const u64 alone = ((u64)__ballot_sync(full, pre_b == 0ull) << 32)
                          | __ballot_sync(full, pre_a == 0u);
        if (rb >= 0) {
          wait_flag(&done[next * nwords + rb]);
          const u64 a = col[rb * kBlockRows + lane], c = col[rb * kBlockRows + lane + 32];
          kept = wait_kept(box + 16 * rb);
          const u64 acc = (((kept >> lane) & 1ull) ? a : 0ull)
                          | (((kept >> (lane + 32)) & 1ull) ? c : 0ull);
          r_next |= ((u64)__reduce_or_sync(full, (unsigned)(acc >> 32)) << 32)
                    | __reduce_or_sync(full, (unsigned)acc);
        }
        const u64 kept_w = decide(col + r0, nrows, r_next, pre_a, pre_b, alone, lane);
        if (lane < 2 * kClusterCtas && to_last > w) {
          st_cluster(to_box + 16 * w, kPresent | ((lane < kClusterCtas ? kept_w : kept_w >> 32)
                                                  & 0xffffffffull));
        }
        if (lane == 0) kept_own[next] = kept_w;
      }
      if (rb < 0) continue;
      if (next < 0) kept = wait_kept(box + 16 * rb);
      // the other owned blocks after rb
#pragma unroll
      for (int l = 0; l < kMaxSlots; ++l) {
        if (l < owned && owned_block(cta, l) > rb + 1 && kept != 0ull) {
          wait_flag(&done[l * nwords + rb]);
          const u64* rows = words + (size_t)l * K + rb * kBlockRows;
          const u64 acc = (((kept >> lane) & 1ull) ? rows[lane] : 0ull)
                          | (((kept >> (lane + 32)) & 1ull) ? rows[lane + 32] : 0ull);
          rem[l] |= ((u64)__reduce_or_sync(full, (unsigned)(acc >> 32)) << 32)
                    | __reduce_or_sync(full, (unsigned)acc);
        }
      }
    }
    // alive, once the sweep is through: no store to device memory is
    // outstanding while the sweep waits on a flag
    __syncwarp();
    for (int l = 0; l < owned; ++l) {
      const int r0 = owned_block(cta, l) * kBlockRows;
      const u64 kept_w = kept_own[l];
      uint8_t* out = alive + (size_t)b * K + r0;
      if (r0 + lane < K) out[lane] = (kept_w >> lane) & 1ull;
      if (r0 + lane + 32 < K) out[lane + 32] = (kept_w >> (lane + 32)) & 1ull;
    }
#endif
  }
  // no CTA leaves before the cluster's sweep ends; every store into a CTA
  // has been awaited by then, so the arrival orders nothing
  cluster_arrive_relaxed();
  cluster_wait();
}

std::atomic<int> g_prepared[kMaxDevices];  // a device's state: 0 unknown,
                                           // 1 ready, -cudaError refused

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t max_active_clusters(int K, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(kClusterCtas, 1, 1), cluster_smem_bytes(K), 0, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, nms_cluster_kernel, &cfg);
}

// Once a device: lift the kernel's dynamic shared memory to the capacity's
// size, and check that a cluster of 8 CTAs of that size fits the device.
cudaError_t prepare_cluster_kernel() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int state = g_prepared[dev].load(std::memory_order_acquire);
  if (state != 0) return state > 0 ? cudaSuccess : (cudaError_t)(-state);
  err = cudaFuncSetAttribute(nms_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cluster_smem_bytes(kClusterMaxK));
  int clusters = 0;
  if (err == cudaSuccess) err = max_active_clusters(kClusterMaxK, &clusters);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  g_prepared[dev].store(err == cudaSuccess ? 1 : -(int)err, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// The two-launch kernels (kClusterMaxK < K <= kMaxK), as first shipped.

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
  extern __shared__ unsigned long long smem_words[];
  unsigned long long* removed = smem_words;         // [nwords]
  unsigned long long* diag = smem_words + nwords;   // [kBlockRows]
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

// boxes [B,K,4] fp32, valid [B,K] uint8 (0/1), alive [B,K] uint8: all
// contiguous on the current device. For K <= kClusterMaxK one cluster
// launch and `mask` is not read (it may be null); above that, mask scratch
// [B,K,ceil(K/64)] uint64 and two launches. Launches on `stream`; returns
// the cudaError_t of the launches (0 on success). K may be at most
// kMaxK = 16384 and B at most 65,535.
int nms_suppress(const float* boxes, const uint8_t* valid, unsigned long long* mask,
                 uint8_t* alive, int B, int K, float threshold, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK || B > 65535) return (int)cudaErrorInvalidValue;
  const int nwords = (K + kBlockRows - 1) / kBlockRows;
  if (K <= kClusterMaxK) {
    cudaError_t err = prepare_cluster_kernel();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(kClusterCtas, B, 1), cluster_smem_bytes(K), stream, &attr);
    err = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, boxes, valid, K, nwords, threshold,
                             alive);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(nwords, nwords, B);
  nms_mask_kernel<<<grid, kBlockRows, 0, stream>>>(boxes, K, nwords, threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(nwords + kBlockRows) * sizeof(unsigned long long);
  nms_sweep_kernel<<<B, 32, smem, stream>>>(mask, valid, K, nwords, alive);
  return (int)cudaGetLastError();
}

// The number of 8-CTA clusters of the cluster kernel that the current
// device holds at once at K's shared memory (cudaOccupancyMaxActiveClusters),
// or minus a cudaError_t.
int nms_cluster_fit(int K) {
  if (K <= 0 || K > kClusterMaxK) return -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster_kernel();
  int clusters = 0;
  if (err == cudaSuccess) err = max_active_clusters(K, &clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // extern "C"
