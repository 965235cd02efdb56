// Separable bilinear warp of K tiles fetched by index from a channel-major
// pool, for Hopper (sm_90a): the mosaic (K=4) and the mixup partner (K=1) of
// the device augmentation.
//
// Replaces the TPU kernel pl_yolo_tpu/ops/pallas/mosaic_pallas.py::
// _mosaic_kernel (driven by _warp_chw; entries mosaic_sample_idx and
// warp_sample_idx). Same function, per output pixel (b, i, j) and channel c:
//
//   out = sum_k [ wy0 (t[y0,x0] wx0 + t[y0,x1] wx1)
//               + wy1 (t[y1,x0] wx0 + t[y1,x1] wx1) ]  +  fill (1 - covy covx)
//
// with t = pool[tidx[b,k], c]. Along each axis a raw coordinate is valid on
// [0, hi-1]; it is clipped, g0 = floor, f = c - g0, g1 = g0 + 1 (not clamped:
// its weight is 0 at the last coordinate). A tap's weight lands in the tile
// that holds it (a = g - origin in [0, n)); an out-of-tile tap has weight 0
// and a clamped index. Coverage is ((1-f) in_any(g0) + f in_any(g1)) valid
// over all K origins, so pixels that no tile covers blend towards `fill`.
// Without origins (ox = oy = null) every origin is 0.
//
// Numbers. The sum runs in fp32 in registers in the order written above
// (x-pass, then y-pass, then k in order, then the fill term) and is rounded
// once to the pool's dtype (bf16 or fp32). Built with -fmad=false, so that
// it equals the plain PyTorch version (ops/cuda/mosaic_warp.py::warp_plain)
// bit for bit on finite pixels. The TPU kernel instead rounds tiles,
// weights and the x-pass to bf16 for its matrix unit and accumulates each
// tile into a bf16 output; this kernel is the more exact of the two.
//
// Index check. A tile index outside [0, N) is never read: the block that
// meets it skips the tile and writes 0 to `ok`, a one-element flag that the
// wrapper holds at 1 and asserts on the card's timeline after the launch
// (torch._assert_async), so the run stops with a device-side assert and the
// host never waits for the indices.
//
// Design. The TPU kernel casts the warp as two 2-sparse matrix products per
// tile, because a TPU gathers slowly and multiplies fast. On Hopper the same
// function is a gather. The first version ran one thread per output pixel
// and spent its instructions, not its bytes: each pixel recomputed both
// axes' taps for all K tiles (a row's y-taps are shared by all its pixels, a
// column's x-taps by all its rows), did its index arithmetic in 64 bits, and
// wrote three scalar 2-byte stores. This one gives a block of 256 threads a
// 16-row x 128-column tile of one image:
//  - the block first computes each tile's column taps (128 of them) and row
//    taps (16) once, with their weights and the coverage flags, into shared
//    memory; K is taken in groups of kGroup tiles, in order;
//  - a tile whose weights are 0 on every column or on every row of the block
//    is skipped by the whole block (it would add exactly 0 everywhere);
//  - each thread then gathers 8 pixels (2 rows x 4 columns, 32 apart, so that
//    a warp's loads cover 32 neighbouring columns of one row and fall on one
//    or two source rows), at most 2 x 2 texels a covering tile, all three
//    channels sharing the taps, with 32-bit offsets inside a tile's plane;
//  - the rounded results go through shared memory and leave as 16-byte
//    vector stores (8 bf16 or 4 fp32 of one channel row) where W allows it.
// The source loads stay 2-byte gathers: a warp's 32 loads fall on 32
// neighbouring source columns (fewer when zoomed in), so each already reads
// whole 32-byte sectors; wider loads would need the texels staged in shared
// memory first, which a zoom-out by 10 (scale 0.1) makes 10x larger than
// what the block uses.
//
// Bound. Bytes: the output (B*3*H*W elements) written once, plus every
// distinct source texel that carries a non-zero weight read once, at
// 3.35 TB/s. The arithmetic (about 20 flops per channel per covering tile)
// is far below that, so the function is bound by bytes. On the augmented
// step's two calls (B=16, 640^2, bf16) this version takes ~3x / ~2.2x the
// bound (mosaic K=4 / mixup K=1; the first version 5.5x / 3.0x), about
// half of it in the taps and stores and half in the source loads
// (chip_smoke.py on an H100 80GB HBM3 at 700 W; numbers in PERF.md).


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;              // columns a thread, 32 apart
constexpr int kRows = 2;              // rows a thread, kWarps apart
constexpr int kBW = 32 * kCols;       // the block's columns
constexpr int kBH = kWarps * kRows;   // the block's rows
constexpr int kGroup = 4;             // tiles whose taps are staged at a time

__device__ __forceinline__ float load(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}
__device__ __forceinline__ float to_t(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_t(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// one axis: the clip of a raw coordinate to [0, hi-1], its floor, the
// fraction and the validity as 0/1
struct Axis {
  int g0;
  float f, v;
};

__device__ __forceinline__ Axis split(float c, int hi) {
  const float top = (float)(hi - 1);
  const float csc = fminf(fmaxf(c, 0.0f), top);
  Axis a;
  a.g0 = (int)floorf(csc);
  a.f = csc - (float)a.g0;
  a.v = (c >= 0.0f && c <= top) ? 1.0f : 0.0f;
  return a;
}

__device__ __forceinline__ int clampi(int a, int n) { return min(max(a, 0), n - 1); }

// one tile's two taps along one axis: clamped indices (rows pre-multiplied
// by W) and weights
struct Tap {
  int i0, i1;
  float w0, w1;
};

// The taps of tile k at coordinate `a` (an axis of length n): sets the
// in-tile flags and returns the tap, as the first version computed it per
// pixel.
__device__ __forceinline__ Tap make_tap(const Axis& a, int origin, int n, int scale,
                                        bool& in0, bool& in1) {
  const int a0 = a.g0 - origin, a1 = a.g0 + 1 - origin;
  in0 = a0 >= 0 && a0 < n;
  in1 = a1 >= 0 && a1 < n;
  Tap t;
  t.w0 = (1.0f - a.f) * (in0 ? 1.0f : 0.0f) * a.v;
  t.w1 = a.f * (in1 ? 1.0f : 0.0f) * a.v;
  t.i0 = clampi(a0, n) * scale;
  t.i1 = clampi(a1, n) * scale;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mosaic_warp_kernel(const T* __restrict__ pool, int N, const int64_t* __restrict__ tidx,
                   const int* __restrict__ ox, const int* __restrict__ oy,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   T* __restrict__ out, int* __restrict__ ok, int K, int H, int W,
                   int hix, int hiy, float fill) {
  __shared__ Tap xt[kGroup][kBW];
  __shared__ Tap yt[kGroup][kBH];
  __shared__ const T* src[kGroup];
  __shared__ int nz_x[kGroup], nz_y[kGroup];
  __shared__ float covx[kBW], covy[kBH];
  __shared__ __align__(16) unsigned char stage_bytes[3 * kBH * kBW * sizeof(T)];
  auto stage = reinterpret_cast<T(*)[kBH][kBW]>(stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, j0 = blockIdx.x * kBW, i0 = blockIdx.y * kBH;
  const size_t plane = (size_t)H * W;

  // tap threads: tid < kBW owns column j0 + tid, the next kBH own rows
  const bool col_tap = tid < kBW;
  const bool row_tap = !col_tap && tid < kBW + kBH;
  const int line = col_tap ? j0 + tid : i0 + (tid - kBW);
  const bool live = (col_tap && line < W) || (row_tap && line < H);
  Axis ax = {0, 0.0f, 0.0f};
  if (live)
    ax = col_tap ? split(__ldg(xs + (size_t)b * W + line), hix)
                     : split(__ldg(ys + (size_t)b * H + line), hiy);
  bool any0 = false, any1 = false;

  float acc[kRows][kCols][3];
#pragma unroll
  for (int p = 0; p < kRows; ++p)
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[p][q][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kGroup) {
    const int G = min(kGroup, K - k0);
    if (tid < kGroup) nz_x[tid] = nz_y[tid] = 0;
    __syncthreads();  // the flags are clear
    if (col_tap || row_tap) {
      const int* org = col_tap ? ox : oy;
      const int n = col_tap ? W : H, scale = col_tap ? 1 : W;
      for (int g = 0; g < G; ++g) {
        Tap t = {0, 0, 0.0f, 0.0f};
        if (live) {
          bool in0, in1;
          const int o = org == nullptr ? 0 : __ldg(org + (size_t)b * K + k0 + g);
          t = make_tap(ax, o, n, scale, in0, in1);
          any0 |= in0;
          any1 |= in1;
          if (t.w0 != 0.0f || t.w1 != 0.0f) {
            if (col_tap) nz_x[g] = 1; else nz_y[g] = 1;
          }
        }
        if (col_tap) xt[g][tid] = t; else yt[g][tid - kBW] = t;
      }
    } else if (tid < kBW + kBH + kGroup) {
      const int g = tid - kBW - kBH;
      if (g < G) {
        const int64_t t = __ldg(tidx + (size_t)b * K + k0 + g);
        const bool good = t >= 0 && t < N;
        if (!good) *ok = 0;  // never read: the wrapper's assert stops the run
        src[g] = good ? pool + (size_t)t * 3 * plane : nullptr;
      }
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      if (!(nz_x[g] && nz_y[g]) || src[g] == nullptr) continue;  // block-uniform
      const T* s0 = src[g];
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        const Tap ty = yt[g][warp + kWarps * p];
        if (ty.w0 == 0.0f && ty.w1 == 0.0f) continue;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const Tap tx = xt[g][lane + 32 * q];
          if (tx.w0 == 0.0f && tx.w1 == 0.0f) continue;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const T* pc = s0 + c * plane;
            const float top = load(pc, ty.i0 + tx.i0) * tx.w0 + load(pc, ty.i0 + tx.i1) * tx.w1;
            const float bot = load(pc, ty.i1 + tx.i0) * tx.w0 + load(pc, ty.i1 + tx.i1) * tx.w1;
            acc[p][q][c] = acc[p][q][c] + (ty.w0 * top + ty.w1 * bot);
          }
        }
      }
    }
    // the group is consumed before the next one clears its flags and
    // overwrites its taps
    if (k0 + kGroup < K) __syncthreads();
  }

  // coverage over all K origins, then the fill term, rounded once
  if (col_tap || row_tap) {
    const float cov = ((1.0f - ax.f) * (any0 ? 1.0f : 0.0f)
                       + ax.f * (any1 ? 1.0f : 0.0f)) * ax.v;
    if (col_tap) covx[tid] = cov; else covy[tid - kBW] = cov;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int il = warp + kWarps * p;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int jl = lane + 32 * q;
      const float add = fill * (1.0f - covy[il] * covx[jl]);
#pragma unroll
      for (int c = 0; c < 3; ++c) stage[c][il][jl] = to_t(acc[p][q][c] + add, T());
    }
  }
  __syncthreads();

  // out: 16-byte vectors of one channel row where W allows, else scalars
  T* dst = out + (size_t)b * 3 * plane;
  constexpr int kVec = 16 / sizeof(T);
  if (W % kVec == 0) {
    constexpr int kPerRow = kBW / kVec;
    for (int v = tid; v < 3 * kBH * kPerRow; v += kThreads) {
      const int c = v / (kBH * kPerRow), r = (v / kPerRow) % kBH, s = v % kPerRow;
      const int i = i0 + r, j = j0 + s * kVec;
      if (i < H && j < W)
        *reinterpret_cast<uint4*>(dst + c * plane + (size_t)i * W + j) =
            *reinterpret_cast<const uint4*>(&stage[c][r][s * kVec]);
    }
  } else {
    for (int v = tid; v < 3 * kBH * kBW; v += kThreads) {
      const int c = v / (kBH * kBW), r = (v / kBW) % kBH, s = v % kBW;
      const int i = i0 + r, j = j0 + s;
      if (i < H && j < W) dst[c * plane + (size_t)i * W + j] = stage[c][r][s];
    }
  }
}

}  // namespace

extern "C" {

// pool [N,3,H,W] (fp32, or bf16 when is_bf16), tidx [B,K] int64, ox/oy
// [B,K] int32 or both null (every origin 0), xs [B,W] and ys [B,H] fp32,
// out [B,3,H,W] in the pool's dtype, ok one int32 that the kernel sets to 0
// if a tile index lies outside [0, N); all contiguous on the current device.
// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
int mosaic_warp(const void* pool, int is_bf16, int N, const int64_t* tidx,
                const int* ox, const int* oy, const float* xs, const float* ys,
                void* out, int* ok, int B, int K, int H, int W, int hix, int hiy,
                float fill, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || H < 1 || W < 1 || hix < 1 || hiy < 1 || B > 65535 ||
      (int64_t)H * W > 0x7fffffff || (ox == nullptr) != (oy == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBW - 1) / kBW, (H + kBH - 1) / kBH, B);
  if (is_bf16) {
    mosaic_warp_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(pool), N, tidx, ox, oy, xs, ys,
        static_cast<__nv_bfloat16*>(out), ok, K, H, W, hix, hiy, fill);
  } else {
    mosaic_warp_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(pool), N, tidx, ox, oy, xs, ys,
        static_cast<float*>(out), ok, K, H, W, hix, hiy, fill);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
