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
//
// Numbers. The sum runs in fp32 in registers in the order written above
// (x-pass, then y-pass, then k in order, then the fill term) and is rounded
// once to the pool's dtype (bf16 or fp32). Built with -fmad=false, so that
// it equals the plain PyTorch version (ops/cuda/mosaic_warp.py::warp_plain)
// bit for bit on finite pixels. The TPU kernel instead rounds tiles,
// weights and the x-pass to bf16 for its matrix unit and accumulates each
// tile into a bf16 output; this kernel is the more exact of the two.
//
// Design. The TPU kernel casts the warp as two 2-sparse matrix products per
// tile, because a TPU gathers slowly and multiplies fast. On Hopper the same
// function is a gather: one thread per output pixel computes its own taps,
// reads at most 2 rows x 2 columns of each tile that holds them (all three
// channels share the taps) and writes its three channels once. A tile whose
// taps all have weight 0 is skipped (it would add exactly 0). Blocks of
// 32 x 8 pixels keep neighbouring threads on neighbouring output columns,
// so the stores are coalesced and the source reads of a warp fall on one or
// two rows. Each block reads the tile indices, origins and coordinates
// itself (no scalar prefetch on this card); nothing carries between blocks.
//
// Bound. Bytes: the output (B*3*H*W elements) written once, plus every
// distinct source texel that carries a non-zero weight read once, at
// 3.35 TB/s. The arithmetic (about 20 flops per channel per covering tile)
// is far below that, so the kernel is bound by bytes; the design reads each
// texel a warp needs through L1/L2 and writes each output element once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;

__device__ __forceinline__ float load(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
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

template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
mosaic_warp_kernel(const T* __restrict__ pool, const int* __restrict__ tidx,
                   const int* __restrict__ ox, const int* __restrict__ oy,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   T* __restrict__ out, int K, int H, int W, int hix, int hiy,
                   float fill) {
  const int j = blockIdx.x * kTx + threadIdx.x;
  const int i = blockIdx.y * kTy + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= H || j >= W) return;
  const Axis y = split(__ldg(ys + (size_t)b * H + i), hiy);
  const Axis x = split(__ldg(xs + (size_t)b * W + j), hix);
  const int gy1 = y.g0 + 1, gx1 = x.g0 + 1;
  const size_t plane = (size_t)H * W;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool any_y0 = false, any_y1 = false, any_x0 = false, any_x1 = false;
  for (int k = 0; k < K; ++k) {
    const int oyk = __ldg(oy + b * K + k), oxk = __ldg(ox + b * K + k);
    const int ay0 = y.g0 - oyk, ay1 = gy1 - oyk;
    const int ax0 = x.g0 - oxk, ax1 = gx1 - oxk;
    const bool iny0 = ay0 >= 0 && ay0 < H, iny1 = ay1 >= 0 && ay1 < H;
    const bool inx0 = ax0 >= 0 && ax0 < W, inx1 = ax1 >= 0 && ax1 < W;
    any_y0 |= iny0;
    any_y1 |= iny1;
    any_x0 |= inx0;
    any_x1 |= inx1;
    const float wy0 = (1.0f - y.f) * (iny0 ? 1.0f : 0.0f) * y.v;
    const float wy1 = y.f * (iny1 ? 1.0f : 0.0f) * y.v;
    const float wx0 = (1.0f - x.f) * (inx0 ? 1.0f : 0.0f) * x.v;
    const float wx1 = x.f * (inx1 ? 1.0f : 0.0f) * x.v;
    if ((wy0 == 0.0f && wy1 == 0.0f) || (wx0 == 0.0f && wx1 == 0.0f)) continue;
    const size_t r0 = (size_t)clampi(ay0, H) * W, r1 = (size_t)clampi(ay1, H) * W;
    const int c0 = clampi(ax0, W), c1 = clampi(ax1, W);
    const T* src = pool + (size_t)__ldg(tidx + b * K + k) * 3 * plane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* p = src + c * plane;
      const float top = load(p, r0 + c0) * wx0 + load(p, r0 + c1) * wx1;
      const float bot = load(p, r1 + c0) * wx0 + load(p, r1 + c1) * wx1;
      acc[c] = acc[c] + (wy0 * top + wy1 * bot);
    }
  }
  const float covy = ((1.0f - y.f) * (any_y0 ? 1.0f : 0.0f)
                      + y.f * (any_y1 ? 1.0f : 0.0f)) * y.v;
  const float covx = ((1.0f - x.f) * (any_x0 ? 1.0f : 0.0f)
                      + x.f * (any_x1 ? 1.0f : 0.0f)) * x.v;
  const float add = fill * (1.0f - covy * covx);
  T* dst = out + (size_t)b * 3 * plane + (size_t)i * W + j;
#pragma unroll
  for (int c = 0; c < 3; ++c) store(dst, c * plane, acc[c] + add);
}

}  // namespace

extern "C" {

// pool [N,3,H,W] (fp32, or bf16 when is_bf16), tidx/ox/oy [B,K] int32,
// xs [B,W] and ys [B,H] fp32, out [B,3,H,W] in the pool's dtype; all
// contiguous on the current device, every tidx in [0, N). Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
int mosaic_warp(const void* pool, int is_bf16, const int* tidx, const int* ox,
                const int* oy, const float* xs, const float* ys, void* out, int B,
                int K, int H, int W, int hix, int hiy, float fill,
                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || H < 1 || W < 1 || hix < 1 || hiy < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, B);
  if (is_bf16) {
    mosaic_warp_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(pool), tidx, ox, oy, xs, ys,
        static_cast<__nv_bfloat16*>(out), K, H, W, hix, hiy, fill);
  } else {
    mosaic_warp_kernel<float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(pool), tidx, ox, oy, xs, ys,
        static_cast<float*>(out), K, H, W, hix, hiy, fill);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
