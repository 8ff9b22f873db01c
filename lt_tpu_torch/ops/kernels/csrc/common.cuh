// Shared by every kernel library of lt_tpu_torch (each .cu is its own .so).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* ltk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Element types of activations and weights: float32 or bfloat16.  Every
// kernel loads through ltk_ld into float32, accumulates and adds its bias in
// float32, and rounds once (to nearest even) where ltk_st stores bfloat16.
// The C entry points take the type as an int: kLtkF32 or kLtkBF16.
enum { kLtkF32 = 0, kLtkBF16 = 1 };
constexpr int kLtkBadDtype = static_cast<int>(cudaErrorInvalidValue);

__device__ __forceinline__ float ltk_ld(const float* p) { return *p; }
__device__ __forceinline__ float ltk_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void ltk_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void ltk_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Blocks for a grid-stride loop over `total` items, `threads` per block.
static inline int ltk_blocks(int64_t total, int threads, int64_t cap = 1 << 20) {
  int64_t b = (total + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < cap ? b : cap);
}

// The bilinear taps of one voxel in one view: tap k at pixel (x + (k & 1),
// y + (k >> 1)), its weight, and a bit per tap that is set where the tap
// lies in the map.
struct LtkTaps {
  float wt[4];
  unsigned in;
  int x, y;  // pixel of tap 0 (x0, y0), where a tap is in the map
};

// Project voxel (gx, gy, gz) through the composed 3x4 matrix
// mm (grid index -> homogeneous heatmap pixel) and pick its bilinear taps:
// x = u/w * sx, y = v/w * sy (sx = (W-1)/W, sy = (H-1)/H), align_corners=True,
// zero padding, no tap where w <= 0.  K1 (unproject_agg), K5 / K6
// (sample_views_t, sample_views_grad_t) and K7 / K8 (sample_views,
// sample_views_grad) all sample through this one function, so a backward
// recomputes exactly the taps that its forward took, also at pixel edges.
// Taps are tested in float coordinates: a far-off projection never reaches
// an integer conversion that could overflow.  Each kernel computes (gx,
// gy, gz) of its thread's voxel from its block and thread indices
// (sample_brick.cuh's brick_voxel; K1 likewise) and projects it once.
__device__ __forceinline__ LtkTaps ltk_voxel_taps(const float* __restrict__ mm,
                                                  float gx, float gy,
                                                  float gz, int H, int W,
                                                  float sx, float sy) {
  const float u = mm[0] * gx + mm[1] * gy + mm[2] * gz + mm[3];
  const float q = mm[4] * gx + mm[5] * gy + mm[6] * gz + mm[7];
  const float w = mm[8] * gx + mm[9] * gy + mm[10] * gz + mm[11];
  LtkTaps t;
  t.in = 0u;
  t.x = t.y = 0;
  if (!(w > 0.f)) {
    for (int k = 0; k < 4; ++k) t.wt[k] = 0.f;
    return t;
  }
  const float xf = u / w * sx;
  const float yf = q / w * sy;
  const float x0 = floorf(xf), y0 = floorf(yf);
  const float wx = xf - x0, wy = yf - y0;
  const bool xin0 = x0 >= 0.f && x0 <= W - 1.f;
  const bool xin1 = x0 + 1.f >= 0.f && x0 + 1.f <= W - 1.f;
  const bool yin0 = y0 >= 0.f && y0 <= H - 1.f;
  const bool yin1 = y0 + 1.f >= 0.f && y0 + 1.f <= H - 1.f;
  const int xi = xin0 || xin1 ? static_cast<int>(x0) : 0;
  const int yi = yin0 || yin1 ? static_cast<int>(y0) : 0;
  t.wt[0] = (1.f - wx) * (1.f - wy);
  t.wt[1] = wx * (1.f - wy);
  t.wt[2] = (1.f - wx) * wy;
  t.wt[3] = wx * wy;
  t.in = (yin0 && xin0 ? 1u : 0u) | (yin0 && xin1 ? 2u : 0u) |
         (yin1 && xin0 ? 4u : 0u) | (yin1 && xin1 ? 8u : 0u);
  t.x = xi;
  t.y = yi;
  return t;
}

// One tap's term of a bilinear sample, val + wt * f rounded once (an
// explicit FMA): K1 and sample_brick.cuh's gather4 (K5, K7) add the taps of
// a sample with it in the order k = 0..3, so a view that K1 samples alone
// gives K5's and K7's sample bit for bit.
__device__ __forceinline__ float ltk_tap(float val, float wt, float f) {
  return __fmaf_rn(wt, f, val);
}

// Asynchronous copies into shared memory and the launch helpers of the
// kernels that stage tiles there (K1, K2 and K3).
namespace ltk_async {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed
// (source size 0), which gives padding and ragged edges for free.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (zeroed where valid == false): a tile stored
// transposed, element by element.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Allow a kernel the largest dynamic shared memory a plan may ask for
// (above 48 KB it must be allowed first), once per device: `allowed` is a
// static of the caller's launch function, one per kernel instance.
// Returns a cudaError_t as int.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !allowed[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess && dev < 64) allowed[dev] = true;
  }
  return static_cast<int>(e);
}

}  // namespace ltk_async
