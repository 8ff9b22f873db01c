// K4: MaxPool3d(kernel=2, stride=2) over an NDHWC volume, float32 or
// bfloat16 (a maximum rounds nothing: the output keeps the input's type).
//
// Replaces lt_tpu/ops/pallas/updown.py:max_pool3d_2x (pallas_call at :143
// and :185; kernel bodies _pool_kernel :34, _pool_kernel_reshape :53,
// _pool_kernel_lanes :71), and the pools emitted inside the res3d kernels
// (emit_pooled).
//
// Bound on the card: bytes.  Each input is read once and each output
// written once (9/8 of the input volume's bytes); there is one compare per
// input.  Design: one thread per output element, channels fastest, so a
// warp reads 32 consecutive channels of one input voxel (coalesced) for
// each of the 8 taps.

#include "common.cuh"

template <typename T>
__global__ void max_pool3d_2x_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, int B, int X,
                                     int Y, int Z, int C) {
  const int xo = X / 2, yo = Y / 2, zo = Z / 2;
  const int64_t total = static_cast<int64_t>(B) * xo * yo * zo * C;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = static_cast<int>(i % C);
    int64_t r = i / C;
    const int oz = static_cast<int>(r % zo);
    r /= zo;
    const int oy = static_cast<int>(r % yo);
    r /= yo;
    const int ox = static_cast<int>(r % xo);
    const int64_t b = r / xo;
    const T* base =
        x + (((b * X + 2 * ox) * Y + 2 * oy) * static_cast<int64_t>(Z) +
             2 * oz) * C + c;
    float m = -INFINITY;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz)
          m = fmaxf(m, ltk_ld(base + ((static_cast<int64_t>(dx) * Y + dy) * Z + dz) * C));
    ltk_st(out + i, m);
  }
}

extern "C" int max_pool3d_2x(const void* x, void* out, int B, int X, int Y,
                             int Z, int C, int dtype, void* stream) {
  const int64_t total =
      static_cast<int64_t>(B) * (X / 2) * (Y / 2) * (Z / 2) * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kLtkF32)
    max_pool3d_2x_kernel<float><<<ltk_blocks(total, 256), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, X, Y, Z, C);
  else if (dtype == kLtkBF16)
    max_pool3d_2x_kernel<__nv_bfloat16><<<ltk_blocks(total, 256), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        B, X, Y, Z, C);
  else
    return kLtkBadDtype;
  return static_cast<int>(cudaGetLastError());
}
