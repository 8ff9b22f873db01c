// K4: MaxPool3d(kernel=2, stride=2) over an NDHWC float32 volume.
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

__global__ void max_pool3d_2x_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int B, int X,
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
    const float* base =
        x + (((b * X + 2 * ox) * Y + 2 * oy) * static_cast<int64_t>(Z) +
             2 * oz) * C + c;
    float m = -INFINITY;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz)
          m = fmaxf(m, base[((static_cast<int64_t>(dx) * Y + dy) * Z + dz) * C]);
    out[i] = m;
  }
}

extern "C" int max_pool3d_2x(const float* x, float* out, int B, int X, int Y,
                             int Z, int C, void* stream) {
  const int64_t total =
      static_cast<int64_t>(B) * (X / 2) * (Y / 2) * (Z / 2) * C;
  max_pool3d_2x_kernel<<<ltk_blocks(total, 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, B, X, Y,
                                                              Z, C);
  return static_cast<int>(cudaGetLastError());
}
