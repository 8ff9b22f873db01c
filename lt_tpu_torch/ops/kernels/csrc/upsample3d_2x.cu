// K3: ConvTranspose3d(kernel=2, stride=2) + folded BN + ReLU [+ skip], NDHWC.
//
//   out[b, 2x+dx, 2y+dy, 2z+dz, co] =
//       relu(sum_ci in[b, x, y, z, ci] * w8[ci, t*Cout + co] + b8[t*Cout + co])
//       (+ skip[b, 2x+dx, 2y+dy, 2z+dz, co]),   t = dx*4 + dy*2 + dz.
//
// The skip is added AFTER the ReLU (the decoder's `up(x) + skip`).  x, w8,
// skip and out are float32 or bfloat16 (one type for the four), b8 is
// float32, and the sum, the ReLU and the skip add are float32, rounded once.
//
// Replaces lt_tpu/ops/pallas/updown.py:upsample3d_2x (pallas_call at :330
// and :376; kernel bodies _upsample_kernel :205, _upsample_kernel_lanes
// :243) and the upsample head of res3d.py:_ups_res3d_kernel (:976).
//
// Bound on the card: each output takes Cin multiply-adds (2*Cin flops) per
// 4 bytes written (8 with the skip), so at Cin = 64 it sits near the card's
// float32 balance point (67 TFLOP/s over 3.35 TB/s, about 20 flop/byte) and
// chip_smoke.py reports whichever bound is larger at each call's shapes.
// Design: one thread per output element, channels fastest: a warp
// reads one input voxel's channels by broadcast and 32 consecutive columns
// of w8 (coalesced, L1/L2-resident), and writes 32 consecutive outputs.

#include "common.cuh"

template <typename T>
__global__ void upsample3d_2x_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w8,
                                     const float* __restrict__ b8,
                                     const T* __restrict__ skip,
                                     T* __restrict__ out, int B, int X,
                                     int Y, int Z, int Cin, int Cout) {
  const int X2 = 2 * X, Y2 = 2 * Y, Z2 = 2 * Z;
  const int64_t total = static_cast<int64_t>(B) * X2 * Y2 * Z2 * Cout;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t wstride = 8 * static_cast<int64_t>(Cout);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int co = static_cast<int>(i % Cout);
    int64_t r = i / Cout;
    const int oz = static_cast<int>(r % Z2);
    r /= Z2;
    const int oy = static_cast<int>(r % Y2);
    r /= Y2;
    const int ox = static_cast<int>(r % X2);
    const int64_t b = r / X2;
    const int t = (ox & 1) * 4 + (oy & 1) * 2 + (oz & 1);
    const T* xin =
        x + (((b * X + (ox >> 1)) * Y + (oy >> 1)) * static_cast<int64_t>(Z) +
             (oz >> 1)) * Cin;
    const T* wcol = w8 + t * Cout + co;
    float acc = 0.f;
    for (int ci = 0; ci < Cin; ++ci) 
      acc = fmaf(ltk_ld(xin + ci), ltk_ld(wcol + ci * wstride), acc);
    float v = fmaxf(acc + b8[t * Cout + co], 0.f);
    if (skip != nullptr) v += ltk_ld(skip + i);
    ltk_st(out + i, v);
  }
}

template <typename T>
static void upsample3d_2x_launch(const void* x, const void* w8, const float* b8,
                                 const void* skip, void* out, int B, int X,
                                 int Y, int Z, int Cin, int Cout,
                                 cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(B) * 8 * X * Y * Z * Cout;
  upsample3d_2x_kernel<T><<<ltk_blocks(total, 256), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w8), b8,
      static_cast<const T*>(skip), static_cast<T*>(out), B, X, Y, Z, Cin, Cout);
}

extern "C" int upsample3d_2x(const void* x, const void* w8, const float* b8,
                             const void* skip, void* out, int B, int X, int Y,
                             int Z, int Cin, int Cout, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kLtkF32)
    upsample3d_2x_launch<float>(x, w8, b8, skip, out, B, X, Y, Z, Cin, Cout, s);
  else if (dtype == kLtkBF16)
    upsample3d_2x_launch<__nv_bfloat16>(x, w8, b8, skip, out, B, X, Y, Z, Cin,
                                        Cout, s);
  else
    return kLtkBadDtype;
  return static_cast<int>(cudaGetLastError());
}
