// K2, float32 inputs, on the tensor cores: a split into bfloat16 parts.
//
//   split_bf16:      v (float32) -> parts v1 = bf16(v), v2 = bf16(v - v1)
//                    (and v3 = bf16(v - v1 - v2)), each rounded to nearest
//                    even; out holds the parts one after another.
//   conv3d_mma_f32:  conv3d_mma.cuh's body with x and w given as their
//                    parts and a float32 residual: per k16 step, k <= 3,
//                    the six products of three parts with i + j <= 2;
//                    k = 7, mma(x1, w1) + mma(x1, w2) + mma(x2, w1) (two
//                    parts, three terms), into float32 accumulators.
//
// v1 + v2 is within 2^-16 relative of v (bfloat16 keeps 8 significant
// bits: |v - v1| <= 2^-8 |v|, |v - v1 - v2| <= 2^-8 |v - v1|), v1 + v2 +
// v3 within 2^-24; bfloat16 has float32's exponent range, so the split is
// finite for every finite v up to bfloat16's largest finite value
// (3.39e38).  With two parts the products drop only x2 * w2 and the
// rounding of x2 and w2, about 2^-16 relative each, with three about
// 2^-24: K2's float32 contract of relative 1e-4 of max |output| holds
// either way (the CPU tests emulate the terms with F.conv3d), and the six
// products keep the deep V2V's volumes near the plain path's too (see
// conv3d_mma.cuh).
//
// Replaces, with conv3d_mma.cu, the convolutions inside the TPU kernels
// listed in conv3d_mma.cuh.  Bound on the card (chip_smoke.py): split_bf16
// moves 4 + 2 parts bytes per value (bytes); the convolution is bounded as
// the float32 function it computes, its float32 operands' bytes and three
// bfloat16 tensor-core products per float32 one (two parts, which hold
// K2's contract launch by launch), although this body does six for k <= 3.
// The weights are split once per weight version where models/v2v.py packs
// them, or on each call where they come whole; the activations on each
// call.

#include "conv3d_mma.cuh"

namespace {

// 8 values a thread (two 16-byte loads, 16-byte stores) where the pointers
// and n allow (vec), else element by element.
template <int PARTS>
__global__ void split_bf16_kernel(const float* __restrict__ v,
                                  __nv_bfloat16* __restrict__ out, int64_t n,
                                  int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int64_t i = i0; vec && i < n / 8; i += stride) {
    const float4* src = reinterpret_cast<const float4*>(v) + 2 * i;
    const float4 a = src[0], b = src[1];
    float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      unsigned u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * q], r[2 * q + 1]);
        const float2 hf = __bfloat1622float2(h);
        r[2 * q] -= hf.x;
        r[2 * q + 1] -= hf.y;
        u[q] = *reinterpret_cast<const unsigned*>(&h);
      }
      reinterpret_cast<uint4*>(out + p * n)[i] =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
  for (int64_t i = vec ? n : i0; i < n; i += stride) {
    float r = v[i];
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      const __nv_bfloat16 h = __float2bfloat16_rn(r);
      out[p * n + i] = h;
      r -= __bfloat162float(h);
    }
  }
}

}  // namespace

// v: n float32 values; out: parts * n bfloat16 values, the parts one
// after another; parts 2 or 3.
extern "C" int split_bf16(const float* v, void* out, int64_t n, int parts,
                          void* stream) {
  if (n < 0 || parts < 2 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int vec = aligned16(v) && aligned16(o) && aligned16(o + n);
  const int threads = 256, blocks = ltk_blocks(vec ? n / 8 : n, threads, 4096);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts == 2)
    split_bf16_kernel<2><<<blocks, threads, 0, s>>>(v, o, n, vec);
  else
    split_bf16_kernel<3><<<blocks, threads, 0, s>>>(v, o, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// x and w: the (parts, ...) bfloat16 parts of the float32 input and
// weights (split_bf16), parts 2 or 3; res float32;
// in_dtype must be kLtkF32.  The rest as conv3d_mma.cu's entry point.
extern "C" int conv3d_mma_f32(const void* x, const void* w, const float* bias,
                              const void* res, void* out, int B, int X, int Y,
                              int Z, int Cin, int Cout, int K, int relu,
                              int in_dtype, int out_dtype, int nt, int ck,
                              int bx, int by, int bz, int nh, int smem,
                              int grid, int parts, void* stream) {
  return conv3d_mma_entry<true>(x, w, bias, res, out, B, X, Y, Z, Cin, Cout,
                                K, relu, in_dtype, out_dtype, nt, ck, bx, by,
                                bz, nh, smem, grid, parts, stream);
}
