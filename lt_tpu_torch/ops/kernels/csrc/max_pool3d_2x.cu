// K4: MaxPool3d(kernel=2, stride=2) over an NDHWC volume (B, X, Y, Z, C),
// float32 or bfloat16, all dims even, any C; the output keeps the input's
// type (a maximum rounds nothing) and NaN (as jnp.maximum does).
//
// Replaces lt_tpu/ops/pallas/updown.py:max_pool3d_2x (pallas_call at :143
// and :185; kernel bodies _pool_kernel :34, _pool_kernel_reshape :53,
// _pool_kernel_lanes :71), and the pools emitted inside the res3d kernels
// (emit_pooled).
//
// Bound on the card: bytes.  Each input byte is read once and each output
// byte written once (9/8 of the input's bytes), one compare per input: a
// pure stream with no reuse, so nothing is staged in shared memory.  What
// counts is that every fetched sector is used, that enough bytes are in
// flight, and that few instructions are issued per byte:
// - A thread owns V channels of one output voxel, V x itemsize = 16 bytes
//   (4 float32, 8 bfloat16).  For each of the four (dx, dy) input rows it
//   loads the two z-neighbours 2oz and 2oz+1: eight 16-byte streaming loads
//   (ld.global.cs), all issued before the first compare.
// - threadIdx.x runs over the channel vectors and threadIdx.y over oz, so
//   a warp's loads of one row cover one contiguous stretch of it.
// - The grid is (oz blocks, Y/2, B * X/2), so a thread finds its voxel
//   without a division; the host keeps the element count below 2^31, so
//   every offset is 32-bit.
// - The maximum keeps NaN (max.NaN.f32, __hmax2_nan) and starts from the
//   first tap.
// Where C is not a multiple of V, or a base pointer is not 16-byte
// aligned, the scalar instance (V = 1) of the same template runs.
// Launch plan: updown.pool_plan (the vector width, the block, the grid).

#include "common.cuh"

namespace {

// A load unit of V elements of T and its NaN-keeping maximum.
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 4> {
  using U = float4;
  static __device__ __forceinline__ U max(U a, U b) {
    return make_float4(ltk_max_nan(a.x, b.x), ltk_max_nan(a.y, b.y),
                       ltk_max_nan(a.z, b.z), ltk_max_nan(a.w, b.w));
  }
};

template <>
struct Pack<float, 1> {
  using U = float;
  static __device__ __forceinline__ U max(U a, U b) {
    return ltk_max_nan(a, b);
  }
};

__device__ __forceinline__ unsigned hmax2_nan(unsigned a, unsigned b) {
  const __nv_bfloat162 m =
      __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&m);
}

template <>
struct Pack<__nv_bfloat16, 8> {
  using U = uint4;
  static __device__ __forceinline__ U max(U a, U b) {
    return make_uint4(hmax2_nan(a.x, b.x), hmax2_nan(a.y, b.y),
                      hmax2_nan(a.z, b.z), hmax2_nan(a.w, b.w));
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using U = unsigned short;
  static __device__ __forceinline__ U max(U a, U b) {
    return __bfloat16_as_ushort(
        __hmax_nan(__ushort_as_bfloat16(a), __ushort_as_bfloat16(b)));
  }
};

template <typename T, int V>
__global__ void max_pool3d_2x_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, int Y, int Z,
                                     int C) {
  using P = Pack<T, V>;
  using U = typename P::U;
  const unsigned zo = Z / 2, oz = blockIdx.x * blockDim.y + threadIdx.y;
  if (oz >= zo) return;
  const unsigned oy = blockIdx.y, q = blockIdx.z;  // q = b * X/2 + ox
  const unsigned row = static_cast<unsigned>(Z) * C;  // one input row
  // Input row (b, 2ox, 2oy) is 2q * Y + 2oy; output row (b, ox, oy) is
  // q * Y/2 + oy.
  const unsigned in0 = ((2u * q) * Y + 2u * oy) * row + 2u * oz * C;
  const unsigned out0 = (q * (Y / 2) + oy) * (zo * C) + oz * C;
  for (int cv = threadIdx.x; cv < C / V; cv += blockDim.x) {
    U t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // k = dx * 4 + dy * 2 + dz
      const unsigned off =
          in0 + ((k >> 2) * Y + (k >> 1 & 1)) * row + (k & 1) * C + cv * V;
      t[k] = __ldcs(reinterpret_cast<const U*>(x + off));
    }
    const U m = P::max(P::max(P::max(t[0], t[1]), P::max(t[2], t[3])),
                       P::max(P::max(t[4], t[5]), P::max(t[6], t[7])));
    *reinterpret_cast<U*>(out + out0 + cv * V) = m;
  }
}

template <typename T, int V>
int launch(const void* x, void* out, int Y, int Z, int C, dim3 grid,
           dim3 block, cudaStream_t s) {
  max_pool3d_2x_kernel<T, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Y, Z, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's fields (vec, bx, by, gx, gy, gz) come from updown.pool_plan;
// a plan that does not fit the shapes, the type or the pointers is refused
// with cudaErrorInvalidValue.
extern "C" int max_pool3d_2x(const void* x, void* out, int B, int X, int Y,
                             int Z, int C, int dtype, int vec, int bx, int by,
                             int gx, int gy, int gz, void* stream) {
  const int64_t numel = static_cast<int64_t>(B) * X * Y * Z * C;
  const int wide = dtype == kLtkF32 ? 4 : 8;  // V of the vector instance
  const bool aligned = ltk_async::aligned16(x) && ltk_async::aligned16(out);
  if ((dtype != kLtkF32 && dtype != kLtkBF16) || numel >= (int64_t{1} << 31) ||
      (X | Y | Z) & 1 || (vec != 1 && (vec != wide || C % vec || !aligned)) ||
      gy != Y / 2 || gz != B * (X / 2) ||
      static_cast<int64_t>(gx) * by < Z / 2)
    return kLtkBadDtype;
  const dim3 grid(gx, gy, gz), block(bx, by);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kLtkF32)
    return vec == 1 ? launch<float, 1>(x, out, Y, Z, C, grid, block, s)
                    : launch<float, 4>(x, out, Y, Z, C, grid, block, s);
  return vec == 1 ? launch<__nv_bfloat16, 1>(x, out, Y, Z, C, grid, block, s)
                  : launch<__nv_bfloat16, 8>(x, out, Y, Z, C, grid, block, s);
}
