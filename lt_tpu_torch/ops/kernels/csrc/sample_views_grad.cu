// K8: the feature gradient of K7, a bilinear scatter.
//
//   dF[bv, y, x, c] = sum over voxels n of g[bv, n, c] * (the bilinear weight
//                     of tap (y, x) in voxel n's sample)
// with voxels at w <= 0 and taps outside the map contributing nothing.  The
// function of K6 (sample_views_grad_t.cu) with g's last two axes the other
// way round; the taps come from common.cuh's ltk_voxel_taps.  dF must be
// zeroed by the caller.  g is float32 or bfloat16; dF, the weights and the
// products are float32: the function is computed exactly, where the TPU
// kernel rounded the weights and g to bfloat16 (unproject.py:876-880).
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_grad_features
// (pallas_call :906; kernel body _unproject_bwd_kernel :837).
//
// Bound on the card: bytes.  g (BV * S^3 * C elements, 671 MB in float32 at
// 20 x 64^3 x 32) is read once; dF (1.2 MB per view) stays in the L2.
//
// Design: one warp per voxel, lanes over channels: a voxel's gradient row is
// one coalesced load and each of its four taps one row of atomicAdds, 32
// neighbouring floats per instruction, so K6's shared-memory transpose
// falls away.  Elements whose gradient is exactly 0 (masked views) cause no
// atomics.  As in K6, many voxels land on one pixel and their float
// atomicAdds arrive in an order that changes from run to run, so dF varies
// in its last bits between runs.

#include "common.cuh"

namespace {
template <typename TG>
__global__ void sample_views_grad_kernel(const TG* __restrict__ g,
                                         const float* __restrict__ m,
                                         float* __restrict__ df, int BV, int H,
                                         int W, int C, int S, float sx,
                                         float sy) {
  const int lane = threadIdx.x & 31;
  const int64_t N = static_cast<int64_t>(S) * S * S;
  const int64_t total = static_cast<int64_t>(BV) * N;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t t = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       t < total; t += nwarps) {
    const int bv = static_cast<int>(t / N);
    const LtkTaps tp = ltk_voxel_taps(m + bv * 12, t % N, S, H, W, sx, sy);
    if (tp.in == 0u) continue;
    float* db = df + static_cast<int64_t>(bv) * H * W * C;
    for (int c = lane; c < C; c += 32) {
      const float gv = ltk_ld(g + t * C + c);
      if (gv == 0.f) continue;
      for (int k = 0; k < 4; ++k)
        if (tp.in & (1u << k))
          atomicAdd(db + static_cast<int64_t>(tp.off[k]) * C + c,
                    tp.wt[k] * gv);
    }
  }
}
}  // namespace

extern "C" int sample_views_grad(const void* g, const float* m, float* df,
                                 int BV, int H, int W, int C, int S, float sx,
                                 float sy, int g_dtype, void* stream) {
  const int64_t total = static_cast<int64_t>(BV) * S * S * S;
  const int threads = 256;
  const int blocks = ltk_blocks(total, threads / 32, 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == kLtkF32)
    sample_views_grad_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), m, df, BV, H, W, C, S, sx, sy);
  else if (g_dtype == kLtkBF16)
    sample_views_grad_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), m, df, BV, H, W, C, S, sx, sy);
  else
    return kLtkBadDtype;
  return static_cast<int>(cudaGetLastError());
}
