// K7: per-view bilinear sampling of an affine voxel grid, voxels-major.
//
// For every (bv, n) with voxel n = (gx*S + gy)*S + gz of an S^3 grid:
//   out[bv, n, c] = bilinear sample of features[bv] (H, W, C) at the pixel
//                   that m[bv] (3x4, grid index -> homogeneous heatmap pixel)
//                   projects voxel n to; 0 where w <= 0 or a tap is outside
//                   the map (align_corners=True, zero padding).
// The function of K5 (sample_views_t.cu) with the output's last two axes the
// other way round; the taps come from common.cuh's ltk_voxel_taps, as in K1,
// K5, K6 and K8.
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_fwd_impl (pallas_call
// :548 and :581; kernel body _unproject_kernel :156).  Its column bands and
// subtiles are TPU schedule and are left behind.
//
// The features are float32 or bfloat16, the output float32 or bfloat16
// (the TPU kernel's out_dtype); m and all arithmetic are float32.
//
// Bound on the card: bytes.  The output (BV * S^3 * C elements, 671 MB in
// float32 at 20 x 64^3 x 32) is written once; the features (1.2 MB per view
// at 96 x 96 x 32) stay in the 50 MB L2.
//
// Design: one warp per voxel, lanes over channels, as in K1: each bilinear
// tap is one coalesced row of the (H, W, C) map and, in this orientation,
// each output row is one coalesced store, so K5's shared-memory transpose
// falls away.  Offsets are 64-bit.

#include "common.cuh"

namespace {
template <typename TF, typename TO>
__global__ void sample_views_kernel(const TF* __restrict__ feats,
                                    const float* __restrict__ m,
                                    TO* __restrict__ out, int BV, int H, int W,
                                    int C, int S, float sx, float sy) {
  const int lane = threadIdx.x & 31;
  const int64_t N = static_cast<int64_t>(S) * S * S;
  const int64_t total = static_cast<int64_t>(BV) * N;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t t = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       t < total; t += nwarps) {
    const int bv = static_cast<int>(t / N);
    const LtkTaps tp = ltk_voxel_taps(m + bv * 12, t % N, S, H, W, sx, sy);
    const TF* fb = feats + static_cast<int64_t>(bv) * H * W * C;
    for (int c = lane; c < C; c += 32)
      ltk_st(out + t * C + c, ltk_bilinear(tp, fb + c, C));
  }
}

template <typename TF, typename TO>
void sample_views_launch(const void* feats, const float* m, void* out, int BV,
                         int H, int W, int C, int S, float sx, float sy,
                         cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(BV) * S * S * S;
  const int threads = 256;
  sample_views_kernel<TF, TO>
      <<<ltk_blocks(total, threads / 32, 132 * 64), threads, 0, s>>>(
          static_cast<const TF*>(feats), m, static_cast<TO*>(out), BV, H, W, C,
          S, sx, sy);
}
}  // namespace

extern "C" int sample_views(const void* feats, const float* m, void* out,
                            int BV, int H, int W, int C, int S, float sx,
                            float sy, int in_dtype, int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return kLtkBadDtype;
  const int key = in_dtype * 2 + out_dtype;
  if (key == 0)
    sample_views_launch<float, float>(feats, m, out, BV, H, W, C, S, sx, sy, s);
  else if (key == 1)
    sample_views_launch<float, __nv_bfloat16>(feats, m, out, BV, H, W, C, S,
                                              sx, sy, s);
  else if (key == 2)
    sample_views_launch<__nv_bfloat16, float>(feats, m, out, BV, H, W, C, S,
                                              sx, sy, s);
  else
    sample_views_launch<__nv_bfloat16, __nv_bfloat16>(feats, m, out, BV, H, W,
                                                      C, S, sx, sy, s);
  return static_cast<int>(cudaGetLastError());
}
