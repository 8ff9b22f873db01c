// K5: per-view bilinear sampling of an affine voxel grid, channels-major.
//
// For every (bv, n) with voxel n = (gx*S + gy)*S + gz of an S^3 grid:
//   out[bv, c, n] = bilinear sample of features[bv] (H, W, C) at the pixel
//                   that m[bv] (3x4, grid index -> homogeneous heatmap pixel)
//                   projects voxel n to; 0 where w <= 0 or a tap is outside
//                   the map (align_corners=True, zero padding).
// The taps come from common.cuh's ltk_voxel_taps, the function K1 and K6
// use, so the training backward recomputes the samples that K1 aggregated.
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_fwd_impl_t
// (pallas_call :653; kernel body _unproject_kernel_t :589).  Its column
// bands, subtiles and F^T relayout are TPU schedule and are left behind.
//
// Bound on the card: bytes.  The output (BV * C * S^3 floats, 671 MB at the
// flagship training shapes 20 x 32 x 64^3) is written once; the features
// (1.2 MB per view at 96 x 96 x 32) stay in the 50 MB L2.
//
// Design: a block owns a tile of 32 consecutive voxels of one view.  Each
// warp gathers whole voxels with its lanes over channels (one coalesced
// 128-byte row per tap, as in K1) into a shared-memory tile, then each warp
// stores whole channels with its lanes over voxels (one coalesced 128-byte
// row per channel).  The tile's padding column keeps both passes free of
// bank conflicts.  Offsets are 64-bit.

#include "common.cuh"

namespace {
constexpr int kTileN = 32;  // voxels per tile; one warp-wide row of output

__global__ void sample_views_t_kernel(const float* __restrict__ feats,
                                      const float* __restrict__ m,
                                      float* __restrict__ out, int BV, int H,
                                      int W, int C, int S, float sx,
                                      float sy) {
  __shared__ float tile[32][kTileN + 1];  // [channel in chunk][voxel]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t N = static_cast<int64_t>(S) * S * S;
  const int64_t tiles = (N + kTileN - 1) / kTileN;
  for (int64_t tid = blockIdx.x; tid < BV * tiles; tid += gridDim.x) {
    const int bv = static_cast<int>(tid / tiles);
    const int64_t n0 = (tid % tiles) * kTileN;
    const float* fb = feats + static_cast<int64_t>(bv) * H * W * C;
    for (int c0 = 0; c0 < C; c0 += 32) {
      for (int j = warp; j < kTileN; j += nwarps) {
        const int64_t n = n0 + j;
        float val = 0.f;
        if (n < N && c0 + lane < C) {
          const LtkTaps tp = ltk_voxel_taps(m + bv * 12, n, S, H, W, sx, sy);
          val = ltk_bilinear(tp, fb + c0 + lane, C);
        }
        tile[lane][j] = val;
      }
      __syncthreads();
      for (int cc = warp; cc < 32; cc += nwarps) {
        const int c = c0 + cc;
        const int64_t n = n0 + lane;
        if (c < C && n < N)
          out[(static_cast<int64_t>(bv) * C + c) * N + n] = tile[cc][lane];
      }
      __syncthreads();
    }
  }
}
}  // namespace

extern "C" int sample_views_t(const float* feats, const float* m, float* out,
                              int BV, int H, int W, int C, int S, float sx,
                              float sy, void* stream) {
  const int64_t tiles =
      static_cast<int64_t>(BV) * ((static_cast<int64_t>(S) * S * S + kTileN - 1) / kTileN);
  sample_views_t_kernel<<<ltk_blocks(tiles, 1, 132 * 32), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      feats, m, out, BV, H, W, C, S, sx, sy);
  return static_cast<int>(cudaGetLastError());
}
