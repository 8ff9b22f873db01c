// K6: the feature gradient of K5, a bilinear scatter.
//
//   dF[bv, y, x, c] = sum over voxels n of g[bv, c, n] * (the bilinear weight
//                     of tap (y, x) in voxel n's sample)
// with voxels at w <= 0 and taps outside the map contributing nothing.  The
// taps come from common.cuh's ltk_voxel_taps, as in K1 and K5.  dF must be
// zeroed by the caller.  Everything is float32: the function is computed
// exactly, where the TPU kernel rounded the weights and the product to
// bfloat16 (unproject.py:961, :970).
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_grad_features_t
// (pallas_call :1029; kernel body _unproject_bwd_kernel_t :921).
//
// Bound on the card: bytes.  g (BV * C * S^3 floats, 671 MB at the flagship
// training shapes) is read once; dF (1.2 MB per view) stays in the L2.
//
// Design: a block owns a tile of 32 consecutive voxels of one view.  It
// loads the tile's gradient with its lanes over voxels (one coalesced
// 128-byte row per channel) into shared memory; then each warp takes whole
// voxels with its lanes over channels and adds the four weighted taps into
// dF with atomicAdd, 32 neighbouring floats per instruction.  Voxels whose
// gradient is exactly 0 (masked views) issue no atomics.
//
// Nondeterminism: many voxels land on one pixel (64^3 voxels on 96^2 pixels)
// and their float atomicAdds reach it in an order that changes from run to
// run, so dF varies in its last bits between runs.  The same contention
// serialises those adds in the L2; a later schedule can pre-reduce
// neighbouring voxels in shared memory first.

#include "common.cuh"

namespace {
constexpr int kTileN = 32;  // voxels per tile

__global__ void sample_views_grad_t_kernel(const float* __restrict__ g,
                                           const float* __restrict__ m,
                                           float* __restrict__ df, int BV,
                                           int H, int W, int C, int S,
                                           float sx, float sy) {
  __shared__ float tile[32][kTileN + 1];  // [channel in chunk][voxel]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t N = static_cast<int64_t>(S) * S * S;
  const int64_t tiles = (N + kTileN - 1) / kTileN;
  for (int64_t tid = blockIdx.x; tid < BV * tiles; tid += gridDim.x) {
    const int bv = static_cast<int>(tid / tiles);
    const int64_t n0 = (tid % tiles) * kTileN;
    float* db = df + static_cast<int64_t>(bv) * H * W * C;
    for (int c0 = 0; c0 < C; c0 += 32) {
      for (int cc = warp; cc < 32; cc += nwarps) {
        const int c = c0 + cc;
        const int64_t n = n0 + lane;
        tile[cc][lane] = (c < C && n < N)
                             ? g[(static_cast<int64_t>(bv) * C + c) * N + n]
                             : 0.f;
      }
      __syncthreads();
      for (int j = warp; j < kTileN; j += nwarps) {
        const int64_t n = n0 + j;
        const int c = c0 + lane;
        const float gv = tile[lane][j];
        if (n < N && c < C && gv != 0.f) {
          const LtkTaps tp = ltk_voxel_taps(m + bv * 12, n, S, H, W, sx, sy);
          for (int k = 0; k < 4; ++k)
            if (tp.in & (1u << k))
              atomicAdd(db + static_cast<int64_t>(tp.off[k]) * C + c,
                        tp.wt[k] * gv);
        }
      }
      __syncthreads();
    }
  }
}
}  // namespace

extern "C" int sample_views_grad_t(const float* g, const float* m, float* df,
                                   int BV, int H, int W, int C, int S,
                                   float sx, float sy, void* stream) {
  const int64_t tiles =
      static_cast<int64_t>(BV) * ((static_cast<int64_t>(S) * S * S + kTileN - 1) / kTileN);
  sample_views_grad_t_kernel<<<ltk_blocks(tiles, 1, 132 * 32), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      g, m, df, BV, H, W, C, S, sx, sy);
  return static_cast<int>(cudaGetLastError());
}
