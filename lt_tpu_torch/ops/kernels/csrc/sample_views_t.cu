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
// (1.2 MB per view at 96 x 96 x 32) stay in the 50 MB L2.  What stands
// between the kernel and that bound is, as in K1, the projection (12 FMAs,
// two divisions, floors and tests a voxel and view) and the taps.
//
// Design (sample_brick.cuh): a block per 2 x 4 x 32 brick of voxels of one
// view and chunk of 32 channels (K1's 4 x 8 x 8 brick measured slower here:
// its z-runs of 8 voxels are 32-byte pieces of the output's rows; PERF.md);
// each voxel projected once, by one thread, its taps read from device
// memory (through L1: staging the brick's window in shared memory measured
// slower, here and in K7; PERF.md).  Threads then take (voxel, group of 4
// channels) items, 8 threads a voxel: 16-byte reads of each tap, summed
// k = 0..3 by sample_brick.cuh's gather4 (the sum K1 and K7 take, bit for
// bit), into the [channel][voxel] tile.  Then each thread stores its
// voxel's channels: a warp writes one z-run of 32 voxels of one channel, a
// whole 128-byte row an instruction, with streaming stores (st.global.cs)
// so that the output does not evict the feature maps from the L2.  C not a
// multiple of 4, or misaligned features, take element-by-element reads.

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

__global__ void __launch_bounds__(kNT)
sample_views_t_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, 0, kTile);
  const int tid = threadIdx.x;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  int gx, gy, gz;
  const bool mine = brick_voxel<K5Brick>(p, tid, gx, gy, gz);
  map_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz);
  const float* map = static_cast<const float*>(p.src) +
                     static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
  __syncthreads();

  // Items: channels cc..cc+3 of voxels it * 32 + (tid >> 3).  Within a warp
  // the tile writes (channel rows 4i + g, 4 voxels) hit 32 banks.
  const int cc = (tid & 7) * 4;
  if (cc < CH) {
#pragma unroll
    for (int it = 0; it < kNT / 32; ++it) {
      const int j = it * 32 + (tid >> 3);
      float val[4];
      gather4(map, sm, j, cc, CH, p.vec != 0, val);
#pragma unroll
      for (int g = 0; g < 4; ++g) sm.tile[(cc + g) * kPitch + j] = val[g];
    }
  }
  __syncthreads();

  if (!mine) return;
  const int64_t N = static_cast<int64_t>(p.S) * p.S * p.S;
  float* o = static_cast<float*>(p.dst) +
             (static_cast<int64_t>(bv) * p.C + c0) * N +
             (gx * p.S + gy) * p.S + gz;
  for (int c = 0; c < CH; ++c) __stcs(o + c * N, sm.tile[c * kPitch + tid]);
}

}  // namespace

// features (BV, H, W, C), m (BV, 3, 4) and out (BV, C, S^3) float32.
// smem, grid (2 x 4 x 32 bricks) and chunks (of 32 channels: grid z) are
// the launch plan (sample.sample_plan); a plan that does not fit the shapes
// is refused with cudaErrorInvalidValue before anything runs.
extern "C" int sample_views_t(const float* feats, const float* m, float* out,
                              int BV, int H, int W, int C, int S, float sx,
                              float sy, int smem, int grid, int chunks,
                              void* stream) {
  const int bad =
      plan_error<K5Brick>(BV, H, W, C, S, 0, smem, grid, chunks, kTile);
  if (bad) return bad;
  Args a = make_args<K5Brick>(feats, m, out, H, W, C, S, sx, sy, 0);
  a.vec = C % 4 == 0 && ltk_async::aligned16(feats);
  sample_views_t_kernel<<<dim3(grid, BV, chunks), kNT, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
