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
// each voxel projected once, by one thread.  Where the plan stages windows
// and the brick's box fits the budget, the box's pixels (32 channels each)
// are copied into shared memory with 16-byte cp.async and the taps read
// from there; else from device memory (through L1) at the same offsets'
// map counterparts.  Threads then take (voxel, group of 4 channels) items,
// 8 threads a voxel: 16-byte reads of each tap, summed k = 0..3 with
// ltk_tap as ltk_bilinear sums them (a tap off the map reads pixel 0 of
// the window or map and its term is dropped by a select, not a branch: the
// result is K1's 'sum' of the view and K7's, bit for bit, whatever the
// features hold), into the [channel][voxel] tile.  Then each thread stores
// its voxel's channels: a warp writes one z-run of 32 voxels of one
// channel, a whole 128-byte row an instruction, with streaming stores
// (st.global.cs) so that the output does not evict the feature maps from
// the L2.  C not a multiple of 4, or misaligned features, take
// element-by-element reads from device memory.

#include "sample_brick.cuh"

namespace {

using namespace ltk_async;
using namespace ltk_brick;

__global__ void __launch_bounds__(kNT)
sample_views_t_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, p.window, false);
  const int tid = threadIdx.x;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  int gx, gy, gz;
  const bool mine = brick_voxel<K5Brick>(p, tid, gx, gy, gz);
  const Box box =
      brick_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz, p.vec != 0);
  const float* map = p.src + static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
  if (box.fits) {
    const unsigned dst = smem_u32(sm.win);
    const int q = CH / 4;  // 16-byte pieces of one pixel
    const int n = box.ww * box.wh * q;
    for (int e = tid; e < n; e += kNT) {
      const int pix = e / q, piece = e - pix * q;
      const int py = pix / box.ww, px = pix - py * box.ww;
      cp_async16(dst + static_cast<unsigned>((pix * kChunk + piece * 4) * 4),
                 map + ((box.y0 + py) * p.W + box.x0 + px) * p.C + piece * 4,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // Items: channels cc..cc+3 of voxels it * 32 + (tid >> 3).  Within a warp
  // the tile writes (channel rows 4i + g, 4 voxels) hit 32 banks.
  const int cc = (tid & 7) * 4;
  auto gather = [&](const float* __restrict__ base) {
#pragma unroll
    for (int it = 0; it < kNT / 32; ++it) {
      const int j = it * 32 + (tid >> 3);
      const int4 o4 = sm.toff[j];
      const float4 w4 = sm.twt[j];
      const int o[4] = {o4.x, o4.y, o4.z, o4.w};
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
      float val[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = o[k] >= 0;
        const float* q = base + (in ? o[k] : 0) + cc;
        if (p.vec) {
          const float4 f4 = *reinterpret_cast<const float4*>(q);
          const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
          for (int g = 0; g < 4; ++g)
            val[g] = in ? ltk_tap(val[g], wk[k], f[g]) : val[g];
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (cc + g < CH)
              val[g] = in ? ltk_tap(val[g], wk[k], q[g]) : val[g];
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) sm.tile[(cc + g) * kPitch + j] = val[g];
    }
  };
  if (cc < CH) {
    if (box.fits)
      gather(sm.win);
    else
      gather(map);
  }
  __syncthreads();

  if (!mine) return;
  const int64_t N = static_cast<int64_t>(p.S) * p.S * p.S;
  float* o = p.dst + (static_cast<int64_t>(bv) * p.C + c0) * N +
             (gx * p.S + gy) * p.S + gz;
  for (int c = 0; c < CH; ++c) __stcs(o + c * N, sm.tile[c * kPitch + tid]);
}

}  // namespace

// features (BV, H, W, C), m (BV, 3, 4) and out (BV, C, S^3) float32.
// window (pixels of a staged window, 0 for none), smem, grid (2 x 4 x 32
// bricks) and chunks (of 32 channels: grid z) are the launch plan
// (sample.sample_plan); a plan that does not fit the shapes is refused with
// cudaErrorInvalidValue before anything runs.
extern "C" int sample_views_t(const float* feats, const float* m, float* out,
                              int BV, int H, int W, int C, int S, float sx,
                              float sy, int window, int smem, int grid,
                              int chunks, void* stream) {
  const int bad = plan_error<K5Brick>(BV, H, W, C, S, window, smem, grid,
                                      chunks, false);
  if (bad) return bad;
  Args a = make_args<K5Brick>(feats, m, out, H, W, C, S, sx, sy, window);
  a.vec = C % 4 == 0 && aligned16(feats);
  static bool allowed[64] = {};
  const int e = allow_smem(sample_views_t_kernel, kSmemMax, allowed);
  if (e != 0) return e;
  sample_views_t_kernel<<<dim3(grid, BV, chunks), kNT, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
