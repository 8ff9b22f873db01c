// K5: per-view bilinear sampling of an affine voxel grid, channels-major.
//
// For every (bv, n) with voxel n = (gx*S + gy)*S + gz of a slab of an S^3
// grid, its X planes [ox, ox + nx) (the whole grid: ox = 0, nx = S; gx
// counts from ox):
//   out[bv, c, n] = bilinear sample of features[bv] (H, W, C) at the pixel
//                   that m[bv] (3x4, grid index -> homogeneous heatmap pixel)
//                   projects voxel (ox + gx, gy, gz) to; 0 where w <= 0 or a
//                   tap is outside the map (align_corners=True, zero
//                   padding).
// A slab's rows are the whole grid's rows [ox * S^2, (ox + nx) * S^2) bit
// for bit (volume-axis sharding's training backward, parallel/spatial.py).
// The taps come from common.cuh's ltk_voxel_taps, the function K1 and K6
// use, so the training backward recomputes the samples that K1 aggregated.
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_fwd_impl_t
// (pallas_call :653; kernel body _unproject_kernel_t :589).  Its column
// bands, subtiles and F^T relayout are TPU schedule and are left behind.
//
// The features are float32 or bfloat16, the output float32 or bfloat16
// (the TPU kernel's out_dtype; lt_tpu's training backward recomputes its
// samples bfloat16 -> bfloat16); m and all arithmetic are float32:
// bfloat16 features are widened as they are read, a bfloat16 output is
// rounded once (to nearest even) as it is stored.
//
// Bound on the card: bytes.  The output (BV * C * S^3 elements, 671 MB in
// float32 at the flagship training shapes 20 x 32 x 64^3) is written once;
// the features (1.2 MB per view at 96 x 96 x 32 in float32) stay in the
// 50 MB L2.  What stands between the kernel and that bound is, as in K1,
// the projection (12 FMAs, two divisions, floors and tests a voxel and
// view) and the taps.
//
// Design (sample_brick.cuh): a block per 2 x 4 x 32 brick of voxels of one
// view and chunk of 32 channels (K1's 4 x 8 x 8 brick measured slower here:
// its z-runs of 8 voxels are 32-byte pieces of the output's rows; PERF.md);
// each voxel projected once, by one thread, its taps read from device
// memory (through L1: staging the brick's window in shared memory measured
// slower, here and in K7; PERF.md).  Threads then take (voxel, group of 4
// channels) items, 8 threads a voxel: 16-byte (float32) or 8-byte
// (bfloat16) reads of each tap, summed k = 0..3 by sample_brick.cuh's
// gather4 (the sum K1 and K7 take, bit for bit), into the float
// [channel][voxel] tile.  Then each thread stores its voxel's channels: a
// warp writes one z-run of 32 voxels of one channel, a whole 128-byte row
// an instruction in float32 (64 bytes in bfloat16), with streaming stores
// (st.global.cs) so that the output does not evict the feature maps from
// the L2.  C not a multiple of 4, or misaligned features, take
// element-by-element reads.

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

// One output element, a streaming store; bfloat16 rounded once.
__device__ __forceinline__ void stcs1(float* o, float v) { __stcs(o, v); }

__device__ __forceinline__ void stcs1(__nv_bfloat16* o, float v) {
  __stcs(reinterpret_cast<unsigned short*>(o),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <typename TF, typename TO>
__global__ void __launch_bounds__(kNT) sample_views_t_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, 0, kTile);
  const int tid = threadIdx.x;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  int gx, gy, gz;
  const bool mine = brick_voxel<K5Brick>(p, tid, gx, gy, gz);
  map_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz);
  const TF* map = static_cast<const TF*>(p.src) +
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
  const int64_t N = static_cast<int64_t>(p.nx) * p.S * p.S;
  TO* o = static_cast<TO*>(p.dst) +
          (static_cast<int64_t>(bv) * p.C + c0) * N +
          (gx * p.S + gy) * p.S + gz;
  for (int c = 0; c < CH; ++c) stcs1(o + c * N, sm.tile[c * kPitch + tid]);
}

template <typename TF, typename TO>
int launch(const Args& a, int BV, int smem, int grid, int chunks,
           cudaStream_t s) {
  Args b = a;
  b.vec = a.C % 4 == 0 &&
          reinterpret_cast<uintptr_t>(a.src) % (4 * sizeof(TF)) == 0;
  sample_views_t_kernel<TF, TO><<<dim3(grid, BV, chunks), kNT, smem, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features (BV, H, W, C) of in_dtype, m (BV, 3, 4) float32 and out (BV, C,
// nx * S^2) of out_dtype (kLtkF32 or kLtkBF16).  smem, grid (2 x 4 x 32
// bricks of the slab) and chunks (of 32 channels: grid z) are the launch
// plan (sample.sample_plan); ox, nx the slab (X planes [ox, ox + nx) of the
// S^3 grid, gx of out counted from ox; 0, S for the whole grid).  A plan
// that does not fit the shapes, or a slab outside the grid, is refused
// with cudaErrorInvalidValue before anything runs.
extern "C" int sample_views_t(const void* feats, const float* m, void* out,
                              int BV, int H, int W, int C, int S, float sx,
                              float sy, int in_dtype, int out_dtype, int smem,
                              int grid, int chunks, int ox, int nx,
                              void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return kLtkBadDtype;
  const int bad = plan_error<K5Brick>(BV, H, W, C, S, 0, smem, grid, chunks,
                                      kTile, ox, nx);
  if (bad) return bad;
  const Args a =
      make_args<K5Brick>(feats, m, out, H, W, C, S, sx, sy, 0, ox, nx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0: return launch<float, float>(a, BV, smem, grid, chunks, s);
    case 1: return launch<float, __nv_bfloat16>(a, BV, smem, grid, chunks, s);
    case 2: return launch<__nv_bfloat16, float>(a, BV, smem, grid, chunks, s);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16>(a, BV, smem, grid, chunks,
                                                   s);
  }
}
