// K6: the feature gradient of K5, a bilinear scatter.
//
//   dF[bv, y, x, c] = sum over voxels n of g[bv, c, n] * (the bilinear weight
//                     of tap (y, x) in voxel n's sample)
// over the voxels of a slab of the S^3 grid, its X planes [ox, ox + nx) (g
// holds the slab's rows; ox = 0, nx = S: the whole grid).  The slabs' dF
// sum to the whole grid's.
// with voxels at w <= 0 and taps outside the map contributing nothing
// (but a tap off the map of a voxel in front of the camera adds 0 * g at
// its clamped pixel where g is not finite: sample_brick.cuh's
// edge_taps).  The taps come from common.cuh's ltk_voxel_taps, as in K1
// and K5.  dF must be zeroed by the caller.  g is float32 or bfloat16 (in
// lt_tpu's training backward, the cotangent of K5's bfloat16 samples),
// widened as it is read; dF, the weights and the products are float32: the
// function is computed exactly, where the TPU kernel rounded the weights
// and the product to bfloat16 (unproject.py:961, :970).
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_grad_features_t
// (pallas_call :1029; kernel body _unproject_bwd_kernel_t :921).
//
// Bound on the card: bytes.  g (BV * C * S^3 elements, 671 MB in float32 at
// the flagship training shapes) is read once; dF (1.2 MB per view) stays in
// the L2.
// What stands between the kernel and that bound is the projection and the
// atomics: 4 taps x 32 channels a voxel, about 2 900 voxels on each pixel
// of a view at the flagship shapes.
//
// Design: K1's brick (sample_brick.cuh): a block per 4 x 8 x 8 brick of
// voxels of one view and chunk of 32 channels (K5's 2 x 4 x 32 brick
// measured slower here: its boxes span more pixels; PERF.md); each voxel
// projected once, by one thread.  The block loads its gradient tile with
// lanes over voxels (4 z-runs of 8 voxels, 4 whole sectors a warp
// instruction in float32, 2 in bfloat16, streaming loads: g is read once)
// into a float [channel][voxel] tile; then sample_brick.cuh's
// brick_scatter, shared with K8, pre-reduces the brick's taps in shared
// memory where its box of taps fits the plan's budget (a counting sort by
// pixel, per-pixel sums, one global atomicAdd per (pixel, channel)) and
// adds them to dF directly where it does not: a median of 90 pixels of a
// view (PERF.md) take the 1 024 taps of a brick.
//
// Nondeterminism: many voxels land on one pixel; the taps of a pixel are
// summed in the order the counting sort placed them and the bricks' sums
// reach dF by atomicAdd, both in an order that changes from run to run, so
// dF varies in its last bits between runs.

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

// One element of g, a streaming load, widened to float32.
__device__ __forceinline__ float ldcs1(const float* q) { return __ldcs(q); }

__device__ __forceinline__ float ldcs1(const __nv_bfloat16* q) {
  const unsigned short u = __ldcs(reinterpret_cast<const unsigned short*>(q));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

template <typename TG>
__global__ void __launch_bounds__(kNT)
sample_views_grad_t_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, p.window, kScatter);
  const int tid = threadIdx.x;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  const int64_t N = static_cast<int64_t>(p.nx) * p.S * p.S;
  int gx, gy, gz;
  const bool mine = brick_voxel<K6Brick>(p, tid, gx, gy, gz);
  const TG* gs = static_cast<const TG*>(p.src) +
                 (static_cast<int64_t>(bv) * p.C + c0) * N +
                 (gx * p.S + gy) * p.S + gz;
  float nan_if_bad = 0.f;  // NaN where a loaded (widened) g is not finite
  for (int c = 0; c < CH; ++c) {
    const float g = mine ? ldcs1(gs + c * N) : 0.f;
    nan_if_bad = __fmaf_rn(g, 0.f, nan_if_bad);
    sm.tile[c * kPitch + tid] = g;
  }
  const Box box =
      brick_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz);
  if (isnan(nan_if_bad))
    edge_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz, bv, c0, CH);
  brick_scatter(p, sm, box, bv, c0, CH);
}

template <typename TG>
int launch(const Args& a, int BV, int smem, int grid, int chunks,
           cudaStream_t s) {
  static bool allowed[64] = {};
  const int e = ltk_async::allow_smem(sample_views_grad_t_kernel<TG>,
                                      kSmemMax, allowed);
  if (e != 0) return e;
  sample_views_grad_t_kernel<TG><<<dim3(grid, BV, chunks), kNT, smem, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (BV, C, nx * S^2) of g_dtype (kLtkF32 or kLtkBF16), m (BV, 3, 4) and dF
// (BV, H, W, C, zeroed) float32.  window (the pre-reduction's budget in
// pixels, 0 for none), smem, grid (4 x 8 x 8 bricks of the slab) and chunks
// (of 32 channels: grid z) are the launch plan (sample.sample_plan); ox, nx
// the slab (X planes [ox, ox + nx) of the S^3 grid, gx of g counted from
// ox; 0, S for the whole grid).  A plan that does not fit the shapes, or a
// slab outside the grid, is refused with cudaErrorInvalidValue before
// anything runs.
extern "C" int sample_views_grad_t(const void* g, const float* m, float* df,
                                   int BV, int H, int W, int C, int S,
                                   float sx, float sy, int g_dtype,
                                   int window, int smem, int grid, int chunks,
                                   int ox, int nx, void* stream) {
  if (g_dtype != kLtkF32 && g_dtype != kLtkBF16) return kLtkBadDtype;
  const int bad = plan_error<K6Brick>(BV, H, W, C, S, window, smem, grid,
                                      chunks, kScatter, ox, nx);
  if (bad) return bad;
  const Args a =
      make_args<K6Brick>(g, m, df, H, W, C, S, sx, sy, window, ox, nx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_dtype == kLtkF32
             ? launch<float>(a, BV, smem, grid, chunks, s)
             : launch<__nv_bfloat16>(a, BV, smem, grid, chunks, s);
}
