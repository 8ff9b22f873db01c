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
// What stands between the kernel and that bound is the projection and the
// atomics: 4 taps x 32 channels a voxel, about 2 900 voxels on each pixel
// of a view at the flagship shapes.
//
// Design: K1's brick (sample_brick.cuh): a block per 4 x 8 x 8 brick of
// voxels of one view and chunk of 32 channels (K5's 2 x 4 x 32 brick
// measured slower here: its boxes span more pixels; PERF.md); each voxel
// projected once, by one thread.  The block loads its gradient tile with
// lanes over voxels (4 z-runs of 8 voxels, 4 whole sectors a warp
// instruction, streaming loads: g is read once) into a [channel][voxel]
// tile.  Where the brick's
// box of taps in the map fits the plan's budget, the block pre-reduces the
// brick's taps in shared memory before any global atomic: a counting sort
// puts the brick's (voxel, tap) pairs in order of their pixel in the box
// (a count a pixel with integer shared-memory atomics, whose returns rank
// the taps; a block-wide scan; each tap written to its place), then each
// warp takes whole pixels, its lanes over channels, sums the pixel's taps'
// weighted gradients in a register and adds the sum to dF with one global
// atomicAdd per (pixel, channel) where it is not 0: a median of 90 pixels
// of a view (PERF.md) take the 1 024 taps of a brick.  (A float atomicAdd
// in shared memory is a compare-and-swap loop on sm_90, ATOMS.CAST.SPIN:
// a window of float sums built with it measured slower than this sort.)
// A brick whose box exceeds the budget adds its taps to dF directly, 32
// neighbouring floats an instruction.  Voxels whose gradient is exactly 0
// (masked views) issue no atomics.
//
// Nondeterminism: many voxels land on one pixel; the taps of a pixel are
// summed in the order the counting sort placed them and the bricks' sums
// reach dF by atomicAdd, both in an order that changes from run to run, so
// dF varies in its last bits between runs.

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

// Exclusive prefix sums of a[0..n) in place and the total in a[n], by all
// threads of the block; wsum holds kNW ints.
__device__ __forceinline__ void block_scan(int* a, int n, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kNT - 1) / kNT;
  const int b0 = min(n, tid * per), b1 = min(n, b0 + per);
  int own = 0;
  for (int i = b0; i < b1; ++i) own += a[i];
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int i = b0; i < b1; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  if (tid == kNT - 1) a[n] = run;
}

__global__ void __launch_bounds__(kNT)
sample_views_grad_t_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, p.window, true);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  const int64_t N = static_cast<int64_t>(p.S) * p.S * p.S;
  int gx, gy, gz;
  const bool mine = brick_voxel<K6Brick>(p, tid, gx, gy, gz);
  const float* gs = p.src + (static_cast<int64_t>(bv) * p.C + c0) * N +
                    (gx * p.S + gy) * p.S + gz;
  for (int c = 0; c < CH; ++c)
    sm.tile[c * kPitch + tid] = mine ? __ldcs(gs + c * N) : 0.f;
  const Box box = brick_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz, true);
  float* map = p.dst + static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
  const int npix = box.ww * box.wh;
  int* cnt = reinterpret_cast<int*>(sm.win);  // [npix + 1]
  // [4 * kNT]: voxel * 4 + tap, in order of pixel
  unsigned short* sorted =
      reinterpret_cast<unsigned short*>(cnt + count_slots(p.window));
  if (box.fits)
    for (int e = tid; e <= npix; e += kNT) cnt[e] = 0;
  __syncthreads();

  if (!box.fits) {
    // Direct: warp w takes voxels w, w + 8, ..., lane = channel.
    if (lane >= CH) return;
    for (int j = warp; j < kNT; j += kNW) {
      const float gv = sm.tile[lane * kPitch + j];
      if (gv == 0.f) continue;
      const int4 o4 = sm.toff[j];
      const float4 w4 = sm.twt[j];
      const int o[4] = {o4.x, o4.y, o4.z, o4.w};
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (o[k] >= 0) atomicAdd(map + o[k] + lane, wk[k] * gv);
    }
    return;
  }

  // The counting sort of the brick's taps by pixel (offset / kChunk).
  const int4 o4 = sm.toff[tid];
  const int pix[4] = {o4.x >> 5, o4.y >> 5, o4.z >> 5, o4.w >> 5};
  static_assert(kChunk == 32, "pixel = window offset >> 5");
  int rank[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    rank[k] = pix[k] >= 0 ? atomicAdd(cnt + pix[k], 1) : 0;
  __syncthreads();
  block_scan(cnt, npix, reinterpret_cast<int*>(sm.red));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (pix[k] >= 0)
      sorted[cnt[pix[k]] + rank[k]] = static_cast<unsigned short>(tid * 4 + k);
  __syncthreads();

  // Each warp sums whole pixels, lanes over channels.
  if (lane >= CH) return;
  const float* wt = reinterpret_cast<const float*>(sm.twt);  // [voxel * 4 + k]
  const float* row = sm.tile + lane * kPitch;
  for (int q = warp; q < npix; q += kNW) {
    float sum = 0.f;
    const int e1 = cnt[q + 1];
    for (int e = cnt[q]; e < e1; ++e) {
      const int t = sorted[e];
      sum = __fmaf_rn(wt[t], row[t >> 2], sum);
    }
    if (sum != 0.f) {
      const int py = q / box.ww, px = q - py * box.ww;
      atomicAdd(map + ((box.y0 + py) * p.W + box.x0 + px) * p.C + lane, sum);
    }
  }
}

}  // namespace

// g (BV, C, S^3), m (BV, 3, 4) and dF (BV, H, W, C, zeroed) float32.
// window (the pre-reduction's budget in pixels, 0 for none), smem, grid (4 x
// 8 x 8 bricks) and chunks (of 32 channels: grid z) are the launch plan
// (sample.sample_plan); a plan that does not fit the shapes is refused with
// cudaErrorInvalidValue before anything runs.
extern "C" int sample_views_grad_t(const float* g, const float* m, float* df,
                                   int BV, int H, int W, int C, int S,
                                   float sx, float sy, int window, int smem,
                                   int grid, int chunks, void* stream) {
  const int bad = plan_error<K6Brick>(BV, H, W, C, S, window, smem, grid,
                                      chunks, true);
  if (bad) return bad;
  const Args a = make_args<K6Brick>(g, m, df, H, W, C, S, sx, sy, window);
  static bool allowed[64] = {};
  const int e = ltk_async::allow_smem(sample_views_grad_t_kernel, kSmemMax,
                                      allowed);
  if (e != 0) return e;
  sample_views_grad_t_kernel<<<dim3(grid, BV, chunks), kNT, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
