// K8: the feature gradient of K7, a bilinear scatter.
//
//   dF[bv, y, x, c] = sum over voxels n of g[bv, n, c] * (the bilinear weight
//                     of tap (y, x) in voxel n's sample)
// with voxels at w <= 0 and taps outside the map contributing nothing.  The
// function of K6 (sample_views_grad_t.cu) with g's last two axes the other
// way round; the taps come from common.cuh's ltk_voxel_taps.  dF must be
// zeroed by the caller.  g is float32 or bfloat16 (widened as it is read);
// dF, the weights and the products are float32: the function is computed
// exactly, where the TPU kernel rounded the weights and g to bfloat16
// (unproject.py:876-880).
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_grad_features
// (pallas_call :906; kernel body _unproject_bwd_kernel :837).
//
// Bound on the card: bytes.  g (BV * S^3 * C elements, 671 MB in float32 at
// 20 x 64^3 x 32) is read once; dF (1.2 MB per view) stays in the L2.
//
// Design: K6's (sample_brick.cuh), on its 4 x 8 x 8 brick, grid and plan;
// only the gradient tile's load differs.  g's rows are C contiguous
// channels a voxel, so the block loads whole rows, 8 threads a voxel and 4
// channels a thread (one 16-byte load in float32, 8 bytes in bfloat16,
// streaming: g is read once): a warp's 4 voxels of an instruction are
// consecutive in z, 512 contiguous bytes in float32 at C = 32 (K6 reads
// 32-byte z-runs here).  They go into K6's [channel][voxel] tile, whose
// pitch of 257 keeps the transposed writes free of bank conflicts (bank =
// (c + j) mod 32).  Then brick_scatter, K6's body: the counting sort by
// pixel and per-pixel sums where the brick's box fits the budget, direct
// atomics where it does not, no atomics for a gradient of exactly 0.  C not
// a multiple of 4, or a misaligned g, take element-by-element loads.  As
// in K6, the order of the sums and atomics changes from run to run, so dF
// varies in its last bits between runs.

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

template <typename TG>
__global__ void __launch_bounds__(kNT) sample_views_grad_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, p.window, kScatter);
  const int tid = threadIdx.x;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  const TG* gs = static_cast<const TG*>(p.src) +
                 static_cast<int64_t>(bv) * p.S * p.S * p.S * p.C + c0;
  // Items: channels cc..cc+3 of voxels it * 32 + (tid >> 3).
  const int cc = (tid & 7) * 4;
  float nan_if_bad = 0.f;  // NaN where a loaded g is NaN or infinite
#pragma unroll
  for (int it = 0; it < kNT / 32; ++it) {
    const int j = it * 32 + (tid >> 3);
    int x, y, z;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (cc < CH && brick_voxel<K6Brick>(p, j, x, y, z))
      ld4<true>(gs + static_cast<int64_t>((x * p.S + y) * p.S + z) * p.C + cc,
                v, CH - cc, p.vec != 0);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      nan_if_bad = __fmaf_rn(v[g], 0.f, nan_if_bad);
      sm.tile[(cc + g) * kPitch + j] = v[g];
    }
  }
  int gx, gy, gz;
  const bool mine = brick_voxel<K6Brick>(p, tid, gx, gy, gz);
  const Box box =
      brick_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz);
  if (__syncthreads_or(isnan(nan_if_bad)))
    edge_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz, bv, c0, CH);
  brick_scatter(p, sm, box, bv, c0, CH);
}

template <typename TG>
int launch(const Args& a, int BV, int smem, int grid, int chunks,
           cudaStream_t s) {
  static bool allowed[64] = {};
  const int e = ltk_async::allow_smem(sample_views_grad_kernel<TG>, kSmemMax,
                                      allowed);
  if (e != 0) return e;
  Args b = a;
  b.vec = a.C % 4 == 0 &&
          reinterpret_cast<uintptr_t>(a.src) % (4 * sizeof(TG)) == 0;
  sample_views_grad_kernel<TG><<<dim3(grid, BV, chunks), kNT, smem, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (BV, S^3, C) of g_dtype (kLtkF32 or kLtkBF16), m (BV, 3, 4) and dF (BV,
// H, W, C, zeroed) float32.  window (the pre-reduction's budget in pixels, 0
// for none), smem, grid (4 x 8 x 8 bricks) and chunks (of 32 channels: grid
// z) are the launch plan (sample.sample_plan, K6's); a plan that does not
// fit the shapes is refused with cudaErrorInvalidValue before anything
// runs.
extern "C" int sample_views_grad(const void* g, const float* m, float* df,
                                 int BV, int H, int W, int C, int S, float sx,
                                 float sy, int g_dtype, int window, int smem,
                                 int grid, int chunks, void* stream) {
  if (g_dtype != kLtkF32 && g_dtype != kLtkBF16) return kLtkBadDtype;
  const int bad = plan_error<K6Brick>(BV, H, W, C, S, window, smem, grid,
                                      chunks, kScatter, 0, S);
  if (bad) return bad;
  const Args a =
      make_args<K6Brick>(g, m, df, H, W, C, S, sx, sy, window, 0, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_dtype == kLtkF32
             ? launch<float>(a, BV, smem, grid, chunks, s)
             : launch<__nv_bfloat16>(a, BV, smem, grid, chunks, s);
}
