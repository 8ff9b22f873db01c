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
// (the TPU kernel's out_dtype); m and all arithmetic are float32: bfloat16
// features are widened as they are read, a bfloat16 output is rounded once
// (to nearest even) as it is stored.
//
// Bound on the card: bytes.  The output (BV * S^3 * C elements, 671 MB in
// float32 at 20 x 64^3 x 32) is written once; the features (1.2 MB per view
// at 96 x 96 x 32) stay in the 50 MB L2.
//
// Design: K5's (sample_brick.cuh), on K1's 4 x 8 x 8 brick as K6 and K8
// (K5's 2 x 4 x 32 measured up to 6 % slower here on an H100 80GB HBM3 at
// 700 W; PERF.md): a block per brick of one view and chunk of 32
// channels, each voxel projected once, by one thread, its taps to shared
// memory as offsets into the map.  Warp w then
// samples the 32 voxels its own lanes projected (so a __syncwarp orders the
// taps, and no block barrier is needed), 8 lanes a voxel and 4 channels a
// lane: each tap read in one 16-byte (float32) or 8-byte (bfloat16) load,
// summed k = 0..3 by gather4 as K5 sums it (float32 -> float32 is K5's
// output transposed, bit for bit), and stored straight from registers with
// a streaming store (st.global.cs, so that the output does not evict the
// maps from the L2).  A voxel's output row is C contiguous elements and a
// warp's 4 voxels of an instruction are consecutive in z, so each store
// instruction writes 512 contiguous bytes in float32 (256 in bfloat16) at
// C = 32: there is no transpose tile.  Staging the brick's window in shared
// memory (in the features' own type) measured slower (PERF.md).  C not a
// multiple of 4, or misaligned features, take element-by-element reads
// (and, for C % 4 != 0, stores).

#include "sample_brick.cuh"

namespace {

using namespace ltk_brick;

// Four channels to the output row: one 16- or 8-byte streaming store where
// vst, else the first n element by element.
__device__ __forceinline__ void st4(float* o, const float (&v)[4], int n,
                                    bool vst) {
  if (vst) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g < n) __stcs(o + g, v[g]);
  }
}

__device__ __forceinline__ void st4(__nv_bfloat16* o, const float (&v)[4],
                                    int n, bool vst) {
  if (vst) {
    unsigned short b[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      b[g] = __bfloat16_as_ushort(__float2bfloat16_rn(v[g]));
    __stcs(reinterpret_cast<uint2*>(o),
           make_uint2(b[0] | static_cast<unsigned>(b[1]) << 16,
                      b[2] | static_cast<unsigned>(b[3]) << 16));
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g < n) ltk_st(o + g, v[g]);
  }
}

template <typename TF, typename TO>
__global__ void __launch_bounds__(kNT) sample_views_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, 0, kTaps);
  const int tid = threadIdx.x, lane = tid & 31;
  const int bv = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  int gx, gy, gz;
  const bool mine = brick_voxel<K6Brick>(p, tid, gx, gy, gz);
  map_taps(p, sm, p.m + bv * 12, mine, gx, gy, gz);
  __syncwarp();

  const int cc = (lane & 7) * 4;
  if (cc >= CH) return;
  const TF* map = static_cast<const TF*>(p.src) +
                  static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
  TO* out = static_cast<TO*>(p.dst) +
            static_cast<int64_t>(bv) * p.S * p.S * p.S * p.C + c0 + cc;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int j = (tid & ~31) + it * 4 + (lane >> 3);
    int x, y, z;
    if (!brick_voxel<K6Brick>(p, j, x, y, z)) continue;
    float val[4];
    gather4(map, sm, j, cc, CH, p.vec != 0, val);
    st4(out + static_cast<int64_t>((x * p.S + y) * p.S + z) * p.C, val,
        CH - cc, p.vst != 0);
  }
}

template <typename TF, typename TO>
int launch(const Args& a, int BV, int smem, int grid, int chunks,
           cudaStream_t s) {
  Args b = a;
  b.vec = a.C % 4 == 0 &&
          reinterpret_cast<uintptr_t>(a.src) % (4 * sizeof(TF)) == 0;
  b.vst = a.C % 4 == 0 &&
          reinterpret_cast<uintptr_t>(a.dst) % (4 * sizeof(TO)) == 0;
  sample_views_kernel<TF, TO><<<dim3(grid, BV, chunks), kNT, smem, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features (BV, H, W, C) of in_dtype, m (BV, 3, 4) float32 and out (BV,
// S^3, C) of out_dtype (kLtkF32 or kLtkBF16).  smem, grid (4 x 8 x 8
// bricks) and chunks (of 32 channels: grid z) are the launch plan
// (sample.sample_plan); a plan that does not fit the shapes is refused with
// cudaErrorInvalidValue before anything runs.
extern "C" int sample_views(const void* feats, const float* m, void* out,
                            int BV, int H, int W, int C, int S, float sx,
                            float sy, int in_dtype, int out_dtype, int smem,
                            int grid, int chunks, void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return kLtkBadDtype;
  const int bad =
      plan_error<K6Brick>(BV, H, W, C, S, 0, smem, grid, chunks, kTaps);
  if (bad) return bad;
  const Args a = make_args<K6Brick>(feats, m, out, H, W, C, S, sx, sy, 0);
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
