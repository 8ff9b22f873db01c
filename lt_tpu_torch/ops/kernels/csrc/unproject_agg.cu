// K1: fused projective unprojection with cross-view aggregation.
//
// For every voxel n = (gx*S + gy)*S + gz of an S^3 grid and every view v:
//   (u, v, w) = m[b, v] @ (gx, gy, gz, 1)    (m = P @ [A; 0 0 0 1], 3x4)
//   sample    = 0 where w <= 0, else the bilinear (align_corners=True, zero
//               padding) sample of features[b, v] (H, W, C) at
//               x = u/w * (W-1)/W, y = v/w * (H-1)/H
// then aggregate over views: softmax (masked logits -1e9), sum, max (-inf ->
// 0) or conf (per-view, per-channel confidences), with view_mask removing
// views.  Output (B, S^3, C): NDHWC, channels fastest.  The features and the
// output are float32 or bfloat16 (one type for both); m, the mask, the
// confidences and all projection and aggregation arithmetic are float32,
// rounded once at the store.
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_agg_impl (pallas_call
// :427; kernel bodies _unproject_agg_kernel :177, _tile_sample_t :256).  As
// there, the (B, V, N, C) per-view samples never reach device memory.
//
// Bound on the card: bytes.  The output volume (B * S^3 * C, 268 MB in
// float32 at the flagship's 8 x 64^3 x 32) is written once; the feature
// maps (37.7 MB) are read once.  What stands between a kernel and that
// bound is the taps: each voxel reads 4 taps x 4 views of C channels, 4.3
// GB a float32 forward if every tap row comes from L2, and each voxel's
// projection (12 FMAs, two divisions, floors and tests) for each view.
//
// Design: one block per 4 x 8 x 8 brick of voxels of one sample and one
// chunk of 32 channels (the grid is (bricks, B, chunks); voxel coordinates
// come from the block and thread indices in 32-bit arithmetic).  Per view:
//   - each thread projects one voxel once (common.cuh's ltk_voxel_taps,
//     the function K5-K8 use, on float coordinates) and keeps its taps'
//     offsets and weights in shared memory;
//   - a block reduction takes the pixel bounding box of the brick's taps,
//     each clamped to the map (a tap off the map reads its clamped pixel
//     with weight 0, as lt_tpu's sampler does), of the voxels in front of
//     the camera (a voxel behind it has no taps): the box lies inside the
//     map;
//   - if the box fits the plan's window budget, the block copies those
//     pixels' 32 channels into shared memory with 16-byte cp.async, while
//     it accumulates the previous view (two window buffers, two tap
//     buffers); a view whose box does not fit reads its taps from device
//     memory at the same offsets' global counterparts.
// Threads then take (voxel, group of 4 float32 / 8 bfloat16 channels)
// items: 16-byte reads of each tap, summed k = 0..3 with common.cuh's
// ltk_tap as K5 and K7 sum them (a voxel behind the camera reads pixel 0
// of the window or map and its terms are dropped by a select, not a
// branch: a view that K1 samples alone equals K5's and K7's sample bit for
// bit, whatever the features hold), and the aggregation state (online
// softmax without a branch: running max and rescaled sums) in registers
// across the views.  A +inf logit makes its softmax NaN, as torch.softmax
// and jax.nn.softmax make it (inf - inf): the rescaled sum is then inf or
// NaN at the store, and adding its difference with itself makes it NaN.
// Output rows are 16-byte stores.  C * element size not
// a multiple of 16 bytes, or misaligned pointers, take element-by-element
// reads from device memory and element stores.  The launch plan (window
// budget, dynamic shared memory, grid) is computed in Python
// (unproject.unproject_plan, tested on the CPU) and checked here.

#include <limits.h>

#include "common.cuh"

namespace {

using namespace ltk_async;

enum Method { kSoftmax = 0, kSum = 1, kMax = 2, kConf = 3 };

constexpr int kChunk = 32;        // channels of one block (grid z)
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
// The brick: 4 (x) x 8 (y) x 8 (z) voxels, one a thread.
constexpr int kBx = 4, kBy = 8, kBz = 8, kNT = kBx * kBy * kBz;

struct AggArgs {
  const void* feats;
  const float* m;
  const float* mask;
  const float* conf;
  void* out;
  int V, H, W, C, S;
  float sx, sy;
  int nby, nbz;  // bricks along y and z
  int window;    // pixels of one staged view window
  int vec;
};

// Bytes of dynamic shared memory: two window buffers of kChunk channels a
// pixel, two tap buffers (an int4 of offsets and a float4 of weights a
// voxel) and two slots of the per-warp bounding boxes.
__host__ __device__ constexpr int agg_smem_bytes(int voxels, int window,
                                                 int elem) {
  return 2 * window * kChunk * elem + 2 * voxels * 32 + 2 * (voxels / 32) * 16;
}

__device__ __forceinline__ void ld_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[q]));
    f[2 * q] = t.x, f[2 * q + 1] = t.y;
  }
}
__device__ __forceinline__ void st_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&f)[8]) {
  unsigned u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    u[q] = *reinterpret_cast<const unsigned*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(kNT, 2)
unproject_agg_kernel(const AggArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = kNT;
  constexpr int G = 16 / sizeof(T);   // channels of one item (16 bytes)
  constexpr int IPT = kChunk / G;     // items of one thread: 32 channels
  constexpr int NW = NT / 32;
  constexpr int NS = METHOD == kSoftmax ? IPT : 1;  // softmax state
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, c0 = blockIdx.z * kChunk;
  const int CH = min(kChunk, p.C - c0);
  // Items: thread tid takes channel group cg of voxels jb + it * vstep,
  // it < nit; a voxel's groups sit on consecutive threads.
  const int ncg = (CH + G - 1) / G;
  int lg = 0;
  while ((1 << lg) < ncg) ++lg;
  const int nit = 1 << lg, vstep = NT >> lg, jb = tid >> lg;
  const int cc = (tid & (nit - 1)) * G;
  const bool active = cc < CH;
  const int64_t map = static_cast<int64_t>(p.H) * p.W * p.C;
  const int winelems = p.window * kChunk;
  T* win = reinterpret_cast<T*>(smem);
  int4* toff = reinterpret_cast<int4*>(smem + 2 * winelems * sizeof(T));
  float4* twt = reinterpret_cast<float4*>(toff + 2 * NT);
  int4* red = reinterpret_cast<int4*>(twt + 2 * NT);

  // Brick voxel j (z fastest, as n) -> grid coordinates; false outside.
  const int bzi = blockIdx.x % p.nbz;
  const int byi = (blockIdx.x / p.nbz) % p.nby;
  const int bxi = blockIdx.x / (p.nbz * p.nby);
  auto voxel = [&](int j, int& gx, int& gy, int& gz) {
    gz = bzi * kBz + j % kBz;
    gy = byi * kBy + (j / kBz) % kBy;
    gx = bxi * kBx + j / (kBz * kBy);
    return gx < p.S && gy < p.S && gz < p.S;
  };
  int gx, gy, gz;
  const bool mine = voxel(tid, gx, gy, gz);

  float acc[IPT][G], mx[NS][G], den[NS][G];
#pragma unroll
  for (int it = 0; it < IPT; ++it)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[it][g] = METHOD == kMax ? -INFINITY : 0.f;
#pragma unroll
  for (int it = 0; it < NS; ++it)
#pragma unroll
    for (int g = 0; g < G; ++g) mx[it][g] = -INFINITY, den[it][g] = 0.f;

  // Sample view u of this thread's items from `base` (its staged window
  // or its map in device memory: two copies of the loop, so that the
  // window's reads are shared-memory loads) and aggregate; `unmasked`:
  // the view's mask is set ('conf' samples a masked view too, `keep`, and
  // weighs it by 0; the other methods skip it).
  auto sample_view = [&](const T* __restrict__ base, int su, int bu,
                         bool keep, bool unmasked) {
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      // Items past nit (a chunk of fewer than 32 channels) repeat voxels
      // of this thread and are never stored.
      const int j = (it * vstep + jb) & (NT - 1);
      float val[G];
#pragma unroll
      for (int g = 0; g < G; ++g) val[g] = 0.f;
      if (keep && active) {
        const int4 o4 = toff[su * NT + j];
        const float4 w4 = twt[su * NT + j];
        const int o[4] = {o4.x, o4.y, o4.z, o4.w};
        const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // A voxel behind the camera (offset -1) reads pixel 0, and a
          // select keeps val as it was: the sample has no term for it.
          const bool in = o[k] >= 0;
          const T* q = base + (in ? o[k] : 0) + cc;
          if (p.vec) {
            float f[G];
            ld_vec(q, f);
#pragma unroll
            for (int g = 0; g < G; ++g)
              val[g] = in ? ltk_tap(val[g], wk[k], f[g]) : val[g];
          } else {
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (cc + g < CH)
                val[g] = in ? ltk_tap(val[g], wk[k], ltk_ld(q + g)) : val[g];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float& a = acc[it][g];
        if (METHOD == kSoftmax) {
          // The online softmax without a branch: one exp, of minus the
          // distance between the logit and the running max, rescales
          // whichever of the two is smaller.
          float& rm = mx[METHOD == kSoftmax ? it : 0][g];
          float& dn = den[METHOD == kSoftmax ? it : 0][g];
          const float logit = keep ? val[g] : -1e9f;
          const float contrib = keep ? val[g] : 0.f;
          const bool up = logit > rm;
          const float e = expf(-fabsf(logit - rm));
          dn = up ? dn * e + 1.f : dn + e;
          a = up ? a * e + contrib : a + e * contrib;
          rm = up ? logit : rm;
        } else if (METHOD == kSum) {
          if (keep) a += val[g];
        } else if (METHOD == kMax) {
          a = ltk_max_nan(a, keep ? val[g] : -INFINITY);
        } else if (cc + g < CH) {  // kConf
          const float w =
              p.conf[static_cast<int64_t>(bu) * p.C + c0 + cc + g];
          a += val[g] * (unmasked ? w : 0.f);
        }
      }
    }
  };

  unsigned staged = 0u;  // bit s: buffer s holds its view's window
  for (int v = 0; v <= p.V; ++v) {
    const int s = v & 1;
    if (v < p.V) {
      // View v: this thread's voxel's taps, the brick's window, its copy.
      const int bv = b * p.V + v;
      LtkTaps tp{};
      if (mine && (METHOD == kConf || p.mask[bv] > 0.f))
        tp = ltk_voxel_taps(p.m + bv * 12, static_cast<float>(gx),
                            static_cast<float>(gy), static_cast<float>(gz),
                            p.H, p.W, p.sx, p.sy);
      int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
      if (tp.front)
        x0 = tp.cx[0], x1 = tp.cx[1], y0 = tp.cy[0], y1 = tp.cy[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        x0 = min(x0, __shfl_xor_sync(~0u, x0, o));
        x1 = max(x1, __shfl_xor_sync(~0u, x1, o));
        y0 = min(y0, __shfl_xor_sync(~0u, y0, o));
        y1 = max(y1, __shfl_xor_sync(~0u, y1, o));
      }
      if (lane == 0) red[s * NW + warp] = make_int4(x0, x1, y0, y1);
      __syncthreads();
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int4 r = red[s * NW + w];
        x0 = min(x0, r.x), x1 = max(x1, r.y);
        y0 = min(y0, r.z), y1 = max(y1, r.w);
      }
      const bool any = x0 <= x1;
      const int ww = any ? x1 - x0 + 1 : 0, wh = any ? y1 - y0 + 1 : 0;
      const bool fits = p.vec && any && ww * wh <= p.window;
      staged = fits ? staged | 1u << s : staged & ~(1u << s);
      // Each tap at its clamped pixel, weight 0 off the map; a voxel behind
      // the camera gets offsets -1 (sample_view drops its terms).
      int off[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = tp.cx[k & 1], y = tp.cy[k >> 1];
        off[k] = !tp.front ? -1
                 : fits    ? ((y - y0) * ww + (x - x0)) * kChunk
                           : (y * p.W + x) * p.C;
      }
      toff[s * NT + tid] = make_int4(off[0], off[1], off[2], off[3]);
      twt[s * NT + tid] =
          make_float4(ltk_sample_wt(tp, 0), ltk_sample_wt(tp, 1),
                      ltk_sample_wt(tp, 2), ltk_sample_wt(tp, 3));
      if (fits) {
        const T* src = static_cast<const T*>(p.feats) + bv * map + c0;
        const unsigned dst = smem_u32(win + s * winelems);
        const int q = CH / G;  // 16-byte pieces of one pixel
        const int n = ww * wh * q;
        for (int e = tid; e < n; e += NT) {
          const int pix = e / q, piece = e - pix * q;
          const int py = pix / ww, px = pix - py * ww;
          cp_async16(dst + static_cast<unsigned>((pix * kChunk + piece * G) *
                                                 sizeof(T)),
                     src + ((y0 + py) * p.W + x0 + px) * p.C + piece * G,
                     true);
        }
      }
    }
    cp_async_commit();
    if (v == 0) continue;
    // View u = v - 1: sample from its window (or device memory), aggregate.
    const int u = v - 1, su = u & 1, bu = b * p.V + u;
    cp_async_wait<1>();
    __syncthreads();
    // 'conf' samples a masked view too and weighs it by 0, as lt_tpu's
    // aggregation does (a NaN there reaches the voxel); the others skip it.
    const bool unmasked = p.mask[bu] > 0.f;
    const bool keep = METHOD == kConf || unmasked;
    if (staged >> su & 1u)
      sample_view(win + su * winelems, su, bu, keep, unmasked);
    else
      sample_view(static_cast<const T*>(p.feats) + bu * map + c0, su, bu,
                  keep, unmasked);
    __syncthreads();  // buffers su are refilled by view u + 2
  }

  if (!active) return;
  const int64_t N = static_cast<int64_t>(p.S) * p.S * p.S;
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    if (it >= nit) break;
    int x, y, z;
    if (!voxel(it * vstep + jb, x, y, z)) continue;
    T* o = static_cast<T*>(p.out) +
           (b * N + (x * p.S + y) * p.S + z) * p.C + c0 + cc;
    float r[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      r[g] = acc[it][g];
      // r - r is 0 for a finite sum and NaN where a logit was +inf (the
      // sum is then inf, or NaN already): an add, not a select, which
      // measured 2-3 % slower in float32 on an H100 80GB HBM3 at 700 W.
      if (METHOD == kSoftmax)
        r[g] = r[g] / den[METHOD == kSoftmax ? it : 0][g] + (r[g] - r[g]);
      if (METHOD == kMax && isinf(r[g]) && r[g] < 0.f) r[g] = 0.f;
    }
    if (p.vec) {
      st_vec(o, r);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (cc + g < CH) ltk_st(o + g, r[g]);
    }
  }
}

template <typename T, int METHOD>
int launch(const AggArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static bool allowed[64] = {};
  const int e = allow_smem(unproject_agg_kernel<T, METHOD>, kSmemMax, allowed);
  if (e != 0) return e;
  unproject_agg_kernel<T, METHOD><<<grid, kNT, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_method(int method, const AggArgs& a, dim3 grid, int smem,
                  cudaStream_t s) {
  switch (method) {
    case kSoftmax: return launch<T, kSoftmax>(a, grid, smem, s);
    case kSum: return launch<T, kSum>(a, grid, smem, s);
    case kMax: return launch<T, kMax>(a, grid, smem, s);
    default: return launch<T, kConf>(a, grid, smem, s);
  }
}

}  // namespace

// features (B, V, H, W, C) and out (B, S^3, C) of type dtype (kLtkF32 or
// kLtkBF16); m (B, V, 3, 4), mask (B, V) and conf (B, V, C, 'conf' only)
// float32.  window (pixels of a staged view, 0 for none), smem, grid
// (4 x 8 x 8 bricks) and chunks (of 32 channels: grid z) are the launch
// plan (unproject.unproject_plan); a plan that does not fit the shapes is
// refused with cudaErrorInvalidValue before anything runs.
extern "C" int unproject_agg(const void* feats, const float* m,
                             const float* mask, const float* conf, void* out,
                             int B, int V, int H, int W, int C, int S,
                             int method, float sx, float sy, int dtype,
                             int window, int smem, int grid, int chunks,
                             void* stream) {
  if (dtype != kLtkF32 && dtype != kLtkBF16) return kLtkBadDtype;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == kLtkF32 ? 4 : 2;
  if (B < 1 || B > 65535 || V < 1 || H < 1 || W < 1 || C < 1 || S < 1 ||
      method < kSoftmax || method > kConf || window < 0 ||
      window > kSmemMax || (method == kConf && !conf))
    return bad;
  const int64_t nb = static_cast<int64_t>((S + kBx - 1) / kBx) *
                     ((S + kBy - 1) / kBy) * ((S + kBz - 1) / kBz);
  if (static_cast<int64_t>(H) * W * C >= INT_MAX ||
      static_cast<int64_t>(S) * S * S >= INT_MAX || nb != grid ||
      chunks != (C + kChunk - 1) / kChunk || chunks > 65535 ||
      smem < agg_smem_bytes(kNT, window, elem) || smem > kSmemMax)
    return bad;
  AggArgs a;
  a.feats = feats, a.m = m, a.mask = mask, a.conf = conf, a.out = out;
  a.V = V, a.H = H, a.W = W, a.C = C, a.S = S, a.sx = sx, a.sy = sy;
  a.nby = (S + kBy - 1) / kBy, a.nbz = (S + kBz - 1) / kBz;
  a.window = window;
  a.vec = (C * elem) % 16 == 0 && aligned16(feats) && aligned16(out);
  const dim3 g(grid, B, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kLtkF32) return launch_method<float>(method, a, g, smem, s);
  return launch_method<__nv_bfloat16>(method, a, g, smem, s);
}
