// The bricks of K5-K8: per-view sampling of an affine voxel grid
// (sample_views_t.cu, channels-major; sample_views.cu, voxels-major) and its
// feature-gradient scatter (sample_views_grad_t.cu, sample_views_grad.cu).
// One block takes a brick of 256 voxels of one view and one chunk of 32
// channels, one voxel a thread, on the grid (bricks, views, chunks).  K6,
// K7 and K8 take K1's 4 (x) x 8 (y) x 8 (z) brick (unproject_agg.cu), whose
// boxes of taps span the fewest pixels; K5 a 2 x 4 x 32 brick, whose z-runs
// of 32 voxels are whole 128-byte rows of its output.  Voxel coordinates
// come from the block and thread indices in 32-bit arithmetic.  Each thread
// projects its voxel once (common.cuh's ltk_voxel_taps on float
// coordinates, as K1) and writes its taps to shared memory: for the
// samplers (K5, K7) as offsets into the map of each tap's pixel clamped to
// the map, with weight 0 where the tap lies off it; for the scatters (K6,
// K8) a block reduction first takes the pixel box of the brick's taps that
// lie in the map, and the taps are offsets into the box's window where the
// box fits the plan's budget (the pre-reduction), else into the map.
//
// Dynamic shared memory (smem_bytes), by layout: the scatters' region (a
// count a pixel of the window and the brick's taps sorted by pixel), a
// [channel][voxel] tile of floats (K5, K6, K8) whose pitch kNT + 1 keeps
// both its row-wise and its column-wise accesses free of bank conflicts,
// the taps (an int4 of offsets and a float4 of weights a voxel) and the
// scatters' per-warp boxes.  The launch plan (window budget, dynamic shared
// memory, grid) is computed in Python (sample.sample_plan, tested on the
// CPU) and checked by plan_error.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace ltk_brick {

constexpr int kChunk = 32;        // channels of one block (grid z)
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kNT = 256;          // voxels of a brick, threads of a block
constexpr int kNW = kNT / 32;     // warps of a block
constexpr int kPitch = kNT + 1;   // tile row: one channel's voxels

// A brick of BX x BY x BZ voxels, z fastest.
template <int BX, int BY, int BZ>
struct Brick {
  static_assert(BX * BY * BZ == kNT, "a voxel a thread");
  static_assert((BY & (BY - 1)) == 0 && (BZ & (BZ - 1)) == 0, "powers of 2");
  static_assert(BZ >= 4, "4 consecutive voxels a row of the output");
  static constexpr int x = BX, y = BY, z = BZ;
};
using K5Brick = Brick<2, 4, 32>;
using K6Brick = Brick<4, 8, 8>;  // K6, K7, K8

// What a kernel keeps in shared memory besides its taps: K5 the tile, K7
// nothing, K6 and K8 (kScatter) the pre-reduction's region, the tile and
// the per-warp boxes.
enum Layout { kTile = 0, kTaps = 1, kScatter = 2 };

// The scatters' counts: window + 1 ints, rounded up to 16 bytes.
__host__ __device__ constexpr int count_slots(int window) {
  return (window + 4) / 4 * 4;
}

__host__ __device__ constexpr int region_bytes(int window, Layout l) {
  return l == kScatter ? count_slots(window) * 4 + 4 * kNT * 2 : 0;
}

__host__ __device__ constexpr int smem_bytes(int window, Layout l) {
  return region_bytes(window, l) + (l == kTaps ? 0 : kChunk * kPitch * 4) +
         kNT * 32 + (l == kScatter ? kNW * 16 : 0);
}

struct Args {
  const void* src;  // K5 / K7: features (BV, H, W, C); K6: g (BV, C, S^3);
                    // K8: g (BV, S^3, C)
  const float* m;   // (BV, 3, 4)
  void* dst;        // K5: out (BV, C, S^3); K7: out (BV, S^3, C);
                    // K6 / K8: dF (BV, H, W, C), float
  int H, W, C, S;
  float sx, sy;
  int nby, nbz;     // bricks along y and z
  int window;       // K6 / K8: the pre-reduction's budget in pixels
  int vec;          // 4-channel loads of src (C % 4 == 0, aligned)
  int vst;          // K7: 4-channel stores of dst
  int ox, nx;       // K5 / K6: the slab, X planes [ox, ox + nx) of the S^3
                    // grid (0, S: the whole grid; K7 / K8 take it whole)
};

// cudaErrorInvalidValue for a plan that does not fit the shapes or a slab
// (X planes [ox, ox + nx)) outside the S^3 grid, else 0.
template <class B>
int plan_error(int BV, int H, int W, int C, int S, int window, int smem,
               int grid, int chunks, Layout l, int ox, int nx) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (BV < 1 || BV > 65535 || H < 1 || W < 1 || C < 1 || S < 1 ||
      window < 0 || window > kSmemMax || (window > 0 && l != kScatter) ||
      ox < 0 || nx < 1 || nx > S - ox)
    return bad;
  const int64_t nb = static_cast<int64_t>((nx + B::x - 1) / B::x) *
                     ((S + B::y - 1) / B::y) * ((S + B::z - 1) / B::z);
  if (static_cast<int64_t>(H) * W * C >= INT_MAX ||
      static_cast<int64_t>(S) * S * S >= INT_MAX || nb != grid ||
      chunks != (C + kChunk - 1) / kChunk || chunks > 65535 ||
      smem != smem_bytes(window, l) || smem > kSmemMax)
    return bad;
  return 0;
}

template <class B>
Args make_args(const void* src, const float* m, void* dst, int H, int W,
               int C, int S, float sx, float sy, int window, int ox,
               int nx) {
  Args a;
  a.src = src, a.m = m, a.dst = dst;
  a.H = H, a.W = W, a.C = C, a.S = S, a.sx = sx, a.sy = sy;
  a.nby = (S + B::y - 1) / B::y, a.nbz = (S + B::z - 1) / B::z;
  a.window = window;
  a.vec = a.vst = 0;
  a.ox = ox, a.nx = nx;
  return a;
}

struct Smem {
  float* win;    // kScatter: the counts and sorted taps (brick_scatter)
  float* tile;   // [channel][kPitch]
  int4* toff;    // [voxel]
  float4* twt;   // [voxel]
  int4* red;     // kScatter: [warp]
};

__device__ __forceinline__ Smem smem_layout(unsigned char* smem, int window,
                                            Layout l) {
  Smem s;
  s.win = reinterpret_cast<float*>(smem);
  s.tile = reinterpret_cast<float*>(smem + region_bytes(window, l));
  s.toff = reinterpret_cast<int4*>(s.tile + (l == kTaps ? 0 : kChunk * kPitch));
  s.twt = reinterpret_cast<float4*>(s.toff + kNT);
  s.red = reinterpret_cast<int4*>(s.twt + kNT);
  return s;
}

// Brick voxel j (z fastest, as the voxel index n) of this block -> grid
// coordinates, gx counted from the slab's first plane ox; false outside
// the slab (a brick past a side not a multiple of the brick's).
template <class B>
__device__ __forceinline__ bool brick_voxel(const Args& p, int j, int& gx,
                                           int& gy, int& gz) {
  const int bzi = blockIdx.x % p.nbz;
  const int byi = (blockIdx.x / p.nbz) % p.nby;
  const int bxi = blockIdx.x / (p.nbz * p.nby);
  gz = bzi * B::z + (j & (B::z - 1));
  gy = byi * B::y + ((j / B::z) & (B::y - 1));
  gx = bxi * B::x + j / (B::z * B::y);
  return gx < p.nx && gy < p.S && gz < p.S;
}

// The taps of this thread's voxel (none where !mine: off the grid), at
// grid X index ox + gx: the slab's first plane is an integer added to the
// voxel's index, as K1 adds it (folded into m's offset it would round
// otherwise), so that a slab's voxel projects as in the whole grid.  The
// samplers and the scatters project inside map_taps and brick_taps: with
// the projection in the kernel and the taps passed in, ptxas orders the
// same instructions so that K6 takes 0.8 % longer and K7 up to 1 % on an
// H100 80GB HBM3 at 700 W (PERF.md).
__device__ __forceinline__ LtkTaps voxel_taps(const Args& p,
                                              const float* __restrict__ mm,
                                              bool mine, int gx, int gy,
                                              int gz) {
  LtkTaps tp{};
  if (mine)
    tp = ltk_voxel_taps(mm, static_cast<float>(p.ox + gx),
                        static_cast<float>(gy),
                        static_cast<float>(gz), p.H, p.W, p.sx, p.sy);
  return tp;
}

// The samplers (K5, K7): projects this thread's voxel (if `mine`) through
// mm and writes its taps to shared memory as offsets (y * W + x) * C into
// the map of each tap's pixel clamped to the map, and its weight (0 for a
// tap off the map); -1 for every tap of a voxel behind the camera.  The
// caller synchronises before reading.
__device__ __forceinline__ void map_taps(const Args& p, const Smem& sm,
                                         const float* __restrict__ mm,
                                         bool mine, int gx, int gy, int gz) {
  const LtkTaps tp = voxel_taps(p, mm, mine, gx, gy, gz);
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    off[k] = tp.front ? (tp.cy[k >> 1] * p.W + tp.cx[k & 1]) * p.C : -1;
  sm.toff[threadIdx.x] = make_int4(off[0], off[1], off[2], off[3]);
  sm.twt[threadIdx.x] =
      make_float4(ltk_sample_wt(tp, 0), ltk_sample_wt(tp, 1),
                  ltk_sample_wt(tp, 2), ltk_sample_wt(tp, 3));
}

// Four channels of a float32 or bfloat16 row, widened to float32: one
// 16- or 8-byte load where vec, else element by element (the first n, the
// rest 0).  cs: a streaming load (read once).
template <bool cs>
__device__ __forceinline__ void ld4(const float* q, float (&f)[4], int n,
                                    bool vec) {
  if (vec) {
    const float4 v = cs ? __ldcs(reinterpret_cast<const float4*>(q))
                        : *reinterpret_cast<const float4*>(q);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) f[g] = g < n ? q[g] : 0.f;
  }
}

template <bool cs>
__device__ __forceinline__ void ld4(const __nv_bfloat16* q, float (&f)[4],
                                    int n, bool vec) {
  if (vec) {
    const uint2 v = cs ? __ldcs(reinterpret_cast<const uint2*>(q))
                       : *reinterpret_cast<const uint2*>(q);
    f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & ~0xffffu);
    f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & ~0xffffu);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) f[g] = g < n ? ltk_ld(q + g) : 0.f;
  }
}

// Channels cc..cc+3 of voxel j's sample from the map (channel c0 of pixel
// 0): its taps summed k = 0..3 with ltk_tap, the order K1 sums them in; a
// tap off the map reads its clamped pixel with weight 0.  A voxel behind
// the camera (offsets -1) reads pixel 0 and its terms are dropped by a
// select, not a branch, so that K1's 'sum' of one view, K5 and K7 agree bit
// for bit whatever the features hold.  vec: each tap's 4 channels in one
// load; else element by element, channels past the chunk's CH left 0.
// (The sums sit in each branch: one shared sum after a common load
// measured 2-13 % slower in K5 and K7 on an H100 80GB HBM3 at 700 W,
// PERF.md.)
template <typename T>
__device__ __forceinline__ void gather4(const T* __restrict__ map,
                                        const Smem& sm, int j, int cc,
                                        int CH, bool vec, float (&val)[4]) {
  const int4 o4 = sm.toff[j];
  const float4 w4 = sm.twt[j];
  const int o[4] = {o4.x, o4.y, o4.z, o4.w};
  const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int g = 0; g < 4; ++g) val[g] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = o[k] >= 0;
    const T* q = map + (in ? o[k] : 0) + cc;
    if (vec) {
      float f[4];
      ld4<false>(q, f, 4, true);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        val[g] = in ? ltk_tap(val[g], wk[k], f[g]) : val[g];
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (cc + g < CH)
          val[g] = in ? ltk_tap(val[g], wk[k], ltk_ld(q + g)) : val[g];
    }
  }
}

// ---------------------------------------------------------------------------
// The scatters (K6, K8): the brick's box, the pre-reduction
// ---------------------------------------------------------------------------

// The pixel box of the brick's taps in the map: x0, y0, its width and
// height (0 where no tap is in the map), and whether it fits the budget.
struct Box {
  int x0, y0, ww, wh;
  bool fits;
};

// Projects this thread's voxel (if `mine`) through mm, reduces the brick's
// box over its taps and writes them to shared memory: offsets ((y - y0) *
// ww + x - x0) * kChunk into the window where the box fits the plan's
// budget, else (y * W + x) * C into the map; -1 for a tap off the map.
// Synchronises the block once (after which shared memory written before
// the call is visible); the caller synchronises again before reading the
// taps.  (brick_scatter derives its pointers from sm.win for the same
// reason as voxel_taps' note: held in Smem, they cost K6 0.4 %.)
__device__ __forceinline__ Box brick_taps(const Args& p, const Smem& sm,
                                          const float* __restrict__ mm,
                                          bool mine, int gx, int gy, int gz) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LtkTaps tp = voxel_taps(p, mm, mine, gx, gy, gz);
  int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (tp.in >> k & 1u) {
      x0 = min(x0, tp.x + (k & 1)), x1 = max(x1, tp.x + (k & 1));
      y0 = min(y0, tp.y + (k >> 1)), y1 = max(y1, tp.y + (k >> 1));
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(~0u, x0, o));
    x1 = max(x1, __shfl_xor_sync(~0u, x1, o));
    y0 = min(y0, __shfl_xor_sync(~0u, y0, o));
    y1 = max(y1, __shfl_xor_sync(~0u, y1, o));
  }
  if (lane == 0) sm.red[warp] = make_int4(x0, x1, y0, y1);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kNW; ++w) {
    const int4 r = sm.red[w];
    x0 = min(x0, r.x), x1 = max(x1, r.y);
    y0 = min(y0, r.z), y1 = max(y1, r.w);
  }
  Box b;
  const bool any = x0 <= x1;
  b.x0 = x0, b.y0 = y0;
  b.ww = any ? x1 - x0 + 1 : 0, b.wh = any ? y1 - y0 + 1 : 0;
  b.fits = any && b.ww * b.wh <= p.window;
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = tp.x + (k & 1), y = tp.y + (k >> 1);
    off[k] = !(tp.in >> k & 1u) ? -1
             : b.fits           ? ((y - y0) * b.ww + (x - x0)) * kChunk
                                : (y * p.W + x) * p.C;
  }
  sm.toff[tid] = make_int4(off[0], off[1], off[2], off[3]);
  sm.twt[tid] = make_float4(tp.wt[0], tp.wt[1], tp.wt[2], tp.wt[3]);
  return b;
}

// The scatters' rule for a gradient that is not finite, as the plain
// versions and lt_tpu's autodiff have it: a tap off the map of a voxel in
// front of the camera adds 0 * g at its pixel clamped to the map, NaN
// where g is NaN or infinite (0 * g is 0 for a finite g, which the finite
// path leaves out).  Called after brick_taps (the tile is visible) only
// where a loaded g is not finite, which the kernels find as an FMA chain,
// z = g * 0 + z over the g they load, NaN exactly where one is not finite
// (one instruction a value): K6, whose thread loads its own voxel's
// column, where that thread's z is NaN; K8, whose tile is loaded across
// the block, where any thread's is (__syncthreads_or).  This thread's
// voxel, each channel of its tile column that is not finite.  (A flag
// reduced at brick_taps' barrier for both cost K6 about 4 %; this way K6
// is unchanged and K8 within 2 % on an H100: PERF.md.)
__device__ __forceinline__ void edge_taps(const Args& p, const Smem& sm,
                                          const float* __restrict__ mm,
                                          bool mine, int gx, int gy, int gz,
                                          int bv, int c0, int CH) {
  const LtkTaps tp = voxel_taps(p, mm, mine, gx, gy, gz);
  if (!tp.front || tp.in == 0xfu) return;
  float* map = static_cast<float*>(p.dst) +
               static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
  for (int c = 0; c < CH; ++c) {
    const float g = sm.tile[c * kPitch + threadIdx.x];
    if (isfinite(g)) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!(tp.in >> k & 1u))
        atomicAdd(map + (tp.cy[k >> 1] * p.W + tp.cx[k & 1]) * p.C + c,
                  0.f * g);
  }
}

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

// The scatters' body, after the gradient tile and brick_taps: adds each
// voxel's taps, weighted by its gradient in the tile, to dF (channel c0 of
// view bv; CH channels).  Where the box fits, the block pre-reduces the
// brick's taps in shared memory before any global atomic: a counting sort
// puts the brick's (voxel, tap) pairs in order of their pixel in the box
// (a count a pixel with integer shared-memory atomics, whose returns rank
// the taps; a block-wide scan; each tap written to its place), then each
// warp takes whole pixels, its lanes over channels, sums the pixel's taps'
// weighted gradients in a register and adds the sum to dF with one global
// atomicAdd per (pixel, channel) where it is not 0.  (A float atomicAdd in
// shared memory is a compare-and-swap loop on sm_90, ATOMS.CAST.SPIN: a
// window of float sums built with it measured slower than this sort.)  A
// brick whose box exceeds the budget adds its taps to dF directly, 32
// neighbouring floats an instruction.  A gradient of exactly 0 (a masked
// view) issues no atomics.  Threads may return early: the kernel's last
// call.
__device__ __forceinline__ void brick_scatter(const Args& p, const Smem& sm,
                                              const Box& box, int bv, int c0,
                                              int CH) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* map = static_cast<float*>(p.dst) +
               static_cast<int64_t>(bv) * p.H * p.W * p.C + c0;
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
      sorted[cnt[pix[k]] + rank[k]] =
          static_cast<unsigned short>(tid * 4 + k);
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

}  // namespace ltk_brick
