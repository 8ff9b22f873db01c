// The bricks of K5 (sample_views_t.cu) and K6 (sample_views_grad_t.cu): one
// block takes a brick of 256 voxels of one view and one chunk of 32
// channels, one voxel a thread, on the grid (bricks, views, chunks).  K6
// takes K1's 4 (x) x 8 (y) x 8 (z) brick (unproject_agg.cu), whose windows
// hold the fewest pixels; K5 a 2 x 4 x 32 brick, whose z-runs of 32 voxels
// are whole 128-byte rows of its output.  Voxel coordinates come from the
// block and thread indices in 32-bit arithmetic.  Each thread projects
// its voxel once (common.cuh's ltk_voxel_taps on float coordinates, as K1),
// a block reduction takes the pixel box of the brick's taps that lie in the
// map, and the taps go to shared memory as offsets into the box's window
// (where the box fits the plan's budget) or into the map.
//
// Dynamic shared memory (smem_bytes): the window region (window_bytes: K5
// stages kChunk floats a pixel; K6 keeps a count a pixel and the brick's
// taps sorted by pixel), a [channel][voxel] tile of floats whose pitch
// kNT + 1 keeps both its row-wise and its column-wise accesses free of bank
// conflicts, the taps (an int4 of offsets and a float4 of weights a voxel)
// and the per-warp boxes.  The launch plan (window budget, dynamic shared
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
  static constexpr int x = BX, y = BY, z = BZ;
};
using K5Brick = Brick<2, 4, 32>;
using K6Brick = Brick<4, 8, 8>;

// K6's counts: window + 1 ints, rounded up to 16 bytes.
__host__ __device__ constexpr int count_slots(int window) {
  return (window + 4) / 4 * 4;
}

__host__ __device__ constexpr int window_bytes(int window, bool grad) {
  return grad ? count_slots(window) * 4 + 4 * kNT * 2 : window * kChunk * 4;
}

__host__ __device__ constexpr int smem_bytes(int window, bool grad) {
  return window_bytes(window, grad) + kChunk * kPitch * 4 + kNT * 32 +
         kNW * 16;
}

struct Args {
  const float* src;  // K5: features (BV, H, W, C); K6: g (BV, C, S^3)
  const float* m;    // (BV, 3, 4)
  float* dst;        // K5: out (BV, C, S^3); K6: dF (BV, H, W, C)
  int H, W, C, S;
  float sx, sy;
  int nby, nbz;      // bricks along y and z
  int window;        // the budget: pixels of one staged window
  int vec;           // K5: 16-byte feature rows (C % 4 == 0, aligned)
};

// cudaErrorInvalidValue for a plan that does not fit the shapes, else 0.
template <class B>
int plan_error(int BV, int H, int W, int C, int S, int window, int smem,
               int grid, int chunks, bool grad) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (BV < 1 || BV > 65535 || H < 1 || W < 1 || C < 1 || S < 1 ||
      window < 0 || window > kSmemMax)
    return bad;
  const int64_t nb = static_cast<int64_t>((S + B::x - 1) / B::x) *
                     ((S + B::y - 1) / B::y) * ((S + B::z - 1) / B::z);
  if (static_cast<int64_t>(H) * W * C >= INT_MAX ||
      static_cast<int64_t>(S) * S * S >= INT_MAX || nb != grid ||
      chunks != (C + kChunk - 1) / kChunk || chunks > 65535 ||
      smem != smem_bytes(window, grad) || smem > kSmemMax)
    return bad;
  return 0;
}

template <class B>
Args make_args(const float* src, const float* m, float* dst, int H, int W,
               int C, int S, float sx, float sy, int window) {
  Args a;
  a.src = src, a.m = m, a.dst = dst;
  a.H = H, a.W = W, a.C = C, a.S = S, a.sx = sx, a.sy = sy;
  a.nby = (S + B::y - 1) / B::y, a.nbz = (S + B::z - 1) / B::z;
  a.window = window;
  a.vec = 0;
  return a;
}

struct Smem {
  float* win;    // K5: [pixel of the box][kChunk]; K6: counts, sorted taps
  float* tile;   // [channel][kPitch]
  int4* toff;    // [voxel]
  float4* twt;   // [voxel]
  int4* red;     // [warp]
};

__device__ __forceinline__ Smem smem_layout(unsigned char* smem, int window,
                                            bool grad) {
  Smem s;
  s.win = reinterpret_cast<float*>(smem);
  s.tile = reinterpret_cast<float*>(smem + window_bytes(window, grad));
  s.toff = reinterpret_cast<int4*>(s.tile + kChunk * kPitch);
  s.twt = reinterpret_cast<float4*>(s.toff + kNT);
  s.red = reinterpret_cast<int4*>(s.twt + kNT);
  return s;
}

// Brick voxel j (z fastest, as the voxel index n) of this block -> grid
// coordinates; false outside the grid (a brick past a side not a multiple
// of the brick's).
template <class B>
__device__ __forceinline__ bool brick_voxel(const Args& p, int j, int& gx,
                                           int& gy, int& gz) {
  const int bzi = blockIdx.x % p.nbz;
  const int byi = (blockIdx.x / p.nbz) % p.nby;
  const int bxi = blockIdx.x / (p.nbz * p.nby);
  gz = bzi * B::z + (j & (B::z - 1));
  gy = byi * B::y + ((j / B::z) & (B::y - 1));
  gx = bxi * B::x + j / (B::z * B::y);
  return gx < p.S && gy < p.S && gz < p.S;
}

// The pixel box of the brick's taps in the map: x0, y0, its width and
// height (0 where no tap is in the map), and whether it is staged.
struct Box {
  int x0, y0, ww, wh;
  bool fits;
};

// Projects this thread's voxel (if `mine`) through mm, reduces the brick's
// box, and writes the voxel's taps to shared memory: offsets ((y - y0) * ww
// + x - x0) * kChunk into the window where the box fits `budget` pixels
// (and `stage` allows it), else (y * W + x) * C into the map; -1 for a tap
// off the map (a voxel behind the camera has every tap off).  The caller
// synchronises before reading the taps.
__device__ __forceinline__ Box brick_taps(const Args& p, const Smem& sm,
                                          const float* __restrict__ mm,
                                          bool mine, int gx, int gy, int gz,
                                          bool stage) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  LtkTaps tp{};
  if (mine)
    tp = ltk_voxel_taps(mm, static_cast<float>(gx), static_cast<float>(gy),
                        static_cast<float>(gz), p.H, p.W, p.sx, p.sy);
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
  b.fits = stage && any && b.ww * b.wh <= p.window;
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

}  // namespace ltk_brick
