// K2: 'same' 3D convolution over an NDHWC volume on the tensor cores, odd
// kernel k, with the folded-BN bias, an optional residual and an optional
// ReLU:
//
//   out[n, co] = act( sum_{taps, ci} x[n + tap, ci] * w[tap, ci, co]
//                     + bias[co] (+ res[n, co]) ),   act = relu or identity.
//
// float32 bias, float32 sum, output float32 or bfloat16 rounded once, the
// residual added before the ReLU, any odd k, any Cin and Cout, any volume.
// Weights are DHWIO, so one tap's (Cin, Cout) slice is a K x N row-major
// matrix.  One body, instances of it by PARTS, the bfloat16 parts each
// operand comes in:
//   - conv3d_mma.cu: bfloat16 x, w and residual (PARTS = 1);
//   - conv3d_mma_f32.cu: float32 x, w and residual, each float32 operand
//     given as its bfloat16 parts v1 = bf16(v), v2 = bf16(v - v1), ...
//     (split_bf16 there).  PARTS = 3 (k = 1 and 3): every k16 step issues
//     the six products x_i * w_j with i + j <= 2 (0-based) into the same
//     float32 accumulators, within about 2^-24 relative per product.
//     PARTS = 2 (k = 7, whose three-part brick would not fit the shared
//     memory): mma(x1, w1), mma(x1, w2) and mma(x2, w1); the sum drops
//     only x2 * w2 and the rounding of x2 and w2, about 2^-16 relative
//     per product (lt_tpu's float32 Pallas unprojection computes float32
//     products the same way, lt_tpu/ops/pallas/unproject.py:306-312).
//     Three products of two parts hold each launch to 1e-5 of its output,
//     but V2V's deep chain of them moved the flagship's float32 volumes,
//     held to the plain path at 1e-4, to 9.3e-5 on the H100 (4.1e-5 with
//     the k = 3 convolutions in plain float32); with six products for
//     k <= 3, 4.8e-5.  The tensor cores' float32 accumulation
//     truncates, and over the 3 x 43,904 products of a k=7 128-channel sum
//     that bias alone reached 1e-4 of the output on the H100: so each
//     tap's products (of one Cin chunk) are summed from zero in the MMAs
//     and added to the running sum with a float32 add.  The residual is
//     float32.
//
// Replaces the convolutions inside these TPU kernels:
//   lt_tpu/ops/pallas/conv_mp.py:conv3d_mp (pallas_call :237)   k = 7 front
//   lt_tpu/ops/pallas/res3d.py:res3d_chain_fused (:742), res3d_block_fused
//     (:950), upsample_res3d_fused (:1180)     k = 3 convs, k = 1 skip / tail
//   lt_tpu/ops/pallas/conv3d.py:conv3d_same (:205)
//   and conv_mp.py:res3d_block_mp (:442), res3d_q4.py:res3d_block_q4 (:245),
//   res3d_folded.py:res3d_block_folded (:302).
//
// Bound on the card: operations at k = 3 and 7 (a k=3 32->32 conv does 55
// kflop per output voxel against 128 bytes moved in bfloat16: 430 flop a
// byte, above the H100's 295 for bfloat16 tensor cores at 989 TFLOP/s and
// 3.35 TB/s; the float32 body does six (k <= 3) or three (k = 7) times
// the products against three or two times the bytes), bytes at k = 1.
// On the CUDA cores a float32 convolution is bounded by 67 TFLOP/s: six
// bfloat16 products on the tensor cores are bounded 2.5x lower, three 5x.
//
// Design: an implicit GEMM with warp-level mma.sync.m16n8k16 (bf16 in,
// float32 accumulators in registers).  M is a block's output brick of
// bx * by * bz <= 256 voxels (4 x 8 x 8 where the shared memory allows; Z,
// the contiguous axis, longest; 128 and 4 x 4 x 8 for NT = 64), N a tile
// of NT = 16 / 24 / 32 / 64 output channels, K = taps x Cin walked in
// chunks of CK = 16 / 32 channels.  Four warps; a warp owns M / 4 rows and
// every column of the tile.
//   - Input reuse across taps: for each Cin chunk the block copies the
//     haloed brick, (bx+k-1)(by+k-1)(bz+k-1) voxel rows of CK channels (of
//     each part: a row holds the parts side by side), into shared
//     memory once, with 16-byte cp.async; the zero-fill form (source size
//     0) gives the 'same' padding, the ragged volume edge and ragged Cin.
//     Every tap is then an ldmatrix of shifted rows of that brick: a lane
//     gives the address of its own voxel's row, so a shifted 3D window
//     costs nothing to address.  Rows are padded to an odd number of
//     16-byte units, so the 8 consecutive rows of one 8 x 8 matrix hit 8
//     distinct bank groups.
//   - Weights stream through a ring of kStages shared-memory slots, one
//     (dx, dy) row of k taps x CK x NT per slot (one after another for
//     each part), with cp.async; B fragments come from ldmatrix.trans on
//     those K x N row-major slices.  The copies for step s + kStages - 1
//     (the next row's weights and, at a chunk's first row, the next
//     chunk's halo into the other halo buffer) are in flight while step s
//     runs its MMAs.  Where two halo buffers do not fit (a large k with
//     several chunks, or the doubled k = 7 brick in float32), one is
//     reloaded at each chunk's first step.
//   - Epilogue: the accumulators go through shared memory so that each
//     thread adds bias, residual and ReLU to 8 consecutive channels, rounds
//     once and stores 16 bytes (bfloat16; two 16-byte stores in float32),
//     where Cout % 8 == 0 and the pointers allow; else element by element,
//     a lane per channel.
//   - Ragged Cout is masked at the store, a volume smaller than the brick
//     is masked by the brick's bounds; offsets are 64-bit.
//   - k = 3 and 7 are template constants, so that each step's taps unroll
//     into straight-line ldmatrix / mma code, for the (NT, CK) pairs that
//     the flagship V2V launches with them (see unrolled()); every other
//     launch takes the runtime loop.
// The launch plan (NT, CK, brick, halo buffers, dynamic shared memory,
// grid) is computed in Python (conv3d.conv3d_mma_plan, tested on the CPU)
// and checked here before the launch.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace {

using namespace ltk_mma;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;        // weight ring slots
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

struct MmaArgs {
  const __nv_bfloat16* x;  // part p at x + p * xpart
  const __nv_bfloat16* w;  // part p at w + p * wpart
  int64_t xpart, wpart;
  const float* bias;
  const void* res;         // bfloat16 (PARTS = 1), else float32
  void* out;
  int X, Y, Z, Cin, Cout, K, relu;
  int bx, by, bz;      // brick
  int tx, ty, tz;      // bricks along each axis
  int ntiles;          // output-channel tiles
  int nchunks, nh;     // Cin chunks, halo buffers
  int vec_x, vec_w, vec_out;
};

// Output voxels per block (M): 256, four m16 tiles a warp, for N tiles of
// up to 32 channels (each B fragment feeds twice the MMAs and each weight
// slice serves twice the voxels); 128, two a warp, for the 64-channel
// tile, whose 8 x 2 accumulator tiles a warp already take 64 registers of
// the 128 it uses.
__host__ __device__ constexpr int block_voxels(int nt) {
  return nt <= 32 ? 256 : 128;
}

// Bytes of dynamic shared memory a launch needs: the halo buffers and the
// weight ring, or the epilogue's float32 tile and row offsets if larger.
// parts: the bfloat16 parts of each operand.
__host__ __device__ inline int smem_bytes(int nt, int ck, int k, int bx,
                                          int by, int bz, int nh, int parts) {
  const int halo =
      (bx + k - 1) * (by + k - 1) * (bz + k - 1) * odd_pitch(parts * ck);
  const int main = nh * halo + kStages * parts * k * ck * odd_pitch(nt);
  const int epi = block_voxels(nt) * ((nt + 4) * 4 + 8);
  return main > epi ? main : epi;
}

// KT: the kernel size where it is a compile-time constant (3 or 7 for the
// pairs of unrolled(): every tap loop then unrolls into straight-line
// code), else 0.
// Blocks a multiprocessor that the launch bounds promise ptxas.  One for
// the float32 parts and the bfloat16 k = 7 instance (their plans hold most
// of the shared memory anyway): with no minimum ptxas kept the bfloat16
// k = 7 instance to 72 registers, recomputing tap addresses in the MMA
// loop, 5.86 ms against 4.90 with 105 registers on an H100 (k = 7, 32 ->
// 16, 64^3, batch 8).  Four (128 registers) for the other bfloat16
// instances, whose k = 1 and small plans leave room for four blocks.
template <int NT, int CK, int KT, int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads,
                                  PARTS == 1 && KT != 7 ? 4 : 1)
conv3d_mma_kernel(const MmaArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool SPLIT = PARTS > 1;
  using TR = std::conditional_t<SPLIT, float, __nv_bfloat16>;
  constexpr int NJ = NT / 8;              // n8 tiles
  constexpr int M = block_voxels(NT);
  constexpr int WM = M / (kWarps * 16);   // m16 tiles per warp
  constexpr int ROWB = odd_pitch(PARTS * CK);  // halo row pitch, bytes
  constexpr int WROW = odd_pitch(NT);     // weight row pitch, bytes
  const int K = KT ? KT : p.K, h = (K - 1) / 2, ksq = K * K;
  const int HY = p.by + K - 1, HZ = p.bz + K - 1;
  const int hrows = (p.bx + K - 1) * HY * HZ;
  const int hbytes = hrows * ROWB;
  const int wpart = K * CK * WROW;        // one part of a ring slot
  unsigned char* halo = smem;
  unsigned char* wring = smem + p.nh * hbytes;

  // blockIdx.x -> (batch, brick, channel tile); the tile varies fastest so
  // that the blocks sharing a halo run together.
  int bid = blockIdx.x;
  const int nt = bid % p.ntiles;
  bid /= p.ntiles;
  const int z0 = (bid % p.tz) * p.bz;
  bid /= p.tz;
  const int y0 = (bid % p.ty) * p.by;
  bid /= p.ty;
  const int x0 = (bid % p.tx) * p.bx;
  const int b = bid / p.tx;
  const int co0 = nt * NT;
  const int bvox = p.bx * p.by * p.bz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto voxel = [&](int64_t gx, int64_t gy, int64_t gz) {
    return ((static_cast<int64_t>(b) * p.X + gx) * p.Y + gy) * p.Z + gz;
  };

  // Chunk c's haloed input brick (each part) into halo buffer c % nh.
  auto load_halo = [&](int c) {
    unsigned char* dst = halo + (c % p.nh) * hbytes;
    const int ci0 = c * CK;
    constexpr int Q = CK / 8;
    const int n = p.vec_x ? hrows * PARTS * Q : hrows * PARTS * CK;
    for (int e = tid; e < n; e += kThreads) {
      // Divisions by constants only: this loop runs once per chunk.
      const int row = p.vec_x ? e / (PARTS * Q) : e / (PARTS * CK);
      const int r = p.vec_x ? e % (PARTS * Q) : e % (PARTS * CK);
      const int part = PARTS == 1 ? 0 : p.vec_x ? r / Q : r / CK;
      const int ci = p.vec_x ? (r % Q) * 8 : r % CK;
      const int hz = row % HZ, t = row / HZ;
      const int gx = x0 + t / HY - h, gy = y0 + t % HY - h, gz = z0 + hz - h;
      const bool ok = gx >= 0 && gx < p.X && gy >= 0 && gy < p.Y && gz >= 0 &&
                      gz < p.Z && ci0 + ci < p.Cin;
      const __nv_bfloat16* src =
          ok ? p.x + part * p.xpart + voxel(gx, gy, gz) * p.Cin + ci0 + ci
             : p.x;
      unsigned char* d = dst + row * ROWB + (part * CK + ci) * 2;
      if (p.vec_x)
        cp_async16(smem_u32(d), src, ok);
      else
        *reinterpret_cast<__nv_bfloat16*>(d) =
            ok ? *src : __float2bfloat16(0.f);
    }
  };

  // Step s = (chunk, dx, dy): k taps x CK x NT weights (each part) into
  // ring slot s.
  auto load_w = [&](int s) {
    unsigned char* dst = wring + (s % kStages) * PARTS * wpart;
    const int ci0 = (s / ksq) * CK, tap0 = (s % ksq) * K;
    constexpr int Q = NT / 8;
    const int rows = K * CK;
    const int n = p.vec_w ? PARTS * rows * Q : PARTS * rows * NT;
    for (int e = tid; e < n; e += kThreads) {
      const int row = p.vec_w ? e / Q : e / NT;    // part, dz * CK + ci
      const int co = p.vec_w ? (e % Q) * 8 : e % NT;
      int part = 0, rr = row;
#pragma unroll
      for (int q = 1; q < PARTS; ++q)
        if (rr >= rows) rr -= rows, ++part;
      const int ci = ci0 + rr % CK;
      const bool ok = ci < p.Cin && co0 + co < p.Cout;
      const __nv_bfloat16* src =
          ok ? p.w + part * p.wpart +
                   (static_cast<int64_t>(tap0 + rr / CK) * p.Cin + ci) *
                       p.Cout + co0 + co
             : p.w;
      unsigned char* d = dst + row * WROW + co * 2;
      if (p.vec_w)
        cp_async16(smem_u32(d), src, ok);
      else
        *reinterpret_cast<__nv_bfloat16*>(d) =
            ok ? *src : __float2bfloat16(0.f);
    }
  };

  // With one halo buffer for several chunks (a large k), a chunk's halo is
  // copied at its first step, after every warp has left the previous one.
  const int nsteps = p.nchunks * ksq;
  const bool reload = p.nh == 1 && p.nchunks > 1;
  auto issue = [&](int s) {
    if (s < nsteps) {
      if (s % ksq == 0 && !(reload && s > 0)) load_halo(s / ksq);
      load_w(s);
    }
    cp_async_commit();
  };

  // This lane's ldmatrix rows: voxel m of m16 tile i at tap (0, 0, 0);
  // lanes 16-31 address the upper 8 channels of a k16 step.
  int arow[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int m = (warp * WM + i) * 16 + (lane & 15);
    const int mz = m % p.bz, t = m / p.bz;
    arow[i] = m < bvox ? ((t / p.by) * HY + t % p.by) * HZ + mz : 0;
  }
  const int akoff = (lane >> 4) * 16;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = (lane >> 4) * 8;

  float acc[WM][NJ][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int s = 0; s < nsteps; ++s) {
    const int c = s / ksq, r = s % ksq;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (reload && r == 0 && c > 0) {
      load_halo(c);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    issue(s + kStages - 1);
    const unsigned hb = smem_u32(halo + (c % p.nh) * hbytes) + akoff;
    const unsigned wb = smem_u32(wring + (s % kStages) * PARTS * wpart);
    const int plane = ((r / K) * HY + r % K) * HZ;
#pragma unroll (KT ? KT : 2)
    for (int dz = 0; dz < K; ++dz) {
      // float32: one tap's products go to `part`, added to acc in float32
      // after the tap (below), so that the tensor cores' own accumulation,
      // which truncates, only ever sums one tap's terms.
      float part[WM][NJ][4];
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        if constexpr (!SPLIT) {
          // bfloat16: the A fragments, the B fragments, the MMAs.
          unsigned af[WM][4], bf[NJ][2];
#pragma unroll
          for (int i = 0; i < WM; ++i)
            ldsm_x4(hb + (arow[i] + plane + dz) * ROWB + kk * 32, af[i]);
          const unsigned wr = wb + (dz * CK + kk * 16 + bk) * WROW;
#pragma unroll
          for (int j = 0; j + 1 < NJ; j += 2)
            ldsm_x4_t(wr + (j * 8 + bn) * 2, bf[j][0], bf[j][1],
                      bf[j + 1][0], bf[j + 1][1]);
          if constexpr (NJ % 2)
            ldsm_x2_t(wr + (NJ - 1) * 16, bf[NJ - 1][0], bf[NJ - 1][1]);
#pragma unroll
          for (int i = 0; i < WM; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
        } else {
          // float32 parts: every weight part's B fragments; then, one x
          // part q at a time, its A fragments and its products x_q * w_j,
          // q + j < PARTS.
          unsigned af[WM][4], bf[PARTS][NJ][2];
          const unsigned wr = wb + (dz * CK + kk * 16 + bk) * WROW;
#pragma unroll
          for (int q = 0; q < PARTS; ++q) {
            const unsigned wq = wr + q * wpart;
#pragma unroll
            for (int j = 0; j + 1 < NJ; j += 2)
              ldsm_x4_t(wq + (j * 8 + bn) * 2, bf[q][j][0], bf[q][j][1],
                        bf[q][j + 1][0], bf[q][j + 1][1]);
            if constexpr (NJ % 2)
              ldsm_x2_t(wq + (NJ - 1) * 16, bf[q][NJ - 1][0],
                        bf[q][NJ - 1][1]);
          }
#pragma unroll
          for (int q = 0; q < PARTS; ++q) {
#pragma unroll
            for (int i = 0; i < WM; ++i)
              ldsm_x4(hb + (arow[i] + plane + dz) * ROWB + q * CK * 2 +
                          kk * 32,
                      af[i]);
#pragma unroll
            for (int jw = 0; jw < PARTS - q; ++jw)
#pragma unroll
              for (int i = 0; i < WM; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                  mma_bf16(part[i][j], af[i], bf[jw][j][0], bf[jw][j][1]);
          }
        }
      }
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
      }
    }
  }

  // Epilogue: accumulators -> a float32 [M][NT + 4] tile over the halo,
  // and each brick voxel's output offset (-1 outside the volume).
  cp_async_wait<0>();
  __syncthreads();
  constexpr int TS = NT + 4;
  float* tile = reinterpret_cast<float*>(smem);
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem + M * TS * 4);
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int row = (warp * WM + i) * 16 + (lane >> 2);
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(&tile[row * TS + col]) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&tile[(row + 8) * TS + col]) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  for (int m = tid; m < M; m += kThreads) {
    const int mz = m % p.bz, t = m / p.bz;
    const int gx = x0 + t / p.by, gy = y0 + t % p.by, gz = z0 + mz;
    rowoff[m] = m < bvox && gx < p.X && gy < p.Y && gz < p.Z
                    ? voxel(gx, gy, gz) * p.Cout
                    : -1;
  }
  __syncthreads();

  TO* out = static_cast<TO*>(p.out);
  const TR* res = static_cast<const TR*>(p.res);
  if (!p.vec_out) {
    // Element by element: a lane per channel, a warp per voxel.
    for (int m = warp; m < M; m += kWarps) {
      const int64_t base = rowoff[m];
      if (base < 0) continue;
      for (int col = lane; col < NT && co0 + col < p.Cout; col += 32) {
        const int64_t off = base + co0 + col;
        float v = tile[m * TS + col] + p.bias[co0 + col];
        if (res != nullptr) v += ltk_ld(res + off);
        if (p.relu) v = ltk_relu(v);
        ltk_st(out + off, v);
      }
    }
    return;
  }
  // 8 consecutive channels a thread: 16-byte residual loads, one
  // (bfloat16) or two (float32) 16-byte stores.
  constexpr int V = 8, PR = NT / V;
  for (int e = tid; e < M * PR; e += kThreads) {
    const int m = e / PR, col = (e % PR) * V, co = co0 + col;
    const int64_t base = rowoff[m];
    if (base < 0 || co >= p.Cout) continue;
    const int64_t off = base + co;
    const float* src = &tile[m * TS + col];
    float v[V];
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] += p.bias[co + q];
    if (res != nullptr) {
      if constexpr (SPLIT) {
        const float4* rr = reinterpret_cast<const float4*>(res + off);
        const float4 r0 = rr[0], r1 = rr[1];
        v[0] += r0.x, v[1] += r0.y, v[2] += r0.z, v[3] += r0.w;
        v[4] += r1.x, v[5] += r1.y, v[6] += r1.z, v[7] += r1.w;
      } else {
        const uint4 rr = *reinterpret_cast<const uint4*>(res + off);
        const unsigned ru[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ru[q]));
          v[2 * q] += f.x;
          v[2 * q + 1] += f.y;
        }
      }
    }
    if (p.relu) {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = ltk_relu(v[q]);
    }
    if constexpr (sizeof(TO) == 2) {
      unsigned u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        u[q] = *reinterpret_cast<const unsigned*>(&pr);
      }
      *reinterpret_cast<uint4*>(out + off) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      float4* o = reinterpret_cast<float4*>(out + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <int NT, int CK, int KT, int PARTS, typename TO>
int launch(const MmaArgs& a, int smem, int grid, cudaStream_t s) {
  static bool allowed[64] = {};
  const int e = allow_smem(conv3d_mma_kernel<NT, CK, KT, PARTS, TO>, kSmemMax,
                           allowed);
  if (e != 0) return e;
  conv3d_mma_kernel<NT, CK, KT, PARTS, TO><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Whether (NT, CK) has an instance with k a template constant: k = 3 at
// NT = 32 (Cin 16 or 32, Cout 32) and at NT = 64 with CK = 32 (Cin >= 32,
// Cout >= 64), in bfloat16 and in float32 (three parts); k = 7 at NT = 16
// with CK = 32, or CK = 16 in float32 (two parts: the 32 -> 16 front conv,
// whose doubled brick leaves room for CK = 16 only).  Those are the
// flagship V2V's k = 3 / 7 launches with the parts conv3d.split_parts
// gives them; any other launch takes the k = 0 (run-time k) instance.
// Each instance adds build time.
template <int NT, int CK, int PARTS>
constexpr bool unrolled(int k) {
  return k == 3 ? PARTS != 2 && (NT == 32 || (NT == 64 && CK == 32))
                : k == 7 && PARTS != 3 && NT == 16 &&
                      CK == (PARTS == 2 ? 16 : 32);
}

template <int NT, int CK, int PARTS, typename TO>
int launch_k(const MmaArgs& a, int smem, int grid, cudaStream_t s) {
  if constexpr (unrolled<NT, CK, PARTS>(3)) {
    if (a.K == 3) return launch<NT, CK, 3, PARTS, TO>(a, smem, grid, s);
  }
  if constexpr (unrolled<NT, CK, PARTS>(7)) {
    if (a.K == 7) return launch<NT, CK, 7, PARTS, TO>(a, smem, grid, s);
  }
  return launch<NT, CK, 0, PARTS, TO>(a, smem, grid, s);
}

template <int NT, int PARTS, typename TO>
int launch_ck(int ck, const MmaArgs& a, int smem, int grid, cudaStream_t s) {
  return ck == 16 ? launch_k<NT, 16, PARTS, TO>(a, smem, grid, s)
                  : launch_k<NT, 32, PARTS, TO>(a, smem, grid, s);
}

template <int PARTS, typename TO>
int launch_nt(int nt, int ck, const MmaArgs& a, int smem, int grid,
              cudaStream_t s) {
  switch (nt) {
    case 16: return launch_ck<16, PARTS, TO>(ck, a, smem, grid, s);
    case 24: return launch_ck<24, PARTS, TO>(ck, a, smem, grid, s);
    case 32: return launch_ck<32, PARTS, TO>(ck, a, smem, grid, s);
    default: return launch_ck<64, PARTS, TO>(ck, a, smem, grid, s);
  }
}

// The C entry points' common body.  F32 = false: x, w and res bfloat16
// (in_dtype must be kLtkBF16, parts 1).  F32 = true: in_dtype must be
// kLtkF32, parts 2 or 3 (conv3d.split_parts chooses); x and w point to the
// (parts, ...) bfloat16 parts of the float32 input and weights, res is
// float32.  out_dtype: the type of out.  nt, ck, (bx, by, bz), nh, smem
// and grid are the launch plan (conv3d.conv3d_mma_plan); a plan that does
// not fit the shapes is refused with cudaErrorInvalidValue before anything
// runs.
template <int PARTS>
int launch_parts(int out_dtype, int nt, int ck, const MmaArgs& a, int smem,
                 int grid, cudaStream_t s) {
  return out_dtype == kLtkBF16
             ? launch_nt<PARTS, __nv_bfloat16>(nt, ck, a, smem, grid, s)
             : launch_nt<PARTS, float>(nt, ck, a, smem, grid, s);
}

template <bool F32>
int conv3d_mma_entry(const void* x, const void* w, const float* bias,
                     const void* res, void* out, int B, int X, int Y, int Z,
                     int Cin, int Cout, int K, int relu, int in_dtype,
                     int out_dtype, int nt, int ck, int bx, int by, int bz,
                     int nh, int smem, int grid, int parts, void* stream) {
  if (in_dtype != (F32 ? kLtkF32 : kLtkBF16) || out_dtype < 0 ||
      out_dtype > 1)
    return kLtkBadDtype;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (K < 1 || K % 2 == 0 || (nt != 16 && nt != 24 && nt != 32 && nt != 64) ||
      (ck != 16 && ck != 32) || bx < 1 || by < 1 || bz < 1 ||
      bx * by * bz > block_voxels(nt) || nh < 1 ||
      (F32 ? parts != 2 && parts != 3 : parts != 1))
    return bad;
  MmaArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.xpart = static_cast<int64_t>(B) * X * Y * Z * Cin;
  a.wpart = static_cast<int64_t>(K) * K * K * Cin * Cout;
  a.bias = bias;
  a.res = res;
  a.out = out;
  a.X = X, a.Y = Y, a.Z = Z, a.Cin = Cin, a.Cout = Cout, a.K = K;
  a.relu = relu;
  a.bx = bx, a.by = by, a.bz = bz;
  a.tx = (X + bx - 1) / bx, a.ty = (Y + by - 1) / by, a.tz = (Z + bz - 1) / bz;
  a.ntiles = (Cout + nt - 1) / nt;
  a.nchunks = (Cin + ck - 1) / ck;
  a.nh = nh;
  // Halo buffers: chunk c + 1's copy is issued kStages - 1 steps before its
  // first step, and must not land in a buffer that a step still reads; or
  // one buffer, reloaded at each chunk's first step.
  const int need_nh = 1 + (kStages - 2 + K * K) / (K * K);
  const int64_t blocks = static_cast<int64_t>(B) * a.tx * a.ty * a.tz *
                         a.ntiles;
  if ((nh != 1 && nh < (a.nchunks < need_nh ? a.nchunks : need_nh)) ||
      blocks != grid ||
      smem < smem_bytes(nt, ck, K, bx, by, bz, nh, parts) ||
      smem > kSmemMax)
    return bad;
  a.vec_x = Cin % 8 == 0 && aligned16(a.x) &&
            (parts == 1 || aligned16(a.x + a.xpart));
  a.vec_w = Cout % 8 == 0 && aligned16(a.w) &&
            (parts == 1 || aligned16(a.w + a.wpart));
  a.vec_out = Cout % 8 == 0 && aligned16(out) &&
              (res == nullptr || aligned16(res));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (F32)
    return parts == 3 ? launch_parts<3>(out_dtype, nt, ck, a, smem, grid, s)
                      : launch_parts<2>(out_dtype, nt, ck, a, smem, grid, s);
  else
    return launch_parts<1>(out_dtype, nt, ck, a, smem, grid, s);
}

}  // namespace
