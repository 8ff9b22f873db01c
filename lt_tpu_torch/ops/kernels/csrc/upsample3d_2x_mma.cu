// K3, bfloat16, on the tensor cores: ConvTranspose3d(kernel=2, stride=2) +
// folded BN + ReLU [+ skip], NDHWC.
//
//   out[b, 2x+dx, 2y+dy, 2z+dz, co] =
//       relu(sum_ci in[b, x, y, z, ci] * w8[ci, t*Cout + co] + b8[t*Cout + co])
//       (+ skip[b, 2x+dx, 2y+dy, 2z+dz, co]),   t = dx*4 + dy*2 + dz.
//
// x, w8, skip and out bfloat16, b8 float32; the sum, the ReLU and the skip
// add (after the ReLU) in float32, rounded once.  upsample3d_2x.cu keeps
// the float32 body; the wrapper (ops/kernels/updown.py) sends every
// bfloat16 call here.
//
// Replaces lt_tpu/ops/pallas/updown.py:upsample3d_2x (pallas_call at :330
// and :376) and the upsample head of res3d.py:upsample_res3d_fused (:1180).
//
// Bound on the card: bytes.  The function is a per-voxel GEMM,
// (voxels, Cin) @ (Cin, 8 Cout), whose every output is written once and
// whose skip is read once: at Cin = 64 each output takes 128 flops against
// 4 bytes moved (with the skip), 32 flop a byte, far below the H100's 295
// for bfloat16 tensor cores.  The flagship's largest launch (32^3 -> 64^3,
// 64 -> 32 channels, batch 8) writes 134 MB and reads a 134 MB skip.
//
// Design: a GEMM with mma.sync.m16n8k16 (bfloat16 in, float32
// accumulators).
//   - M: a block's tile of 128 consecutive input voxels (flattened NDHWC
//     order; a ragged end is zero-filled and masked), four warps of 32
//     rows.  K: Cin, padded to a multiple of 16, held whole in shared
//     memory: the block copies its A tile once with 16-byte cp.async (zero
//     fill for padding) and reuses it for every N tile it computes.
//   - N: the 2 Cout columns of one (dx, dy) pair, t = 2 * pair + dz, in
//     tiles of NT = 16 / 32 / 64 columns.  Those columns are contiguous in
//     w8, and in the output too: for an input voxel and a pair they are
//     the 2 Cout values of output voxels (.., 2z, ..) and (.., 2z+1, ..),
//     one contiguous run.  A block walks its share of the 4 pairs x N
//     tiles (all of them, or a slice where few M tiles would leave the
//     card idle: the 2^3 - 8^3 levels split the N tiles across blocks),
//     the next step's B tile in flight (a two-slot cp.async ring) while
//     it computes the current one.
//   - Epilogue through shared memory: the accumulators go to a float32
//     tile; each thread then takes 8 consecutive columns of a run, loads
//     its 16-byte skip vectors first (all of them, so the loads overlap),
//     adds bias, applies ReLU, adds the skip, rounds once and stores 16
//     bytes.  Cout % 8 != 0 or misaligned pointers take an element-by-
//     element epilogue; ragged Cout is masked.
// The launch plan (N tile, padded Cin, steps per block, N split, dynamic
// shared memory, grid) is computed in Python (updown.upsample_mma_plan,
// tested on the CPU) and checked here before the launch.

#include "mma.cuh"

namespace {

using namespace ltk_mma;

constexpr int kThreads = 128;     // four warps
constexpr int kM = 128;           // input voxels per block
constexpr int kWM = kM / 64;      // m16 tiles per warp
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

struct UpArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w8;
  const float* b8;
  const __nv_bfloat16* skip;
  __nv_bfloat16* out;
  int64_t nvox;               // B * X * Y * Z input voxels
  int X, Y, Z, Cin, Cout;
  int kp, per, nsplit, steps, ntn;
  int vec_x, vec_w, vec_out;
};

// Bytes of dynamic shared memory: the A tile, the two-slot B ring, the
// epilogue's float32 tile and each row's output offset.
__host__ __device__ constexpr int up_smem_bytes(int nt, int kp) {
  return kM * odd_pitch(kp) + 2 * kp * odd_pitch(nt) + kM * (nt + 4) * 4 +
         kM * 8;
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
upsample3d_2x_mma_kernel(const UpArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NJ = NT / 8;
  constexpr int BROW = odd_pitch(NT);
  constexpr int TS = NT + 4;
  const int AROW = odd_pitch(p.kp);
  unsigned char* atile = smem;
  unsigned char* bring = atile + kM * AROW;
  float* tile = reinterpret_cast<float*>(bring + 2 * p.kp * BROW);
  int64_t* rowoff = reinterpret_cast<int64_t*>(tile + kM * TS);

  const int split = blockIdx.x % p.nsplit;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x / p.nsplit) * kM;
  const int s0 = split * p.per;
  const int s1 = min(s0 + p.per, p.steps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C2 = 2 * p.Cout;      // columns of one (dx, dy) pair
  const int Y2 = 2 * p.Y, Z2 = 2 * p.Z;

  // The block's input voxels, all Cin (padded to kp) channels.
  {
    const int Q = p.kp / 8;
    const int n = p.vec_x ? kM * Q : kM * p.kp;
    for (int e = tid; e < n; e += kThreads) {
      const int m = p.vec_x ? e / Q : e / p.kp;
      const int ci = p.vec_x ? (e % Q) * 8 : e % p.kp;
      const bool ok = v0 + m < p.nvox && ci < p.Cin;
      const __nv_bfloat16* src = ok ? p.x + (v0 + m) * p.Cin + ci : p.x;
      unsigned char* d = atile + m * AROW + ci * 2;
      if (p.vec_x)
        cp_async16(smem_u32(d), src, ok);
      else
        *reinterpret_cast<__nv_bfloat16*>(d) =
            ok ? *src : __float2bfloat16(0.f);
    }
  }
  // Step s: pair s / ntn, columns (s % ntn) * NT + [0, NT) of the pair.
  auto load_b = [&](int s) {
    unsigned char* dst = bring + ((s - s0) & 1) * p.kp * BROW;
    const int col0 = (s / p.ntn) * C2 + (s % p.ntn) * NT;
    const int cend = (s / p.ntn + 1) * C2;
    constexpr int Q = NT / 8;
    const int n = p.vec_w ? p.kp * Q : p.kp * NT;
    for (int e = tid; e < n; e += kThreads) {
      const int ci = p.vec_w ? e / Q : e / NT;
      const int j = p.vec_w ? (e % Q) * 8 : e % NT;
      const bool ok = ci < p.Cin && col0 + j < cend;
      const __nv_bfloat16* src =
          ok ? p.w8 + static_cast<int64_t>(ci) * 4 * C2 + col0 + j : p.w8;
      unsigned char* d = dst + ci * BROW + j * 2;
      if (p.vec_w)
        cp_async16(smem_u32(d), src, ok);
      else
        *reinterpret_cast<__nv_bfloat16*>(d) =
            ok ? *src : __float2bfloat16(0.f);
    }
  };
  load_b(s0);
  cp_async_commit();
  // Output offset of each row's (dx, dy) = (0, 0) run; -1 past the end.
  for (int m = tid; m < kM; m += kThreads) {
    const int64_t v = v0 + m;
    int64_t off = -1;
    if (v < p.nvox) {
      const int z = static_cast<int>(v % p.Z);
      int64_t t = v / p.Z;
      const int y = static_cast<int>(t % p.Y);
      t /= p.Y;
      const int x = static_cast<int>(t % p.X);
      const int64_t b = t / p.X;
      off = (((b * 2 * p.X + 2 * x) * Y2 + 2 * y) * Z2 + 2 * z) * p.Cout;
    }
    rowoff[m] = off;
  }

  const int akoff = (lane >> 4) * 16;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = (lane >> 4) * 8;
  for (int s = s0; s < s1; ++s) {
    if (s + 1 < s1) load_b(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned ab = smem_u32(atile) + akoff;
    const unsigned bb = smem_u32(bring + ((s - s0) & 1) * p.kp * BROW);
    float acc[kWM][NJ][4];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    for (int kk = 0; kk < p.kp / 16; ++kk) {
      unsigned af[kWM][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < kWM; ++i)
        ldsm_x4(ab + ((warp * kWM + i) * 16 + (lane & 15)) * AROW + kk * 32,
                af[i]);
      const unsigned wr = bb + (kk * 16 + bk) * BROW;
#pragma unroll
      for (int j = 0; j < NJ; j += 2)
        ldsm_x4_t(wr + (j * 8 + bn) * 2, bf[j][0], bf[j][1], bf[j + 1][0],
                  bf[j + 1][1]);
#pragma unroll
      for (int i = 0; i < kWM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int row = (warp * kWM + i) * 16 + (lane >> 2);
        const int col = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(&tile[row * TS + col]) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(&tile[(row + 8) * TS + col]) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();

    // This step's columns: pair (dx, dy), run columns n0 + [0, NT).
    const int pair = s / p.ntn, n0 = (s % p.ntn) * NT;
    const int64_t poff =
        (static_cast<int64_t>(pair >> 1) * Y2 + (pair & 1)) * Z2 * p.Cout;
    const float* bias = p.b8 + pair * C2 + n0;
    if (p.vec_out) {
      // kM * NT / 8 groups of 8 columns, NT / 8 a thread: the skip loads
      // first, then the arithmetic and the stores.
      constexpr int G = NT / 8;
      uint4 sk[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = g * kThreads + tid, m = e / G, col = (e % G) * 8;
        sk[g] = make_uint4(0u, 0u, 0u, 0u);
        if (p.skip != nullptr && rowoff[m] >= 0 && n0 + col < C2)
          sk[g] = *reinterpret_cast<const uint4*>(p.skip + rowoff[m] + poff +
                                                  n0 + col);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = g * kThreads + tid, m = e / G, col = (e % G) * 8;
        if (rowoff[m] < 0 || n0 + col >= C2) continue;
        const float* src = &tile[m * TS + col];
        const unsigned su[4] = {sk[g].x, sk[g].y, sk[g].z, sk[g].w};
        unsigned u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 sv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&su[q]));
          const float a =
              ltk_relu(src[2 * q] + bias[col + 2 * q]) + sv.x;
          const float b =
              ltk_relu(src[2 * q + 1] + bias[col + 2 * q + 1]) + sv.y;
          const __nv_bfloat162 pr = __floats2bfloat162_rn(a, b);
          u[q] = *reinterpret_cast<const unsigned*>(&pr);
        }
        *reinterpret_cast<uint4*>(p.out + rowoff[m] + poff + n0 + col) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    } else {
      for (int e = tid; e < kM * NT; e += kThreads) {
        const int m = e / NT, col = e % NT;
        if (rowoff[m] < 0 || n0 + col >= C2) continue;
        const int64_t off = rowoff[m] + poff + n0 + col;
        float v = ltk_relu(tile[m * TS + col] + bias[col]);
        if (p.skip != nullptr) v += __bfloat162float(p.skip[off]);
        p.out[off] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int NT>
int launch(const UpArgs& a, int smem, int grid, cudaStream_t s) {
  static bool allowed[64] = {};
  const int e = allow_smem(upsample3d_2x_mma_kernel<NT>, kSmemMax, allowed);
  if (e != 0) return e;
  upsample3d_2x_mma_kernel<NT><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, X, Y, Z, Cin), w8 (Cin, 8 Cout), skip (optional) and out
// (B, 2X, 2Y, 2Z, Cout) bfloat16 (dtype must be kLtkBF16), b8 (8 Cout)
// float32.  nt, kp, per, nsplit, smem and grid are the launch plan
// (updown.upsample_mma_plan); a plan that does not fit the shapes is
// refused with cudaErrorInvalidValue before anything runs.
extern "C" int upsample3d_2x_mma(const void* x, const void* w8,
                                 const float* b8, const void* skip, void* out,
                                 int B, int X, int Y, int Z, int Cin,
                                 int Cout, int dtype, int nt, int kp, int per,
                                 int nsplit, int smem, int grid,
                                 void* stream) {
  if (dtype != kLtkBF16) return kLtkBadDtype;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || Cin < 1 || Cout < 1 ||
      (nt != 16 && nt != 32 && nt != 64) || kp < Cin || kp % 16 != 0 ||
      per < 1 || nsplit < 1)
    return bad;
  UpArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w8 = static_cast<const __nv_bfloat16*>(w8);
  a.b8 = b8;
  a.skip = static_cast<const __nv_bfloat16*>(skip);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.nvox = static_cast<int64_t>(B) * X * Y * Z;
  a.X = X, a.Y = Y, a.Z = Z, a.Cin = Cin, a.Cout = Cout;
  a.kp = kp, a.per = per, a.nsplit = nsplit;
  a.ntn = (2 * Cout + nt - 1) / nt;
  a.steps = 4 * a.ntn;
  const int64_t mtiles = (a.nvox + kM - 1) / kM;
  if (nsplit != (a.steps + per - 1) / per || mtiles * nsplit != grid ||
      smem < up_smem_bytes(nt, kp) || smem > kSmemMax)
    return bad;
  a.vec_x = Cin % 8 == 0 && aligned16(x);
  a.vec_w = Cout % 4 == 0 && aligned16(w8);
  a.vec_out = Cout % 8 == 0 && aligned16(out) &&
              (skip == nullptr || aligned16(skip));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 16: return launch<16>(a, smem, grid, s);
    case 32: return launch<32>(a, smem, grid, s);
    default: return launch<64>(a, smem, grid, s);
  }
}
