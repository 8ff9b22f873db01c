// K3: ConvTranspose3d(kernel=2, stride=2) + folded BN + ReLU [+ skip], NDHWC.
//
//   out[b, 2x+dx, 2y+dy, 2z+dz, co] =
//       relu(sum_ci in[b, x, y, z, ci] * w8[ci, t*Cout + co] + b8[t*Cout + co])
//       (+ skip[b, 2x+dx, 2y+dy, 2z+dz, co]),   t = dx*4 + dy*2 + dz.
//
// The skip is added AFTER the ReLU (the decoder's `up(x) + skip`).  x, w8,
// skip, out and b8 are float32; the sum, the ReLU and the skip add are
// float32.  bfloat16 calls go to the tensor-core body, upsample3d_2x_mma.cu;
// this entry point refuses them.
//
// Replaces lt_tpu/ops/pallas/updown.py:upsample3d_2x (pallas_call at :330
// and :376; kernel bodies _upsample_kernel :205, _upsample_kernel_lanes
// :243) and the upsample head of res3d.py:upsample_res3d_fused (:1180).
//
// Bound on the card: near the float32 balance point of the CUDA cores
// (67 TFLOP/s over 3.35 TB/s, 20 flop a byte).  Each output takes Cin
// multiply-adds against 4 bytes written (8 with the skip): the flagship's
// 32^3 -> 64^3 launch (64 -> 32 channels, with skip, batch 8) moves 603 MB
// (0.18 ms) for 8.6 GFLOP (0.13 ms); 16^3 -> 32^3 (128 -> 64) moves 151 MB
// (0.045 ms) for 4.3 GFLOP (0.064 ms).  So exact float32 on the CUDA cores
// can come near the bound, if the FMAs are not starved of operands.
//
// Design: a register-tiled GEMM, (input voxels, Cin) @ (Cin, 8 Cout), in
// exact float32 with the sum in the order of a plain loop: each output
// starts from 0 and takes fmaf over ci = 0, 1, .., Cin - 1, so its bits do
// not depend on the tiling.
//   - M: a block's 128 consecutive input voxels (flattened NDHWC order; a
//     ragged end is zero-filled and masked).  K: Cin whole.  The block
//     copies its A tile once, with 4-byte cp.async, transposed into
//     shared memory ([ci][voxel], rows padded to 132 floats so that the
//     copy's lanes, 8 channels x 4 voxels, hit 32 banks), and reuses it
//     for every N tile it computes.
//   - N: the 2 Cout columns of one (dx, dy) pair, t = 2 * pair + dz, in
//     tiles of 64.  Those columns are contiguous in w8 and in the output:
//     for an input voxel they are the 2 Cout values of output voxels
//     (.., 2z, ..) and (.., 2z+1, ..), one run.  A block walks its share
//     of the 4 pairs x N tiles (all of them, or a slice at the small
//     levels, where few M tiles would leave the card idle), the next B
//     tile in flight (a two-slot 16-byte cp.async ring) while it computes
//     the current one.
//   - Register tile: 256 threads, each 8 voxels x 4 columns: per ci two
//     16-byte reads of A (its 8 voxels, one row) and one of B feed 32 FMAs.
//   - Epilogue from registers: a thread's 4 columns of a voxel are 16
//     contiguous output bytes; it loads its skip vectors first, then adds
//     bias, applies ReLU, adds the skip and stores 16 bytes.  Cout % 4 != 0
//     or misaligned pointers take an element-by-element epilogue.
// The launch plan (padded Cin, steps per block, N split, dynamic shared
// memory, grid) is computed in Python (updown.upsample_f32_plan, tested on
// the CPU) and checked here before the launch.

#include "common.cuh"

namespace {

using namespace ltk_async;

constexpr int kThreads = 256;     // 16 voxel groups x 16 column groups
constexpr int kM = 128;           // input voxels per block
constexpr int kNT = 64;           // columns per step
constexpr int kAP = kM + 4;       // A row pitch (floats)
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

struct UpArgs {
  const float* x;
  const float* w8;
  const float* b8;
  const float* skip;
  float* out;
  int nvox;                   // B * X * Y * Z input voxels
  int X, Y, Z, Cin, Cout;
  int kp, per, nsplit, steps, ntn;
  int vec_w, vec_out;
};

// Bytes of dynamic shared memory: the transposed A tile, the two-slot B
// ring and each row's output offset.
__host__ __device__ constexpr int up_f32_smem_bytes(int kp) {
  return kp * kAP * 4 + 2 * kp * kNT * 4 + kM * 8;
}

__global__ void __launch_bounds__(kThreads, 2)
upsample3d_2x_kernel(const UpArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* at = reinterpret_cast<float*>(smem);
  float* bring = at + p.kp * kAP;
  int64_t* rowoff = reinterpret_cast<int64_t*>(bring + 2 * p.kp * kNT);

  const int split = blockIdx.x % p.nsplit;
  const int v0 = (blockIdx.x / p.nsplit) * kM;
  const int s0 = split * p.per;
  const int s1 = min(s0 + p.per, p.steps);
  const int tid = threadIdx.x;
  const int C2 = 2 * p.Cout;      // columns of one (dx, dy) pair
  const int Y2 = 2 * p.Y, Z2 = 2 * p.Z;

  // The A tile, transposed: a warp's lanes copy 8 channels of 4 voxels.
  for (int e = tid; e < kM * p.kp; e += kThreads) {
    const int r = e >> 3;
    const int m = r % kM, ci = (r / kM) * 8 + (e & 7);
    const bool ok = v0 + m < p.nvox && ci < p.Cin;
    cp_async4(smem_u32(at + ci * kAP + m),
              ok ? p.x + static_cast<int64_t>(v0 + m) * p.Cin + ci : p.x, ok);
  }
  // Step s: pair s / ntn, columns (s % ntn) * kNT + [0, kNT) of the pair.
  auto load_b = [&](int s) {
    float* dst = bring + ((s - s0) & 1) * p.kp * kNT;
    const int n0 = (s % p.ntn) * kNT;
    const float* wcol = p.w8 + (s / p.ntn) * C2 + n0;
    const int64_t wrow = 4 * static_cast<int64_t>(C2);
    if (p.vec_w) {
      for (int e = tid; e < p.kp * (kNT / 4); e += kThreads) {
        const int ci = e / (kNT / 4), j = (e % (kNT / 4)) * 4;
        const bool ok = ci < p.Cin && n0 + j < C2;
        cp_async16(smem_u32(dst + ci * kNT + j), ok ? wcol + ci * wrow + j
                                                    : p.w8, ok);
      }
    } else {
      for (int e = tid; e < p.kp * kNT; e += kThreads) {
        const int ci = e / kNT, j = e % kNT;
        const bool ok = ci < p.Cin && n0 + j < C2;
        cp_async4(smem_u32(dst + ci * kNT + j), ok ? wcol + ci * wrow + j
                                                   : p.w8, ok);
      }
    }
  };
  load_b(s0);
  cp_async_commit();
  // Output offset of each row's (dx, dy) = (0, 0) run; -1 past the end.
  for (int m = tid; m < kM; m += kThreads) {
    const int v = v0 + m;
    int64_t off = -1;
    if (v < p.nvox) {
      const int z = v % p.Z;
      int t = v / p.Z;
      const int y = t % p.Y;
      t /= p.Y;
      const int x = t % p.X, b = t / p.X;
      off = ((static_cast<int64_t>(b * 2 * p.X + 2 * x) * Y2 + 2 * y) * Z2 +
             2 * z) * p.Cout;
    }
    rowoff[m] = off;
  }

  const int mg = tid >> 4, cg = tid & 15;  // voxels mg*8.., columns cg*4..
  for (int s = s0; s < s1; ++s) {
    if (s + 1 < s1) load_b(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a = at + mg * 8;
    const float* bt = bring + ((s - s0) & 1) * p.kp * kNT + cg * 4;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int ci = 0; ci < p.Cin; ++ci) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + ci * kAP);
      const float4 a1 = *reinterpret_cast<const float4*>(a + ci * kAP + 4);
      const float4 b4 = *reinterpret_cast<const float4*>(bt + ci * kNT);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
    }

    // This step's columns: pair (dx, dy), run columns col + [0, 4).
    const int pair = s / p.ntn, col = (s % p.ntn) * kNT + cg * 4;
    const int64_t poff =
        (static_cast<int64_t>(pair >> 1) * Y2 + (pair & 1)) * Z2 * p.Cout;
    const float* bias = p.b8 + pair * C2 + col;
    if (col < C2 && p.vec_out) {
      float4 sk[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int64_t ro = rowoff[mg * 8 + r];
        sk[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p.skip != nullptr && ro >= 0)
          sk[r] = *reinterpret_cast<const float4*>(p.skip + ro + poff + col);
      }
      const float4 b4 = *reinterpret_cast<const float4*>(bias);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int64_t ro = rowoff[mg * 8 + r];
        if (ro < 0) continue;
        const float4 o = make_float4(
            ltk_relu(acc[r][0] + b4.x) + sk[r].x,
            ltk_relu(acc[r][1] + b4.y) + sk[r].y,
            ltk_relu(acc[r][2] + b4.z) + sk[r].z,
            ltk_relu(acc[r][3] + b4.w) + sk[r].w);
        *reinterpret_cast<float4*>(p.out + ro + poff + col) = o;
      }
    } else if (col < C2) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int64_t ro = rowoff[mg * 8 + r];
        if (ro < 0) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j >= C2) continue;
          const int64_t off = ro + poff + col + j;
          float v = ltk_relu(acc[r][j] + bias[j]);
          if (p.skip != nullptr) v += p.skip[off];
          p.out[off] = v;
        }
      }
    }
    __syncthreads();  // slot (s - s0) & 1 is refilled by step s + 2
  }
  cp_async_wait<0>();
}

}  // namespace

// x (B, X, Y, Z, Cin), w8 (Cin, 8 Cout), b8 (8 Cout), skip (optional) and
// out (B, 2X, 2Y, 2Z, Cout), all float32 (dtype must be kLtkF32).  kp, per,
// nsplit, smem and grid are the launch plan (updown.upsample_f32_plan); a
// plan that does not fit the shapes is refused with cudaErrorInvalidValue
// before anything runs.
extern "C" int upsample3d_2x(const void* x, const void* w8, const float* b8,
                             const void* skip, void* out, int B, int X, int Y,
                             int Z, int Cin, int Cout, int dtype, int kp,
                             int per, int nsplit, int smem, int grid,
                             void* stream) {
  if (dtype != kLtkF32) return kLtkBadDtype;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int64_t nvox = static_cast<int64_t>(B) * X * Y * Z;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || Cin < 1 || Cout < 1 ||
      nvox + kM >= INT32_MAX || kp < Cin || kp % 8 != 0 || per < 1 ||
      nsplit < 1)
    return bad;
  UpArgs a;
  a.x = static_cast<const float*>(x);
  a.w8 = static_cast<const float*>(w8);
  a.b8 = b8;
  a.skip = static_cast<const float*>(skip);
  a.out = static_cast<float*>(out);
  a.nvox = static_cast<int>(nvox);
  a.X = X, a.Y = Y, a.Z = Z, a.Cin = Cin, a.Cout = Cout;
  a.kp = kp, a.per = per, a.nsplit = nsplit;
  a.ntn = (2 * Cout + kNT - 1) / kNT;
  a.steps = 4 * a.ntn;
  const int64_t mtiles = (nvox + kM - 1) / kM;
  if (nsplit != (a.steps + per - 1) / per || mtiles * nsplit != grid ||
      smem < up_f32_smem_bytes(kp) || smem > kSmemMax)
    return bad;
  a.vec_w = Cout % 2 == 0 && aligned16(w8);
  a.vec_out = Cout % 4 == 0 && aligned16(out) && aligned16(b8) &&
              (skip == nullptr || aligned16(skip));
  static bool allowed[64] = {};
  const int e = allow_smem(upsample3d_2x_kernel, kSmemMax, allowed);
  if (e != 0) return e;
  upsample3d_2x_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
