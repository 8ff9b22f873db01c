// K2: 'same' 3D convolution over an NDHWC volume, odd kernel k in {1, 3, 7},
// with the folded-BN bias, an optional residual and an optional ReLU:
//
//   out[n, co] = act( sum_{taps, ci} x[n + tap, ci] * w[tap, ci, co]
//                     + bias[co] (+ res[n, co]) ),   act = relu or identity.
//
// The residual is added BEFORE the ReLU (the Res3D block's
// relu(bn2(conv2(.)) + skip)).  Weights are DHWIO (k, k, k, Cin, Cout).
// x, w and res are float32 or bfloat16 (one type for the three), the bias is
// float32, the sum is float32 and the output float32 or bfloat16, rounded
// once: the Pallas bodies' preferred_element_type=float32 and out_dtype.
//
// Replaces the convolutions inside these TPU kernels:
//   lt_tpu/ops/pallas/conv_mp.py:conv3d_mp (pallas_call :237,
//     _conv_mp_kernel :119)                              k = 7 front conv
//   lt_tpu/ops/pallas/res3d.py:res3d_chain_fused (:742, _res3d_kernel_m2_chain
//     :400, _m2_step :338), res3d_block_fused (:950, _res3d_kernel :119,
//     _res3d_kernel_m2 :202), upsample_res3d_fused (:1180, _ups_res3d_kernel
//     :976)                                  k = 3 convs, k = 1 skip / tail
//   lt_tpu/ops/pallas/conv3d.py:conv3d_same (:205, _conv3d_kernel :66)
//   and the convolutions of conv_mp.py:res3d_block_mp (:442, :258),
//   res3d_q4.py:res3d_block_q4 (:245, :99), res3d_folded.py:res3d_block_folded
//   (:302, :124): other TPU schedules of the same Res3D block.
//
// Bound on the card: operations.  A k=3 32->32 conv does 55 kflop per
// output voxel against 256 bytes moved; float32 on CUDA cores (67 TFLOP/s
// published) is the roof, as this kernel uses no tensor cores; bfloat16
// inputs halve the bytes and leave the operations where they are.
//
// Design (implicit GEMM on CUDA cores, simple first): a block owns VT
// consecutive output voxels x CO_T output channels.  For every tap and
// every 32-channel slice of Cin it gathers the shifted input rows (zero
// outside the volume) into shared memory -- one 128-byte coalesced row per
// voxel -- with the matching 32 x CO_T weight tile, then each of the 256
// threads accumulates a 4-voxel x 4-channel register tile.  Shared memory
// holds float32 whatever the input type (bfloat16 converts on the way in),
// so both types run one inner loop.  Offsets are 64-bit.  Later work: tensor cores (TF32 / bf16 wgmma) and reuse of the
// gathered input across taps.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kCiT = 32;

template <int CO_T, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
conv3d_fused_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                    const float* __restrict__ bias,
                    const TI* __restrict__ res, TO* __restrict__ out,
                    int B, int X, int Y, int Z, int Cin, int Cout, int K,
                    int relu) {
  constexpr int TC = CO_T / 4;          // threads along output channels
  constexpr int TV = kThreads / TC;     // threads along voxels
  constexpr int VT = TV * 4;            // voxels per block
  __shared__ float xs[VT][kCiT + 1];
  __shared__ __align__(16) float ws[kCiT][CO_T];
  __shared__ int vx[VT], vy[VT], vz[VT];

  const int tid = threadIdx.x;
  const int tc = tid % TC, tv = tid / TC;
  const int64_t nvox = static_cast<int64_t>(B) * X * Y * Z;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * VT;
  const int co0 = blockIdx.y * CO_T;
  const int h = (K - 1) / 2;

  for (int i = tid; i < VT; i += kThreads) {
    const int64_t n = v0 + i;
    if (n < nvox) {
      vz[i] = static_cast<int>(n % Z);
      const int64_t r = n / Z;
      vy[i] = static_cast<int>(r % Y);
      vx[i] = static_cast<int>((r / Y) % X);
    } else {
      vx[i] = vy[i] = vz[i] = -(1 << 28);  // never in range
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int dx = 0; dx < K; ++dx) {
    for (int dy = 0; dy < K; ++dy) {
      for (int dz = 0; dz < K; ++dz) {
        const int ox = dx - h, oy = dy - h, oz = dz - h;
        const int64_t shift =
            (static_cast<int64_t>(ox) * Y + oy) * Z + oz;
        const TI* wt =
            w + static_cast<int64_t>((dx * K + dy) * K + dz) * Cin * Cout;
        for (int ci0 = 0; ci0 < Cin; ci0 += kCiT) {
          const int cc = min(kCiT, Cin - ci0);
          for (int e = tid; e < VT * kCiT; e += kThreads) {
            const int i = e / kCiT, ci = e % kCiT;
            const int xx = vx[i] + ox, yy = vy[i] + oy, zz = vz[i] + oz;
            float val = 0.f;
            if (ci < cc && xx >= 0 && xx < X && yy >= 0 && yy < Y &&
                zz >= 0 && zz < Z)
              val = ltk_ld(x + (v0 + i + shift) * Cin + ci0 + ci);
            xs[i][ci] = val;
          }
          for (int e = tid; e < kCiT * CO_T; e += kThreads) {
            const int ci = e / CO_T, co = e % CO_T;
            ws[ci][co] =
                (ci < cc && co0 + co < Cout)
                    ? ltk_ld(wt + static_cast<int64_t>(ci0 + ci) * Cout + co0 + co)
                    : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int ci = 0; ci < kCiT; ++ci) {
            const float4 wv = *reinterpret_cast<const float4*>(&ws[ci][tc * 4]);
            const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float a = xs[tv + TV * i][ci];
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
            }
          }
          __syncthreads();
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t n = v0 + tv + TV * i;
    if (n >= nvox) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tc * 4 + j;
      if (co >= Cout) continue;
      float v = acc[i][j] + bias[co];
      if (res != nullptr) v += ltk_ld(res + n * Cout + co);
      if (relu) v = fmaxf(v, 0.f);
      ltk_st(out + n * Cout + co, v);
    }
  }
}

template <typename TI, typename TO>
static void conv3d_fused_launch(const void* x, const void* w,
                                const float* bias, const void* res, void* out,
                                int B, int X, int Y, int Z, int Cin, int Cout,
                                int K, int relu, cudaStream_t s) {
  const int64_t nvox = static_cast<int64_t>(B) * X * Y * Z;
  const TI* xp = static_cast<const TI*>(x);
  const TI* wp = static_cast<const TI*>(w);
  const TI* rp = static_cast<const TI*>(res);
  TO* op = static_cast<TO*>(out);
  if (Cout <= 16) {
    constexpr int VT = (kThreads / 4) * 4;
    dim3 grid(static_cast<unsigned>((nvox + VT - 1) / VT), 1);
    conv3d_fused_kernel<16, TI, TO><<<grid, kThreads, 0, s>>>(
        xp, wp, bias, rp, op, B, X, Y, Z, Cin, Cout, K, relu);
  } else {
    constexpr int VT = (kThreads / 8) * 4;
    dim3 grid(static_cast<unsigned>((nvox + VT - 1) / VT), (Cout + 31) / 32);
    conv3d_fused_kernel<32, TI, TO><<<grid, kThreads, 0, s>>>(
        xp, wp, bias, rp, op, B, X, Y, Z, Cin, Cout, K, relu);
  }
}

// in_dtype: the type of x, w and res; out_dtype: the type of out.
extern "C" int conv3d_fused(const void* x, const void* w, const float* bias,
                            const void* res, void* out, int B, int X, int Y,
                            int Z, int Cin, int Cout, int K, int relu,
                            int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = in_dtype * 2 + out_dtype;
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return kLtkBadDtype;
  if (key == 0)
    conv3d_fused_launch<float, float>(x, w, bias, res, out, B, X, Y, Z, Cin,
                                      Cout, K, relu, s);
  else if (key == 1)
    conv3d_fused_launch<float, __nv_bfloat16>(x, w, bias, res, out, B, X, Y, Z,
                                              Cin, Cout, K, relu, s);
  else if (key == 2)
    conv3d_fused_launch<__nv_bfloat16, float>(x, w, bias, res, out, B, X, Y, Z,
                                              Cin, Cout, K, relu, s);
  else
    conv3d_fused_launch<__nv_bfloat16, __nv_bfloat16>(
        x, w, bias, res, out, B, X, Y, Z, Cin, Cout, K, relu, s);
  return static_cast<int>(cudaGetLastError());
}
