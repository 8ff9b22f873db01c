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
// confidences and all projection and aggregation arithmetic are float32.
//
// Replaces lt_tpu/ops/pallas/unproject.py:_sample_views_agg_impl (pallas_call
// :427; kernel bodies _unproject_agg_kernel :177, _tile_sample_t :256).  As
// there, the (B, V, N, C) per-view samples never reach device memory.
//
// Bound on the card: bytes.  The output volume (B * S^3 * C floats) is
// written once; the features (4.7 MB per sample at 4 x 96 x 96 x 32) are
// read by 4 taps per voxel and view but stay in the 50 MB L2.
//
// Design: one warp per voxel, lanes over channels (C = 32 is one warp), so
// each bilinear tap is one coalesced 128-byte row of the (H, W, C) map and
// each output row one coalesced store.  The projection math is per voxel
// and redundant across the lanes; it is common.cuh's ltk_voxel_taps, which
// K5 and K6 share.  Softmax runs online over the views
// (running max, rescaled sums).  Offsets are 64-bit.

#include "common.cuh"

enum Method { kSoftmax = 0, kSum = 1, kMax = 2, kConf = 3 };

template <typename T>
__global__ void unproject_agg_kernel(
    const T* __restrict__ feats, const float* __restrict__ m,
    const float* __restrict__ mask, const float* __restrict__ conf,
    T* __restrict__ out, int B, int V, int H, int W, int C, int S,
    int method, float sx, float sy) {
  const int lane = threadIdx.x & 31;
  const int64_t N = static_cast<int64_t>(S) * S * S;
  const int64_t total = static_cast<int64_t>(B) * N;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t t = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       t < total; t += nwarps) {
    const int b = static_cast<int>(t / N);
    const int64_t n = t % N;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < C;
      float acc = (method == kMax) ? -INFINITY : 0.f;
      float run_max = -INFINITY, den = 0.f;
      for (int v = 0; v < V; ++v) {
        const int bv = b * V + v;
        float val = 0.f;
        if (active) {
          const LtkTaps tp = ltk_voxel_taps(m + bv * 12, n, S, H, W, sx, sy);
          val = ltk_bilinear(tp, feats + static_cast<int64_t>(bv) * H * W * C + c,
                             C);
        }
        const bool keep = mask[bv] > 0.f;
        if (method == kSoftmax) {
          const float logit = keep ? val : -1e9f;
          const float contrib = keep ? val : 0.f;
          if (logit > run_max) {
            const float scale = expf(run_max - logit);
            den = den * scale + 1.f;
            acc = acc * scale + contrib;
            run_max = logit;
          } else {
            const float e = expf(logit - run_max);
            den += e;
            acc += e * contrib;
          }
        } else if (method == kSum) {
          if (keep) acc += val;
        } else if (method == kMax) {
          acc = fmaxf(acc, keep ? val : -INFINITY);
        } else {  // kConf
          if (keep && active) acc += val * conf[static_cast<int64_t>(bv) * C + c];
        }
      }
      if (method == kSoftmax) acc = acc / den;
      if (method == kMax && isinf(acc) && acc < 0.f) acc = 0.f;
      if (active) ltk_st(out + t * C + c, acc);
    }
  }
}

extern "C" int unproject_agg(const void* feats, const float* m,
                             const float* mask, const float* conf, void* out,
                             int B, int V, int H, int W, int C, int S,
                             int method, float sx, float sy, int dtype,
                             void* stream) {
  const int64_t total = static_cast<int64_t>(B) * S * S * S;
  const int threads = 256;
  const int blocks = ltk_blocks(total, threads / 32, 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kLtkF32)
    unproject_agg_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(feats), m, mask, conf,
        static_cast<float*>(out), B, V, H, W, C, S, method, sx, sy);
  else if (dtype == kLtkBF16)
    unproject_agg_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), m, mask, conf,
        static_cast<__nv_bfloat16*>(out), B, V, H, W, C, S, method, sx, sy);
  else
    return kLtkBadDtype;
  return static_cast<int>(cudaGetLastError());
}
