// Shared by every kernel library of lt_tpu_torch (each .cu is its own .so).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* ltk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks for a grid-stride loop over `total` items, `threads` per block.
static inline int ltk_blocks(int64_t total, int threads, int64_t cap = 1 << 20) {
  int64_t b = (total + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < cap ? b : cap);
}
