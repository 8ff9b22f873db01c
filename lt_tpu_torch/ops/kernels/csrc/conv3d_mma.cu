// K2, bfloat16 inputs, on the tensor cores: the body of conv3d_mma.cuh
// with x, w and the residual in bfloat16 (see there for the function, the
// TPU kernels it replaces, the bound and the design).  The wrapper
// (ops/kernels/conv3d.py) sends every bfloat16 K2 call here;
// conv3d_mma_f32.cu takes the float32 ones.

#include "conv3d_mma.cuh"

extern "C" int conv3d_mma(const void* x, const void* w, const float* bias,
                          const void* res, void* out, int B, int X, int Y,
                          int Z, int Cin, int Cout, int K, int relu,
                          int in_dtype, int out_dtype, int nt, int ck, int bx,
                          int by, int bz, int nh, int smem, int grid,
                          void* stream) {
  return conv3d_mma_entry<false>(x, w, bias, res, out, B, X, Y, Z, Cin, Cout,
                                 K, relu, in_dtype, out_dtype, nt, ck, bx, by,
                                 bz, nh, smem, grid, 1, stream);
}
