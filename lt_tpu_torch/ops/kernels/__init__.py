"""Hand-written CUDA kernels of the port, each beside its plain version.

- K1 ``unproject_agg`` (csrc/unproject_agg.cu):
  unproject._sample_views_agg_impl
- K2, on the tensor cores (one body, csrc/conv3d_mma.cuh): ``conv3d_mma``
  (csrc/conv3d_mma.cu, bfloat16 inputs) and ``conv3d_mma_f32`` with
  ``split_bf16`` (csrc/conv3d_mma_f32.cu, float32 inputs as three
  bfloat16 products): conv_mp.conv3d_mp, conv3d.conv3d_same and the
  convolutions of res3d.*, conv_mp.res3d_block_mp, res3d_q4.res3d_block_q4
  and res3d_folded.res3d_block_folded
- K3 ``upsample3d_2x`` (csrc/upsample3d_2x.cu, float32) and
  ``upsample3d_2x_mma`` (csrc/upsample3d_2x_mma.cu, bfloat16, tensor
  cores): updown.upsample3d_2x and the res3d upsample head
- K4 ``max_pool3d_2x`` (csrc/max_pool3d_2x.cu): updown.max_pool3d_2x and
  the res3d pooled outputs
- K5 ``sample_views_t`` (csrc/sample_views_t.cu):
  unproject._sample_views_fwd_impl_t
- K6 ``sample_views_grad_t`` (csrc/sample_views_grad_t.cu):
  unproject._sample_views_grad_features_t
- K7 ``sample_views`` (csrc/sample_views.cu):
  unproject._sample_views_fwd_impl
- K8 ``sample_views_grad`` (csrc/sample_views_grad.cu):
  unproject._sample_views_grad_features

K1-K4 serve the eval forward, in float32 and bfloat16; K1, K5 and K6 the
training step (K5 and K6 in the backward of the fused aggregation,
``unproject.sample_views_agg``); K7 and K8 the voxels-major
``sample.sample_views_affine``.  A wrapper launches its kernel for a CUDA
tensor and takes the plain version only for a CPU tensor.
"""
