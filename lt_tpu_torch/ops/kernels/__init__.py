"""Hand-written CUDA kernels of the port, each beside its plain version.

=================  ====================  ====================================
kernel             source                TPU kernels it serves
=================  ====================  ====================================
K1 unproject_agg   csrc/unproject_agg.cu unproject.py:_sample_views_agg_impl
K2 conv3d_fused    csrc/conv3d_fused.cu  conv_mp.conv3d_mp, res3d.* convs
K3 upsample3d_2x   csrc/upsample3d_2x.cu updown.upsample3d_2x, res3d ups head
K4 max_pool3d_2x   csrc/max_pool3d_2x.cu updown.max_pool3d_2x, emit_pooled
=================  ====================  ====================================

A wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""
