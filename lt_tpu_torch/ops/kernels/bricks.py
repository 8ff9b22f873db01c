"""The voxel bricks of K1 (``csrc/unproject_agg.cu``), K5 and K6
(``csrc/sample_brick.cuh``), the constants that their C sources spell out
again and their launch plans (``unproject.unproject_plan``,
``sample.sample_plan``) read.
"""

#: The channels one block takes: a grid z of ceil(C / AGG_CHUNK).
AGG_CHUNK = 32
#: The shared memory one block may hold on the H100, in bytes.
AGG_SMEM_MAX = 232448
#: The brick of voxels (x, y, z) one block of K1 or K6 takes, a voxel a
#: thread.
AGG_BRICK = (4, 8, 8)
