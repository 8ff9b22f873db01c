"""The port's analytic FLOP counts (lt_tpu_torch/utils/flops.py) against
lt_tpu's (lt_tpu/utils/flops.py), exactly: every public function at the
flagship shapes (ResNet-152 at 384^2, 4 views, 64^3: 602.1 GFLOP/frame)
and at bench.py's --quick shapes (ResNet-18 at 128^2, 32^3), and the
backbone count at every depth with and without its heads.  Both modules
are plain Python arithmetic, so equal means bit for bit."""

import pytest

from lt_tpu.utils import flops as j_flops
from lt_tpu_torch.utils import flops

# (num_layers, image_size, volume_size, n_views, num_joints)
SHAPES = {"flagship": (152, 384, 64, 4, 17), "quick": (18, 128, 32, 4, 17)}


@pytest.mark.parametrize("shape", SHAPES)
def test_vol_pipeline_flops_equal_lt_tpu(shape):
    layers, image, volume, views, joints = SHAPES[shape]
    got = flops.vol_pipeline_flops(layers, image, volume, views, joints)
    ref = j_flops.vol_pipeline_flops(layers, image, volume, views, joints)
    assert got == ref
    if shape == "flagship":
        assert round(got["total"] / 1e9, 1) == 602.1


@pytest.mark.parametrize("shape", SHAPES)
def test_v2v_and_unproject_flops_equal_lt_tpu(shape):
    _, _, volume, views, joints = SHAPES[shape]
    assert flops.v2v_flops(volume, joints) == j_flops.v2v_flops(volume, joints)
    assert flops.v2v_flops(volume, 19, 16) == j_flops.v2v_flops(volume, 19, 16)
    assert (flops.unproject_flops(volume, views)
            == j_flops.unproject_flops(volume, views))
    assert (flops.unproject_flops(volume, 2, 64)
            == j_flops.unproject_flops(volume, 2, 64))


@pytest.mark.parametrize("layers", sorted(j_flops.RESNET_SPEC))
@pytest.mark.parametrize("image", (128, 384))
def test_pose_resnet_flops_equal_lt_tpu(layers, image):
    for head, conf in ((True, False), (False, False), (True, True)):
        assert flops.pose_resnet_flops(layers, image, 17, head, conf) == \
            j_flops.pose_resnet_flops(layers, image, 17, head, conf)
    assert flops.RESNET_SPEC == j_flops.RESNET_SPEC
