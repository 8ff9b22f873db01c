"""lt_tpu_torch models vs lt_tpu on the CPU: the RN-18 backbone, V2V at
32^3 (fused composition and unfused graph), and the whole volumetric model
(RN-18, 128^2, 32^3, B=1, V=4) at random init and on the committed trained
fixture, with weights moved through ``lt_tpu_torch.utils.weights``.

JAX runs its XLA path here (the Pallas gates need a TPU).  Tolerances:
relative 1e-4 of the output scale for features and volumes, 0.05 mm for
keypoints.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from lt_tpu.data.synthetic import SyntheticMultiViewDataset
from lt_tpu.models.backbone import PoseResNet as JPoseResNet
from lt_tpu.models.triangulation import \
    VolumetricTriangulationNet as JVolNet
from lt_tpu.models.v2v import V2VModel as JV2V
from lt_tpu.utils.fixture import load_model_npz
from lt_tpu.utils.torch_import import import_pose_resnet, import_v2v
from lt_tpu_torch.models.backbone import PoseResNet
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.models.v2v import V2VModel
from lt_tpu_torch.utils.weights import (load_volumetric_npz,
                                        volumetric_state_dict)

FIXTURE = "tests/fixtures/vol_rn18_synth.npz"
REL = 1e-4
KP_ATOL_MM = 0.05


def _sd_numpy(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _close(got, ref, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def test_backbone_rn18_matches_jax():
    port = PoseResNet(17, 18, vol_confidences=True, device="cpu", seed=3)
    variables = import_pose_resnet(_sd_numpy(port), 18, 17)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    hm, feats, _, vconf = JPoseResNet(17, 18, vol_confidences=True).apply(
        variables, jnp.asarray(x), train=False)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got[0].permute(0, 2, 3, 1), hm)
    _close(got[1].permute(0, 2, 3, 1), feats)
    _close(got[3], vconf)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_v2v_matches_jax(use_kernels):
    port = V2VModel(32, 17, use_kernels=use_kernels, device="cpu", seed=4)
    variables = import_v2v(_sd_numpy(port))
    x = np.random.RandomState(1).randn(1, 32, 32, 32, 32).astype(np.float32)
    ref = jax.jit(functools.partial(JV2V(17).apply, train=False))(
        variables, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), ref)


@functools.lru_cache(maxsize=None)
def _jax_forward():
    model = JVolNet(num_joints=17, num_layers=18, volume_size=32,
                    cuboid_side=2500.0, volume_aggregation_method="softmax",
                    kind="mpii")

    @jax.jit
    def forward(variables, images, proj, pelvis):
        out = model.apply(variables, images, proj, pelvis, train=False)
        return out.keypoints_3d, out.volumes

    return model, forward


def _compare_volumetric(variables, images, proj, pelvis):
    """Port (kernel path, then the plain reference path) vs JAX."""
    _, forward = _jax_forward()
    ref_kp, ref_vol = forward(variables, jnp.asarray(images),
                              jnp.asarray(proj), jnp.asarray(pelvis))
    sd = volumetric_state_dict(variables, 18)
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in (images, proj, pelvis)]
    for use_kernels in (True, False):
        port = VolumetricTriangulationNet(
            num_joints=17, num_layers=18, volume_size=32, cuboid_side=2500.0,
            use_kernels=use_kernels, device="cpu")
        port.load_state_dict(sd)
        out = port(*args)
        np.testing.assert_allclose(out.keypoints_3d.numpy(),
                                   np.asarray(ref_kp), atol=KP_ATOL_MM)
        _close(out.volumes, ref_vol)
    return np.asarray(ref_kp)


def test_volumetric_random_init_matches_jax():
    model, _ = _jax_forward()
    images, proj, pelvis = _example_batch(1, 4, 128, 17, seed=5)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        jnp.asarray(images), jnp.asarray(proj), jnp.asarray(pelvis))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    _compare_volumetric(variables, images, proj, pelvis)


def test_volumetric_trained_fixture_matches_jax():
    """The committed two-stage fixture on a held-out synthetic sample:
    trained weights give peaked volumes, and the port must agree with JAX
    on them (and land near the ground truth)."""
    ds = SyntheticMultiViewDataset(n_samples=3, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    sample = ds[2]
    images = np.stack(sample["images"])[None].astype(np.float32)
    proj = np.stack(sample["proj_matrices"])[None]
    gt = sample["keypoints_3d"][None, :, :3]
    variables = load_model_npz(FIXTURE)
    kp = _compare_volumetric(variables, images, proj, gt)
    rel_mpjpe = np.linalg.norm((kp - kp[:, 6:7]) - (gt - gt[:, 6:7]),
                               axis=-1).mean()
    assert rel_mpjpe < 80.6, rel_mpjpe   # under the 32^3 voxel pitch


def test_load_volumetric_npz_matches_state_dict_path():
    port = VolumetricTriangulationNet(num_layers=18, volume_size=32,
                                      device="cpu")
    load_volumetric_npz(port, FIXTURE, num_layers=18)
    ref = volumetric_state_dict(load_model_npz(FIXTURE), 18)
    for k, v in port.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_volumetric_fixture_val_mpjpe_under_gate():
    """The port's own accuracy on the committed fixture's 8 held-out
    validation poses (the config of experiments/synthetic/vol_tiny_2stage
    .yaml, GT pelvis): rel MPJPE under the 65 mm gate of lt_tpu's slow
    eval test, which measured 38.98 mm on the same fixture."""
    ds = SyntheticMultiViewDataset(n_samples=8, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    samples = [ds[i] for i in range(len(ds))]
    images = torch.from_numpy(np.stack(
        [np.stack(s["images"]) for s in samples]).astype(np.float32))
    proj = torch.from_numpy(np.stack(
        [np.stack(s["proj_matrices"]) for s in samples]))
    gt = torch.from_numpy(np.stack([s["keypoints_3d"][:, :3]
                                    for s in samples]))
    port = VolumetricTriangulationNet(num_layers=18, volume_size=32,
                                      device="cpu")
    load_volumetric_npz(port, FIXTURE, num_layers=18)
    metric, _ = ds.evaluate(port(images, proj, gt).keypoints_3d.numpy())
    assert np.isfinite(metric) and metric < 65.0, metric
