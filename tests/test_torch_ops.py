"""lt_tpu_torch ops vs lt_tpu on the CPU: coordinate volumes, the plain
unprojection, the fused unprojection (kernel K1's plain version) against
the Pallas kernel in interpret mode, its edge cases, and the soft-argmax.

Inputs come from numpy seeds and pass between the frameworks as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops import heatmaps as j_hm
from lt_tpu.ops import volumetric as j_vol
from lt_tpu.ops.pallas.unproject import \
    unproject_heatmaps_affine as j_unproject_affine
from lt_tpu_torch.ops import heatmaps as t_hm
from lt_tpu_torch.ops import volumetric as t_vol
from lt_tpu_torch.ops.kernels.unproject import \
    unproject_heatmaps_affine as t_unproject_affine

METHODS = ["softmax", "sum", "max", "conf"]
# Unprojected values are O(1) sums of f32 products; the two frameworks
# round in other orders, which stays far inside 1e-5.
ATOL = 1e-5
# The Pallas kernel's float32 mode samples through a three-term bfloat16
# split (hi*hi + hi*lo + lo*hi, unproject.py:306-312), which drops the
# lo*lo term: ~2^-16 relative per product.  On these O(5) volumes it sits
# 2-3e-5 from lt_tpu's own XLA path, so it is held at 5e-5.
PALLAS_ATOL = 5e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("thetas, axis, transfer", [
    (None, (0.0, 0.0, 1.0), False),
    ((0.3, 2.1), (0.0, 0.0, 1.0), False),
    ((1.0, 4.0), (0.0, 1.0, 0.0), True),
])
def test_coord_volumes_match_jax(thetas, axis, transfer):
    rng = np.random.RandomState(0)
    base = rng.uniform(-500, 500, (2, 3)).astype(np.float32)
    th = None if thetas is None else np.asarray(thetas, np.float32)
    args = (2500.0, 8, th, axis, transfer)
    ref_aff = j_vol.coord_volume_affine(jnp.asarray(base), *args)
    ref_cv = j_vol.build_coord_volumes(jnp.asarray(base), *args)
    targs = (2500.0, 8, None if th is None else _t(th), axis, transfer)
    got_aff = t_vol.coord_volume_affine(_t(base), *targs)
    got_cv = t_vol.build_coord_volumes(_t(base), *targs)
    # World mm are sums of terms up to ~2e3 mm, whose float32 spacing is
    # 1.2e-4: the two frameworks' summation orders differ by a few ulps.
    np.testing.assert_allclose(_np(got_aff), np.asarray(ref_aff), atol=1e-3)
    np.testing.assert_allclose(_np(got_cv), np.asarray(ref_cv), atol=1e-3)


def _scene(seed=0, b=2, v=3, h=12, w=10, c=8, s=8):
    """Features on a non-square map and cameras that see most of an S^3
    grid whose world coordinates equal the grid indices (spacing 1)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, v, h, w, c).astype(np.float32)
    proj = np.zeros((b, v, 3, 4), np.float32)
    proj[..., 0, :] = [1.2, 0.2, 0.1, 0.3]
    proj[..., 1, :] = [0.1, 1.3, 0.15, 0.2]
    proj[..., 2, :] = [0.02, 0.01, 0.015, 1.0]
    proj += rng.uniform(-0.05, 0.05, proj.shape).astype(np.float32)
    base = np.full((b, 3), (s - 1) / 2.0, np.float32)   # offset 0
    conf = rng.uniform(0.1, 1.0, (b, v, c)).astype(np.float32)
    mask = np.ones((b, v), np.float32)
    mask[0, 1] = 0.0
    return feats, proj, base, conf, mask, float(s - 1), s


def _run_all(feats, proj, base, conf, mask, side, s, method, use_mask):
    """(port plain, port fused, jax xla, jax pallas) as (B, C, S, S, S)."""
    vc = conf if method == "conf" else None
    vm = mask if use_mask else None
    cv = t_vol.build_coord_volumes(_t(base), side, s)
    aff = t_vol.coord_volume_affine(_t(base), side, s)
    plain = t_vol.unproject_heatmaps(
        _t(feats), _t(proj), cv, method,
        None if vc is None else _t(vc), None if vm is None else _t(vm))
    fused = t_unproject_affine(
        _t(feats), _t(proj), aff, s, method,
        None if vc is None else _t(vc), None if vm is None else _t(vm))
    jb = jnp.asarray(base)
    j_cv = j_vol.build_coord_volumes(jb, side, s)
    j_aff = j_vol.coord_volume_affine(jb, side, s)
    jvc = None if vc is None else jnp.asarray(vc)
    jvm = None if vm is None else jnp.asarray(vm)
    xla = j_vol.unproject_heatmaps(jnp.asarray(feats), jnp.asarray(proj),
                                   j_cv, method, jvc, jvm)
    pallas = j_unproject_affine(
        jnp.asarray(feats), jnp.asarray(proj), j_aff, s,
        volume_aggregation_method=method, vol_confidences=jvc,
        view_mask=jvm, fuse_aggregation=True, interpret=True)
    return _np(plain), _np(fused), np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_unproject_matches_jax(method, use_mask):
    plain, fused, xla, pallas = _run_all(*_scene(), method, use_mask)
    assert np.abs(xla).max() > 0.1   # the cameras see the grid
    np.testing.assert_allclose(plain, xla, atol=ATOL)
    np.testing.assert_allclose(fused, pallas, atol=PALLAS_ATOL)
    np.testing.assert_allclose(fused, xla, atol=ATOL)


@pytest.mark.parametrize("method", METHODS)
def test_unproject_edge_cases_match_jax(method):
    """Voxels behind every camera (w < 0), voxels with w == 0 exactly, and
    a sample whose views are all masked."""
    feats, proj, base, conf, mask, side, s = _scene(seed=1)
    # View 0 of sample 1: w = gx - 3 (zero on the plane gx = 3, negative
    # below it); view 2: w = gx - 5 as well, so the slab gx < 3 lies behind
    # every camera that still has positive depth elsewhere.
    proj[1, :, 2, :] = [1.0, 0.0, 0.0, -3.0]
    proj[1, 2, 2, :] = [1.0, 0.0, 0.0, -5.0]
    mask[0, :] = 0.0                 # every view of sample 0 masked
    plain, fused, xla, pallas = _run_all(feats, proj, base, conf, mask,
                                         side, s, method, use_mask=True)
    assert np.all(pallas[1, :, :3] == 0.0)       # behind all cameras
    for got in (plain, fused):
        np.testing.assert_allclose(got, xla, atol=ATOL)
        np.testing.assert_allclose(got, pallas, atol=PALLAS_ATOL)


@pytest.mark.parametrize("softmax", [True, False])
def test_soft_argmax_matches_jax(softmax):
    rng = np.random.RandomState(3)
    vols = (rng.randn(2, 6, 6, 6, 5) * 3).astype(np.float32)    # NDHWC
    cv = rng.uniform(-1000, 1000, (2, 6, 6, 6, 3)).astype(np.float32)
    ref_k, ref_v = j_hm.integrate_tensor_3d_with_coordinates_channels_last(
        jnp.asarray(vols), jnp.asarray(cv), softmax=softmax)
    got_k, got_v = t_hm.integrate_tensor_3d_with_coordinates_channels_last(
        _t(vols), _t(cv), softmax=softmax)
    np.testing.assert_allclose(_np(got_v), np.asarray(ref_v), atol=ATOL)
    # Keypoints are expectations of mm coordinates of magnitude ~1e3.
    np.testing.assert_allclose(_np(got_k), np.asarray(ref_k), rtol=1e-5,
                               atol=1e-3)

    vols_cf = np.moveaxis(vols, -1, 1)
    ref_k, ref_v = j_hm.integrate_tensor_3d_with_coordinates(
        jnp.asarray(vols_cf), jnp.asarray(cv), softmax=softmax)
    got_k, got_v = t_hm.integrate_tensor_3d_with_coordinates(
        _t(vols_cf), _t(cv), softmax=softmax)
    np.testing.assert_allclose(_np(got_v), np.asarray(ref_v), atol=ATOL)
    np.testing.assert_allclose(_np(got_k), np.asarray(ref_k), rtol=1e-5,
                               atol=1e-3)
