"""lt_tpu_torch.ops.heatmaps vs lt_tpu.ops.heatmaps on the CPU: the 2D and
3D soft-argmax (softmax and ReLU normalization) and Gaussian rendering,
float32 on both sides from the same seeded numpy inputs, within 1e-6 of
each output's scale (absolute 1e-6 for the normalized maps, whose values
are at most 1).  A bfloat16 input is widened to float32 as in ``lt_tpu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops import heatmaps as jhm
from lt_tpu_torch.ops import heatmaps as hm

TOL = 1e-6


def _close(got, ref, tol=TOL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("shape, scale", [((2, 3, 5, 16, 12), 100.0),
                                          ((4, 7, 9), 1.0)])
def test_integrate_tensor_2d_matches_lt_tpu(shape, scale, softmax):
    """Coordinates (x, y) in heatmap pixels and the normalized maps; the
    first shape is the algebraic model's (B, V, J, h, w) times its
    heatmap multiplier."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * scale
    if not softmax:
        x = np.abs(x) + 0.1                   # positive mass everywhere
    coords, maps = hm.integrate_tensor_2d(torch.from_numpy(x), softmax)
    jc, jm = jhm.integrate_tensor_2d(jnp.asarray(x), softmax)
    assert coords.shape == shape[:-2] + (2,)
    _close(coords, jc)
    _close(maps, jm)


@pytest.mark.parametrize("softmax", [True, False])
def test_integrate_tensor_3d_matches_lt_tpu(softmax):
    x = np.random.RandomState(1).randn(2, 3, 6, 5, 7).astype(np.float32)
    if not softmax:
        x = np.abs(x) + 0.1
    coords, vols = hm.integrate_tensor_3d(torch.from_numpy(x), softmax)
    jc, jv = jhm.integrate_tensor_3d(jnp.asarray(x), softmax)
    assert coords.shape == (2, 3, 3)
    _close(coords, jc)
    _close(vols, jv)


def test_integrate_tensor_2d_widens_bfloat16():
    """A bfloat16 input gives float32 coordinates equal to the float32
    soft-argmax of its values, as lt_tpu's (which casts to float32)."""
    x = torch.randn(2, 5, 8, 8, generator=torch.Generator().manual_seed(2))
    xb = x.to(torch.bfloat16)
    coords, maps = hm.integrate_tensor_2d(xb * 10.0)
    assert coords.dtype == maps.dtype == torch.float32
    ref, _ = jhm.integrate_tensor_2d(jnp.asarray((xb * 10.0).float().numpy()))
    _close(coords, ref)


@pytest.mark.parametrize("normalize", [True, False])
def test_render_points_as_2d_gaussians_matches_lt_tpu(normalize):
    """(B, J, 2) points with per-axis sigmas on a non-square (H, W) grid;
    and gaussian_2d_pdf on its own."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(0, 20, (2, 4, 2)).astype(np.float32)
    sig = rng.uniform(1.0, 3.0, (2, 4, 2)).astype(np.float32)
    got = hm.render_points_as_2d_gaussians(torch.from_numpy(pts),
                                           torch.from_numpy(sig), (18, 24),
                                           normalize)
    ref = jhm.render_points_as_2d_gaussians(jnp.asarray(pts), jnp.asarray(sig),
                                            (18, 24), normalize)
    assert got.shape == (2, 4, 18, 24)
    _close(got, ref)
    c = rng.randn(5, 2).astype(np.float32)
    _close(hm.gaussian_2d_pdf(*(torch.from_numpy(a) for a in (c, pts[0, :1],
                                                              sig[0, :1]))),
           jhm.gaussian_2d_pdf(jnp.asarray(c), jnp.asarray(pts[0, :1]),
                               jnp.asarray(sig[0, :1])))


def test_soft_argmax_of_a_peak_is_the_peak():
    """A sharp peak at (x, y) = (9, 4) gives (9, 4) within 1e-3 px in 2D;
    at voxel (1, 2, 3) gives (1, 2, 3) in 3D."""
    maps = torch.full((1, 1, 8, 12), -1e4)
    maps[0, 0, 4, 9] = 0.0
    coords, _ = hm.integrate_tensor_2d(maps)
    torch.testing.assert_close(coords[0, 0], torch.tensor([9.0, 4.0]),
                               rtol=0, atol=1e-3)
    vols = torch.full((1, 1, 4, 5, 6), -1e4)
    vols[0, 0, 1, 2, 3] = 0.0
    coords, _ = hm.integrate_tensor_3d(vols)
    torch.testing.assert_close(coords[0, 0], torch.tensor([1.0, 2.0, 3.0]),
                               rtol=0, atol=1e-3)
