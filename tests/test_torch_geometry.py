"""lt_tpu_torch.ops.geometry vs lt_tpu.ops.geometry on the CPU.

The same seeded numpy inputs go through both.  In float64 (``lt_tpu`` under
``jax.enable_x64`` with ``jnp.float32`` read as float64, as
``tests/test_torch_train.py`` runs it) every function agrees to relative
1e-9 of its output's scale: the port's Jacobi eigensolver takes
``lt_tpu``'s rotations in the same order.  In float32 the batched DLT is
held to 0.05 mm of ``lt_tpu``'s, the DLT's gradient to ``jax.grad``'s,
and noiseless projections are recovered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops import geometry as jgeo
from lt_tpu_torch.ops import geometry as geo
from tests.conftest import make_synthetic_cameras
from tests.test_torch_train import _lt_tpu_in_float64

REL64 = 1e-9        # float64 port vs float64 lt_tpu, of the output's scale
MM32 = 0.05         # float32 triangulation vs lt_tpu's, mm


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(seed, b=3, j=17, noise=0.5):
    """Cameras (V = 4) of conftest's ring, points (b, j, 3) and their
    noisy projections (b, V, j, 2), float64."""
    rng = np.random.RandomState(seed)
    proj, *_ = make_synthetic_cameras(4, rng)
    proj = np.broadcast_to(proj.astype(np.float64), (b, 4, 3, 4)).copy()
    pts3d = rng.uniform(-400, 400, (b, j, 3))
    homo = np.concatenate([pts3d, np.ones((b, j, 1))], -1)
    uvw = np.einsum("bvrk,bjk->bvjr", proj, homo)
    pts2d = uvw[..., :2] / uvw[..., 2:] + rng.randn(b, 4, j, 2) * noise
    conf = rng.uniform(0.1, 1.0, (b, 4, j))
    return proj, pts3d, pts2d, conf


def test_camera_matches_lt_tpu():
    """Camera.create, extrinsics, projection, update_after_crop and
    update_after_resize, batched over two cameras, float64: relative 1e-9."""
    rng = np.random.RandomState(0)
    _, R, t, K = make_synthetic_cameras(2, rng)
    R, t, K = R.astype(np.float64), t.astype(np.float64), K.astype(np.float64)
    bbox = np.array([[10.0, 20.0, 90.0, 100.0], [3.0, 4.0, 50.0, 60.0]])
    cam = geo.Camera.create(R, t, K, device="cpu", dtype=torch.float64)
    cam2 = cam.update_after_crop(bbox).update_after_resize((80, 80),
                                                           (40, 60))
    with _lt_tpu_in_float64():
        jcam = jgeo.Camera.create(R, t, K)
        jcam2 = jcam.update_after_crop(bbox).update_after_resize((80, 80),
                                                                 (40, 60))
        for got, ref in ((cam.extrinsics, jcam.extrinsics),
                         (cam.projection, jcam.projection),
                         (cam2.K, jcam2.K), (cam2.projection,
                                             jcam2.projection)):
            assert got.dtype == torch.float64
            assert _rel(got, ref) <= REL64
    assert cam2.t.shape == (2, 3, 1) and cam2.dist is None
    assert torch.equal(cam2.R, cam.R)              # a new camera, R shared
    assert float(cam.K[0, 0, 2]) == pytest.approx(float(K[0, 0, 2]))


def test_camera_create_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = np.eye(3)
    with pytest.raises(RuntimeError, match="cuda"):
        geo.Camera.create(eye, np.zeros(3), eye)
    cam = geo.Camera.create(eye, np.zeros(3), eye, device="cpu")
    assert cam.K.device.type == "cpu" and cam.K.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_project_points_and_reprojection_error_match_lt_tpu(seed):
    """float64: projection and the half reprojection error per (point,
    view), relative 1e-9."""
    proj, pts3d, pts2d, _ = _scene(seed)
    got_p = geo.project_points(_t(proj), _t(pts3d)[:, None])
    got_e = geo.reprojection_error(_t(pts3d), _t(pts2d), _t(proj))
    with _lt_tpu_in_float64():
        ref_p = jgeo.project_points(jnp.asarray(proj),
                                    jnp.asarray(pts3d)[:, None])
        ref_e = jgeo.reprojection_error(jnp.asarray(pts3d),
                                        jnp.asarray(pts2d), jnp.asarray(proj))
    assert _rel(got_p, ref_p) <= REL64
    assert got_e.shape == (3, 17, 4)
    assert _rel(got_e, ref_e) <= REL64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smallest_eigenvector_matches_lt_tpu(seed):
    """The 8-sweep Jacobi on 64 symmetric 4x4 matrices, float64: the same
    rotations, so the same vector (sign included) to relative 1e-9; and the
    eigenvector of numpy's smallest eigenvalue up to sign."""
    a = np.random.RandomState(seed).randn(64, 4, 4)
    m = a @ a.transpose(0, 2, 1)
    got = geo.smallest_eigenvector_sym4(_t(m))
    with _lt_tpu_in_float64():
        ref = jgeo.smallest_eigenvector_sym4(jnp.asarray(m))
    assert _rel(got, ref) <= REL64
    _, vecs = np.linalg.eigh(m)
    cos = np.abs((got.numpy() * vecs[..., 0]).sum(-1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-9)


@pytest.mark.parametrize("method", ["jacobi", "svd"])
@pytest.mark.parametrize("with_conf", [False, True])
def test_triangulate_batch_dlt_matches_lt_tpu_in_float64(method, with_conf):
    """The design matrix and the batched DLT, float64, relative 1e-9."""
    proj, _, pts2d, conf = _scene(3)
    c = conf if with_conf else None
    got_a = geo.dlt_design_matrix(_t(proj[:, None]), _t(pts2d).transpose(1, 2),
                                  None if c is None else _t(c).transpose(1, 2))
    got = geo.triangulate_batch_dlt(_t(proj), _t(pts2d),
                                    None if c is None else _t(c), method)
    with _lt_tpu_in_float64():
        jc = None if c is None else jnp.asarray(c)
        ref_a = jgeo.dlt_design_matrix(
            jnp.asarray(proj)[:, None], jnp.asarray(pts2d).swapaxes(1, 2),
            None if jc is None else jc.swapaxes(1, 2))
        ref = jgeo.triangulate_batch_dlt(jnp.asarray(proj),
                                         jnp.asarray(pts2d), jc, method)
    assert _rel(got_a, ref_a) <= REL64
    assert got.shape == (3, 17, 3) and got.dtype == torch.float64
    assert _rel(got, ref) <= REL64


def test_triangulate_batch_dlt_float32_within_0_05_mm_of_lt_tpu():
    """float32 on both sides, noisy points and confidences: within 0.05 mm
    of lt_tpu's Jacobi DLT."""
    proj, _, pts2d, conf = (a.astype(np.float32) for a in _scene(4))
    got = geo.triangulate_batch_dlt(_t(proj), _t(pts2d), _t(conf))
    ref = np.asarray(jgeo.triangulate_batch_dlt(
        jnp.asarray(proj), jnp.asarray(pts2d), jnp.asarray(conf)))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= MM32


def test_triangulation_recovers_noiseless_points():
    """float32 Jacobi DLT of noiseless projections: every point within 0.1
    mm (lt_tpu's own limit, tests/test_geometry.py); a view with a 40 px
    error and confidence 1e-6 changes nothing measurable, the same view at
    equal confidence moves the points."""
    proj, pts3d, pts2d, _ = (a.astype(np.float32) for a in
                             _scene(5, noise=0.0))
    rec = geo.triangulate_batch_dlt(_t(proj), _t(pts2d)).numpy()
    np.testing.assert_allclose(rec, pts3d, atol=0.1)
    bad = pts2d.copy()
    bad[:, 0] += 40.0
    conf = np.ones(pts2d.shape[:-1], np.float32)
    conf[:, 0] = 1e-6
    rec = geo.triangulate_batch_dlt(_t(proj), _t(bad), _t(conf)).numpy()
    np.testing.assert_allclose(rec, pts3d, atol=1.0)
    assert np.abs(geo.triangulate_batch_dlt(_t(proj), _t(bad)).numpy()
                  - pts3d).max() > 1.0


def test_dlt_gradient_matches_jax_grad():
    """d sum(kp3d * w) / d (points, confidences) of the Jacobi DLT, float64:
    the port's autograd within relative 1e-8 of lt_tpu's jax.grad."""
    proj, _, pts2d, conf = _scene(6, b=2, j=5)
    w = np.random.RandomState(7).randn(2, 5, 3)
    pts, cf = _t(pts2d).requires_grad_(), _t(conf).requires_grad_()
    (geo.triangulate_batch_dlt(_t(proj), pts, cf) * _t(w)).sum().backward()
    with _lt_tpu_in_float64():
        def loss(p, c):
            return (jgeo.triangulate_batch_dlt(jnp.asarray(proj), p, c)
                    * jnp.asarray(w)).sum()

        gp, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts2d),
                                                jnp.asarray(conf))
    assert _rel(pts.grad, gp) <= 1e-8
    assert _rel(cf.grad, gc) <= 1e-8
    assert float(pts.grad.abs().max()) > 0


def test_numpy_dlt_is_lt_tpus():
    """The port's own numpy DLT equals lt_tpu's (both float64 SVD) to
    1e-12 of the point's scale, and the batched Jacobi DLT within 0.05 mm."""
    proj, _, pts2d, _ = _scene(8, b=1, j=5, noise=1.0)
    for i in range(5):
        got = geo.triangulate_point_dlt_np(proj[0], pts2d[0, :, i])
        ref = jgeo.triangulate_point_dlt_np(proj[0], pts2d[0, :, i])
        assert _rel(got, ref) <= 1e-12
    batched = geo.triangulate_batch_dlt(_t(proj), _t(pts2d)).numpy()[0]
    for i in range(5):
        np.testing.assert_allclose(
            batched[i], geo.triangulate_point_dlt_np(proj[0], pts2d[0, :, i]),
            atol=MM32)
