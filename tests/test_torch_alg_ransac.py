"""The algebraic and RANSAC model families of lt_tpu_torch vs lt_tpu on the
CPU, float32, from the same seeded numpy inputs, with lt_tpu's variables
carried into the port by ``lt_tpu_torch.utils.weights``.

At random weights (RN-18, 64^2 images, 5 joints, 4 views, batch 2) the
algebraic model's 2D keypoints agree within 1e-3 px, its 3D keypoints
within 0.05 mm, its confidences within 1e-6 and its soft heatmaps within
1e-4 (a multiplier of 100 amplifies the backbone's rounding).  RANSAC takes
a hard argmax of the raw heatmaps, which random weights leave flat enough
for rounding to move: it is compared on the committed trained backbone
(``tests/fixtures/backbone_rn18_synth.npz``, peaked heatmaps), where the
argmax pixels are equal and the 3D keypoints within 0.05 mm.
``ransac_triangulate`` is compared on planted points with an outlier view.
A masked view equals a dropped one in both families.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.models import triangulation as jtri
from lt_tpu.ops import geometry as jgeo
from lt_tpu.utils.fixture import load_backbone_npz
from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
from lt_tpu_torch.engine import factory
from lt_tpu_torch.models import triangulation as tri
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_batch
from lt_tpu_torch.utils.weights import (algebraic_state_dict,
                                        load_backbone_npz as port_backbone,
                                        load_ransac_npz)
from tests.conftest import make_synthetic_cameras

B, V, IMG, J = 2, 4, 64, 5
KP2D_PX = 1e-3
KP3D_MM = 0.05
CONF_TOL = 1e-6
HEATMAP_TOL = 1e-4
FIXTURE = "tests/fixtures/backbone_rn18_synth.npz"
CONFIGS = ["experiments/human36m/train/human36m_alg.yaml",
           "experiments/human36m/train/human36m_alg_no_conf.yaml",
           "experiments/human36m/eval/human36m_alg.yaml",
           "experiments/human36m/eval/human36m_ransac.yaml",
           "experiments/synthetic/alg_tiny.yaml",
           "experiments/synthetic/alg_pretrain.yaml"]


def _err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max())


@functools.lru_cache(maxsize=None)
def _inputs():
    """Images (B, V, 64, 64, 3) and conftest's ring of cameras."""
    rng = np.random.RandomState(11)
    proj, *_ = make_synthetic_cameras(V, rng)
    images = rng.randn(B, V, IMG, IMG, 3).astype(np.float32)
    return images, np.broadcast_to(proj, (B, V, 3, 4)).astype(
        np.float32).copy()


@functools.lru_cache(maxsize=None)
def _algebraic(use_confidences):
    """lt_tpu's algebraic model, its variables (numpy) and the port's
    model with them."""
    images, proj = _inputs()
    jm = jtri.AlgebraicTriangulationNet(num_joints=J, num_layers=18,
                                        use_confidences=use_confidences)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(proj))))
    port = tri.AlgebraicTriangulationNet(
        num_joints=J, num_layers=18, use_confidences=use_confidences,
        device="cpu")
    port.load_state_dict(algebraic_state_dict(variables, 18))
    return jm, variables, port


def _apply(jm, variables, images, proj, mask=None):
    """lt_tpu's eval forward, jitted (numpy in)."""
    fn = jax.jit(lambda v, i, p, m: jm.apply(v, i, p, view_mask=m))
    return fn(variables, jnp.asarray(images), jnp.asarray(proj),
              None if mask is None else jnp.asarray(mask))


@functools.partial(jax.jit, static_argnames="direct_optimization")
def _jax_ransac_jit(pm, pts, vm, direct_optimization):
    return jtri.ransac_triangulate(pm, pts,
                                   direct_optimization=direct_optimization,
                                   view_mask=vm)


def _jax_ransac(pm, pts, direct_optimization=True, vm=None):
    """lt_tpu's ransac_triangulate, jitted once per shape (numpy in)."""
    return _jax_ransac_jit(jnp.asarray(pm), jnp.asarray(pts),
                           None if vm is None else jnp.asarray(vm),
                           direct_optimization=direct_optimization)


def _check_algebraic(out, ref):
    assert _err(out.keypoints_2d, ref.keypoints_2d) <= KP2D_PX
    assert _err(out.keypoints_3d, ref.keypoints_3d) <= KP3D_MM
    assert _err(out.confidences, ref.confidences) <= CONF_TOL
    assert _err(out.heatmaps, ref.heatmaps) <= HEATMAP_TOL


def test_algebraic_matches_lt_tpu():
    """With confidences: shapes and every output within its tolerance;
    confidences sum to 1 over the views plus the 1e-5 floor of each.  (The
    model without confidences is held to lt_tpu on the trained fixture.)"""
    images, proj = _inputs()
    jm, variables, port = _algebraic(True)
    ref = _apply(jm, variables, images, proj)
    out = port(torch.from_numpy(images), torch.from_numpy(proj))
    assert out.keypoints_3d.shape == (B, J, 3)
    assert out.keypoints_2d.shape == (B, V, J, 2)
    assert out.heatmaps.shape == (B, V, J, IMG // 4, IMG // 4)
    _check_algebraic(out, ref)
    torch.testing.assert_close(out.confidences.sum(1),
                               torch.full((B, J), 1.0 + V * 1e-5),
                               rtol=0, atol=1e-6)


def test_algebraic_masked_view_equals_dropped_view():
    """A masked view gets exactly zero confidence, so its DLT rows vanish:
    the port's 3D keypoints equal those of the model without that view
    (lt_tpu's limit: 1e-3 mm + relative 1e-5; the backbone's batch of 8
    or 6 images rounds differently), and equal lt_tpu's masked ones
    within the model tolerances."""
    images, proj = _inputs()
    jm, variables, port = _algebraic(True)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], np.float32)
    out = port(torch.from_numpy(images), torch.from_numpy(proj),
               view_mask=torch.from_numpy(mask))
    assert float(out.confidences[:, 3].abs().max()) == 0.0
    dropped = port(torch.from_numpy(images[:, :3]),
                   torch.from_numpy(proj[:, :3]))
    np.testing.assert_allclose(out.keypoints_3d.numpy(),
                               dropped.keypoints_3d.numpy(), rtol=1e-5,
                               atol=1e-3)
    ref = _apply(jm, variables, images, proj, mask)
    _check_algebraic(out, ref)


def test_algebraic_is_differentiable_in_training():
    """In training mode the 3D keypoints reach every backbone parameter
    but the frozen-nowhere final layer too: all gradients finite, some
    non-zero; eval mode runs under no_grad."""
    images, proj = _inputs()
    port = tri.AlgebraicTriangulationNet(num_joints=J, num_layers=18,
                                         device="cpu", seed=3)
    assert not port(torch.from_numpy(images),
                    torch.from_numpy(proj)).keypoints_3d.requires_grad
    port.train()
    out = port(torch.from_numpy(images), torch.from_numpy(proj))
    (out.keypoints_3d ** 2).sum().mul(1e-6).backward()
    grads = [p.grad for p in port.parameters()]
    assert all(g is not None and bool(g.isfinite().all()) for g in grads)
    assert float(port.backbone.final_layer.weight.grad.abs().max()) > 0


def _planted(seed, n=6, outlier=2, shift=200.0, views=V):
    """The example rig's ring of ``views`` cameras at 384^2 (focal 461 px,
    4 m out: ``utils/example.py``), n points within 400 mm of its centre
    and their projections (n, views, 2), view ``outlier`` moved ``shift``
    px."""
    rng = np.random.RandomState(seed)
    _, proj, _ = example_batch(1, views, 384, 1)
    pts3d = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
    pts2d = np.asarray(jgeo.project_points(
        jnp.asarray(proj[0]), jnp.asarray(pts3d)[None])).swapaxes(0, 1).copy()
    if outlier is not None:
        pts2d[:, outlier] += shift
    pm = np.broadcast_to(proj[0], (n, views, 3, 4)).astype(np.float32).copy()
    return pm, pts3d, pts2d


@pytest.mark.parametrize("direct_optimization", [False, True])
def test_ransac_triangulate_matches_lt_tpu(direct_optimization):
    """Planted points, view 2 moved 200 px: the port within 0.05 mm of
    lt_tpu and within 1 mm of the points (as tests/
    test_triangulation_models.py)."""
    pm, pts3d, pts2d = _planted(0)
    got = tri.ransac_triangulate(torch.from_numpy(pm),
                                 torch.from_numpy(pts2d),
                                 direct_optimization=direct_optimization)
    assert got.shape == (6, 3)
    assert _err(got, _jax_ransac(pm, pts2d, direct_optimization)) <= KP3D_MM
    np.testing.assert_allclose(got.numpy(), pts3d, atol=1.0)


@pytest.mark.parametrize("direct_optimization", [False, True])
def test_ransac_triangulate_masked_view_equals_dropped_view(
        direct_optimization):
    """Five views, view 2 moved 200 px and view 4 masked (three good views
    stay, as RANSAC needs to outvote an outlier): equal to dropping view 4
    (1e-3 mm), within 1 mm of the points, and with the refinement within
    0.05 mm of lt_tpu's masked RANSAC."""
    pm, pts3d, pts2d = _planted(0, views=5)
    vm = np.ones(pts2d.shape[:-1], np.float32)
    vm[:, 4] = 0.0
    got = tri.ransac_triangulate(torch.from_numpy(pm),
                                 torch.from_numpy(pts2d),
                                 direct_optimization=direct_optimization,
                                 view_mask=torch.from_numpy(vm))
    dropped = tri.ransac_triangulate(torch.from_numpy(pm[:, :4]),
                                     torch.from_numpy(pts2d[:, :4]),
                                     direct_optimization=direct_optimization)
    assert _err(got, dropped) <= 1e-3
    np.testing.assert_allclose(got.numpy(), pts3d, atol=1.0)
    if direct_optimization:
        assert _err(got, _jax_ransac(pm, pts2d, True, vm)) <= KP3D_MM


def test_ransac_direct_optimization_matches_lt_tpu_on_noisy_points():
    """2 px noise and no outlier, lt_tpu's own case
    (tests/test_triangulation_models.py, seed 42, six points): the
    Gauss-Newton
    refinement (closed-form Jacobian, solve_ex) within 0.05 mm of lt_tpu's
    (jacfwd, solve), and no worse than 1.5x the unrefined error."""
    rng = np.random.RandomState(42)
    proj, *_ = make_synthetic_cameras(V, rng)
    pts3d = rng.uniform(-300, 300, (6, 3)).astype(np.float32)
    pts2d = np.asarray(jgeo.project_points(
        jnp.asarray(proj), jnp.asarray(pts3d)[None])).swapaxes(0, 1)
    noisy = pts2d + rng.randn(*pts2d.shape).astype(np.float32) * 2.0
    pm = np.broadcast_to(proj, (6, V, 3, 4)).astype(np.float32).copy()
    args = (torch.from_numpy(pm), torch.from_numpy(noisy))
    got = tri.ransac_triangulate(*args)
    ref = _jax_ransac(pm, noisy)
    assert _err(got, ref) <= KP3D_MM
    plain = tri.ransac_triangulate(*args, direct_optimization=False)
    err_go = np.linalg.norm(got.numpy() - pts3d, axis=-1).mean()
    err_no = np.linalg.norm(plain.numpy() - pts3d, axis=-1).mean()
    assert np.isfinite(err_go) and err_go <= 1.5 * err_no


@functools.lru_cache(maxsize=None)
def _fixture_batch():
    """Two validation poses of the synthetic dataset at 128^2 (the
    fixture's domain)."""
    ds = SyntheticMultiViewDataset(n_samples=2, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    samples = [ds[i] for i in range(len(ds))]
    images = np.stack([np.stack(s["images"]) for s in samples]).astype(
        np.float32)
    proj = np.stack([np.stack(s["proj_matrices"]) for s in samples]).astype(
        np.float32)
    return images, proj


@functools.lru_cache(maxsize=None)
def _fixture_variables():
    src = load_backbone_npz(FIXTURE)
    return {"params": {"backbone": src["params"]},
            "batch_stats": {"backbone": src["batch_stats"]}}


@pytest.mark.parametrize("family", ["alg", "ransac"])
def test_trained_backbone_fixture_matches_lt_tpu(family):
    """The trained RN-18 backbone (17 joints, no confidence head) in the
    algebraic model without confidences and in RANSAC: RANSAC's argmax
    pixels are equal (peaked heatmaps) and its 3D keypoints within 0.05 mm;
    the algebraic model within its tolerances."""
    images, proj = _fixture_batch()
    variables = _fixture_variables()
    if family == "alg":
        jm = jtri.AlgebraicTriangulationNet(num_joints=17, num_layers=18,
                                            use_confidences=False)
        port = tri.AlgebraicTriangulationNet(num_joints=17, num_layers=18,
                                             use_confidences=False,
                                             device="cpu")
    else:
        jm = jtri.RANSACTriangulationNet(num_joints=17, num_layers=18)
        port = tri.RANSACTriangulationNet(num_joints=17, num_layers=18,
                                          device="cpu")
    port_backbone(port, FIXTURE, 18)
    ref = _apply(jm, variables, images, proj)
    out = port(torch.from_numpy(images), torch.from_numpy(proj))
    if family == "alg":
        _check_algebraic(out, ref)
    else:
        assert _err(out.keypoints_2d, ref.keypoints_2d) == 0.0
        assert _err(out.keypoints_3d, ref.keypoints_3d) <= KP3D_MM
        assert _err(out.heatmaps, ref.heatmaps) <= HEATMAP_TOL * max(
            float(np.abs(np.asarray(ref.heatmaps)).max()), 1.0)
        assert float(out.confidences.abs().max()) == 0.0
        assert out.confidences.shape == (2, 4, 17)


def test_ransac_model_masked_view_equals_dropped_view():
    """RANSAC on the fixture with view 3 masked equals RANSAC on views 0-2
    (1e-3 mm)."""
    images, proj = _fixture_batch()
    port = tri.RANSACTriangulationNet(num_joints=17, num_layers=18,
                                      device="cpu")
    port_backbone(port, FIXTURE, 18)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], np.float32)
    out = port(torch.from_numpy(images), torch.from_numpy(proj),
               view_mask=torch.from_numpy(mask))
    dropped = port(torch.from_numpy(images[:, :3]),
                   torch.from_numpy(proj[:, :3]))
    assert _err(out.keypoints_3d, dropped.keypoints_3d) <= 1e-3


def test_ransac_npz_loader_reads_lt_tpus_whole_model_variables(tmp_path):
    """load_ransac_npz on a whole-model .npz (params/backbone/...) gives
    the backbone fixture's weights."""
    with np.load(FIXTURE) as data:
        flat = {k.replace("params/", "params/backbone/", 1).replace(
            "batch_stats/", "batch_stats/backbone/", 1): data[k]
            for k in data.files}
    path = tmp_path / "ransac.npz"
    np.savez(path, **flat)
    a = tri.RANSACTriangulationNet(num_joints=17, num_layers=18,
                                   device="cpu", seed=1)
    b = tri.RANSACTriangulationNet(num_joints=17, num_layers=18,
                                   device="cpu", seed=2)
    load_ransac_npz(a, str(path), 18)
    port_backbone(b, FIXTURE, 18)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("path", CONFIGS)
def test_factory_builds_every_alg_and_ransac_config(path):
    """make_model builds each config that names 'alg' or 'ransac' at its
    own width (on the CPU), with its options: joints, layers,
    confidences, heatmap options, direct optimization."""
    config = cfg.load_config(path)
    m = config.model
    model = factory.make_model(config, device="cpu")
    assert m.name in factory.MODEL_NAMES
    layers = {18: 2, 152: 3}[m.backbone.num_layers]
    assert len(model.backbone.layer1) == layers
    assert model.backbone.final_layer.out_channels == m.backbone.num_joints
    if m.name == "alg":
        assert isinstance(model, tri.AlgebraicTriangulationNet)
        assert model.use_confidences == m.get("use_confidences", True)
        assert (model.backbone.alg_confidences is not None) == \
            model.use_confidences
        assert model.heatmap_multiplier == m.get("heatmap_multiplier", 100.0)
        assert model.heatmap_softmax == m.get("heatmap_softmax", True)
    else:
        assert isinstance(model, tri.RANSACTriangulationNet)
        assert model.backbone.alg_confidences is None
        assert model.direct_optimization == m.get("direct_optimization",
                                                  True)
    opt = factory.make_optimizer(config, model)
    assert [g["lr"] for g in opt.param_groups] == [config.opt.lr]
    assert sum(p.numel() for p in opt.param_groups[0]["params"]) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("cls", [tri.AlgebraicTriangulationNet,
                                 tri.RANSACTriangulationNet])
def test_models_need_a_card_unless_asked_for_the_cpu(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cls(num_joints=J, num_layers=18)
    with pytest.raises(ValueError, match="compute_dtype"):
        cls(num_joints=J, num_layers=18, device="cpu",
            compute_dtype=torch.float16)
