"""bfloat16 training (``bf16: true``) in lt_tpu_torch vs lt_tpu on the CPU.

(a) K5 and K6 in their bfloat16 instances (the plain versions here): K5
    (float32 or bfloat16 features -> bfloat16) against lt_tpu's
    ``_sample_views_fwd_impl_t`` in interpret mode; K6 with a bfloat16
    cotangent, NaN and infinities included, against ``jax.vjp`` of
    lt_tpu's XLA sampling and, finite, against its Pallas scatter; the
    autograd Function's ``out_dtype``; and the two training paths of the
    unprojection in bfloat16 (the fused aggregation's backward, the
    unfused 'conf' / 'max' path) against lt_tpu's Pallas path.
(b) Whole training steps from the committed trained fixture (random
    weights amplify rounding a million-fold): the volumetric model with
    'softmax' (the fused aggregation, K1 / K5 / K6), at VOL_ROTATIONS.
    lt_tpu's bfloat16 and float32 steps run here, in one cached call.  The
    means over the rotations of the keypoints', each optimizer group's
    gradient's (relative L2) and the BatchNorm statistics' moves'
    distances of the port's bfloat16 step from lt_tpu's float32 step lie
    within RATIO times the means of lt_tpu's own bfloat16 step's
    (tests/test_torch_bf16.py's rule); Adam's update and the loss are
    taken from each side's own float32 step (OWN_REFERENCE), the scalar
    loss is held to VOL_LOSS_LIMIT.  The algebraic step and the 'conf'
    step (the unfused path) are tests/test_torch_bf16_steps.py, with
    remat, the CLI and checkpoints in bfloat16.

torch runs on one thread here, the whole steps on STEP_THREADS.

Every limit stands beside the value measured when the test was written.
"""

import concurrent.futures
import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.engine import factory as j_factory
from lt_tpu.engine import steps as j_steps
from lt_tpu.models.triangulation import AlgebraicTriangulationNet as JAlg
from lt_tpu.models.triangulation import \
    VolumetricTriangulationNet as JVolNet
from lt_tpu.ops import volumetric as j_vol
from lt_tpu.ops.pallas import unproject as j_unproject
from lt_tpu.utils import cfg as j_cfg
from lt_tpu.utils.torch_import import import_volumetric_model
from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.models.batchnorm import bn_fed_biases
from lt_tpu_torch.ops import volumetric as t_vol
from lt_tpu_torch.ops.kernels import sample as t_sample
from lt_tpu_torch.ops.kernels import unproject as t_unproject
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.weights import (algebraic_state_dict,
                                        load_npz_variables,
                                        volumetric_state_dict)
from tests.test_torch_kernels import (_close, _nonfinite_cotangent, _t,
                                      _views)

BF16 = torch.bfloat16
VOL_YAML = "experiments/synthetic/vol_tiny_2stage.yaml"
ALG_YAML = "experiments/synthetic/alg_tiny.yaml"
VOL_FIXTURE = "tests/fixtures/vol_rn18_synth.npz"
BACKBONE_FIXTURE = "tests/fixtures/backbone_rn18_synth.npz"
REL_ONE = 1.6e-2        # a single kernel in bfloat16: two ulps of max |ref|
REL_CHAIN = 3e-2        # a chain of bfloat16 roundings
RATIO = 1.5             # port's bfloat16 distance over lt_tpu's
B = 2                   # the synthetic configs' training batch
ROTATIONS = (0.7, 2.9)


#: torch's threads for the whole training steps (``_port_step``).
#: PyTorch's CPU bfloat16 kernels round differently with the thread count,
#: and one bfloat16 step's distance from float32 moves with it (the port's
#: volumetric process_features gradient at four views and the rotations
#: (0.7, 2.9): 0.20 on one thread, 0.51 on two, 0.29 on eight; lt_tpu's
#: own 0.30); the volumetric rule takes means over VOL_ROTATIONS for that
#: reason, and holds on one, two and eight threads.  Two: the test suite
#: runs six processes on eight cores.
STEP_THREADS = 2


@contextlib.contextmanager
def torch_threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_thread(request):
    """torch on one thread outside the whole steps: the test suite runs
    six processes on eight cores, where more threads wait on each other
    (tests/test_torch_h36m.py's fixture).  When the pytest run collected
    this module's volumetric step tests, lt_tpu's steps for them start at
    once in a thread of their own (``_vol_live``), beside the tests before
    them."""
    if any(item.module is sys.modules[__name__]
           and "lt_tpu_band" in item.name for item in request.session.items):
        _vol_live()
    with torch_threads(1):
        yield


def _np(a):
    if torch.is_tensor(a):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32)).astype(np.float64)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _l2(got, ref):
    got, ref = _np(got), _np(ref)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _within_band(what, port, ref, limit=RATIO):
    """port / ref distances: the port's bfloat16 result at most ``limit``
    times lt_tpu's own bfloat16 distance from the float32 reference."""
    print(f"measured: {what}: port {port:.4e}, lt_tpu {ref:.4e} "
          f"(ratio {port / max(ref, 1e-30):.3f}, limit {limit})")
    assert port <= limit * ref + 1e-7, (what, port, ref)


# ---------------------------------------------------------------------------
# (a) K5 and K6 in bfloat16, and the unprojection's training paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dtype", [torch.float32, BF16])
def test_k5_bf16_out_matches_pallas(in_dtype):
    """K5 with a bfloat16 output, from float32 or bfloat16 features, vs
    _sample_views_fwd_impl_t in interpret mode (which in its bfloat16 mode
    also rounds the interpolation weights): within REL_ONE of max |ref|
    (measured 2.6e-3 from float32, 3.9e-3 from bfloat16 features).  The
    plain version rounds once: its result is the float32 sample of the
    (widened) features rounded to bfloat16."""
    feats, _, _, _, s, m = _views(0)
    b, v, h, w, c = feats.shape
    f, mm = feats.reshape(b * v, h, w, c), m.reshape(b * v, 3, 4)
    x = _t(f).to(in_dtype)
    got = t_sample.sample_views_t(x, mm, s, out_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (b * v, c, s ** 3)
    assert torch.equal(got, t_sample.sample_views_t(x.float(), mm, s)
                       .to(BF16))
    ref = j_unproject._sample_views_fwd_impl_t(
        jnp.asarray(np.asarray(_np(x), np.float32),
                    jnp.bfloat16 if in_dtype == BF16 else jnp.float32),
        jnp.asarray(mm.numpy()), s, interpret=True, out_dtype=jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    err = _rel(got, ref)
    print(f"measured: K5 {in_dtype} -> bfloat16 vs Pallas {err:.2e}")
    assert err <= REL_ONE
    assert bool((got.reshape(b, v, c, -1)[1, 2] == 0).all())


def test_k6_bf16_g_matches_xla_autodiff_and_pallas():
    """K6 with a bfloat16 g, NaN and infinities at voxels of each kind
    (behind the camera, with a tap off the map, every tap on it), against
    jax.vjp of lt_tpu's XLA unproject_heatmaps on the same g: the NaN mask
    and infinities equal, finite values within rel 1e-5 (g's bfloat16
    values are exact in float32; K6 widens them as it reads).  dF is
    float32.  The finite g also against lt_tpu's Pallas scatter
    (_sample_views_grad_features_t) on the bfloat16 g, which rounds its
    weights and products to bfloat16: within 2e-2 of max |ref| (measured
    2.9e-3)."""
    from tests.test_torch_kernels import _xla_unproject_vjp

    feats, proj, base, side, s, m = _views(3)
    b, v, h, w, c = feats.shape
    mm = m.reshape(b * v, 3, 4)
    g, _ = _nonfinite_cotangent(mm, s, h, w, c, 6)
    g16 = _t(np.ascontiguousarray(g.transpose(0, 2, 1))).to(BF16)
    g_wide = g16.float().numpy()
    _, ref = _xla_unproject_vjp(
        feats.reshape(b * v, 1, h, w, c), proj.reshape(b * v, 1, 3, 4),
        np.repeat(base, v, axis=0), side, s, "sum", None,
        g_wide.reshape(b * v, c, s, s, s))
    got = t_sample.sample_views_grad_t(g16, mm, (b * v, h, w, c), s)
    assert got.dtype == torch.float32
    assert np.isnan(ref).any() and np.isinf(ref).any()
    _close(got, ref.reshape(b * v, h, w, c), rel=1e-5)

    fin = torch.randn(b * v, c, s ** 3, generator=torch.Generator()
                      .manual_seed(1)).to(BF16)
    got = t_sample.sample_views_grad_t(fin, mm, (b * v, h, w, c), s)
    pallas = j_unproject._sample_views_grad_features_t(
        jnp.asarray(fin.float().numpy(), jnp.bfloat16),
        jnp.asarray(mm.numpy()), (b * v, h, w, c), s, 256, 16, True)
    err = _rel(got, pallas)
    print(f"measured: K6 bfloat16 g vs Pallas {err:.2e}")
    assert err <= 2e-2


@pytest.mark.parametrize("in_dtype", [torch.float32, BF16])
def test_sample_views_affine_t_bf16_out(in_dtype):
    """The autograd Function with out_dtype bfloat16: the samples are K5's
    bfloat16 output, the feature gradient is K6 of the (bfloat16)
    cotangent in float32 cast to the features' type, as lt_tpu's
    _sample_views_bwd_t returns it."""
    feats, _, _, _, s, m = _views(5)
    b, v, h, w, c = feats.shape
    x = _t(feats.reshape(b * v, h, w, c)).to(in_dtype).requires_grad_()
    mm = m.reshape(b * v, 3, 4)
    out = t_sample.sample_views_affine_t(x, mm, s, BF16)
    assert out.dtype == BF16
    assert torch.equal(out, t_sample.sample_views_t(x.detach(), mm, s,
                                                    out_dtype=BF16))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g.to(BF16))
    assert x.grad.dtype == in_dtype
    assert torch.equal(x.grad, t_sample.sample_views_grad_t(
        g.to(BF16), mm, tuple(x.shape), s).to(in_dtype))


def _lt_tpu_unproject(feats, proj, base, side, s, method, conf, mask, fuse,
                      dtype=None):
    """lt_tpu's unprojection of ``feats`` and its VJP for
    :func:`_cotangent`: (volume (B, C, N), feature gradient) as float64
    numpy.  ``dtype`` bfloat16: its Pallas path (interpret mode) in
    bfloat16, the volume in it; None: its XLA ``unproject_heatmaps`` in
    float32, the exact function."""
    jconf = None if conf is None else jnp.asarray(conf)
    if dtype is None:
        cv = j_vol.build_coord_volumes(jnp.asarray(base), side, s)

        def f(x):
            return j_vol.unproject_heatmaps(x, jnp.asarray(proj), cv, method,
                                            jconf, jnp.asarray(mask))
    else:
        aff = j_vol.coord_volume_affine(jnp.asarray(base), side, s)

        def f(x):
            return j_unproject.unproject_heatmaps_affine(
                x, jnp.asarray(proj), aff, s, method, jconf,
                jnp.asarray(mask), tile=s ** 3, fuse_aggregation=fuse,
                aggregation_dtype=dtype, interpret=True)

    x = jnp.asarray(feats, dtype or jnp.float32)
    out, pull = jax.vjp(f, x)
    cot = jnp.asarray(_cotangent(out.shape), out.dtype)
    return _np(out.reshape(out.shape[0], out.shape[1], -1)), _np(pull(cot)[0])


def _cotangent(shape):
    return np.random.RandomState(10).randn(*shape).astype(np.float32)


def _port_unproject(feats, proj, base, side, s, method, conf, mask, fuse,
                    dtype):
    """The port's unprojection of ``feats`` in ``dtype`` (the model's
    training call), its (B, C, N) volume and feature gradient."""
    x = _t(feats).to(dtype).requires_grad_()
    out = t_unproject.unproject_heatmaps_affine(
        x, _t(proj), t_vol.coord_volume_affine(_t(base), side, s), s,
        method, None if conf is None else _t(conf), _t(mask),
        fuse_aggregation=fuse,
        aggregation_dtype=None if dtype == torch.float32 else dtype)
    assert out.dtype == dtype
    out.backward(_t(_cotangent(out.shape)).to(dtype))
    assert x.grad.dtype == dtype
    return _np(out.reshape(out.shape[0], out.shape[1], -1)), _np(x.grad)


@pytest.mark.parametrize("method, fuse", [
    ("softmax", True), ("sum", True), ("conf", False), ("max", False)])
def test_unprojection_training_paths_bf16_match_lt_tpu(method, fuse):
    """The unprojection as the model trains it, from bfloat16 features:
    'softmax' and 'sum' fused (K1 forward; K5 bfloat16 -> bfloat16, the VJP
    in float32 and K6 on the rounded cotangent), 'conf' and 'max' unfused
    (K5 into bfloat16 samples, aggregation as lt_tpu types it, K6).  The
    volume and the feature gradient against lt_tpu's Pallas path in
    interpret mode on the same inputs: each within RATIO times lt_tpu's own
    bfloat16 distance (relative L2) from the float32 function (lt_tpu's XLA
    unproject_heatmaps: its fused float32 backward itself rounds the
    samples and the cotangent to bfloat16, unproject.py:471, :499), and
    within REL_CHAIN of max |lt_tpu's bfloat16 result| (for 'max' the
    volume only: where two views' bfloat16 samples tie or cross, the
    maximum's gradient goes to the other view, on either side).  Measured
    (volume, gradient) port / lt_tpu distance: softmax 2.5e-3 / 3.1e-3,
    3.2e-3 / 4.2e-3; sum 2.3e-3 / 2.7e-3, 2.3e-3 / 3.2e-3; conf 2.8e-3 /
    3.2e-3, 2.7e-3 / 3.6e-3; max 2.3e-3 / 2.7e-3, 3.7e-2 / 3.6e-2; port vs
    lt_tpu in bfloat16 at most 6.8e-3."""
    feats, proj, base, side, s, _ = _views(8, behind=False)
    b, v, h, w, c = feats.shape
    conf = (np.random.RandomState(9).uniform(0.1, 1.0, (b, v, c))
            .astype(np.float32) if method == "conf" else None)
    mask = np.ones((b, v), np.float32)
    mask[0, 1] = 0.0
    args = (feats, proj, base, side, s, method, conf, mask, fuse)
    ref32 = _lt_tpu_unproject(*args)
    ref16 = _lt_tpu_unproject(*args, jnp.bfloat16)
    got16 = _port_unproject(*args, BF16)
    for i, what in enumerate(("volume", "gradient")):
        _within_band(f"{method} {what}", _l2(got16[i], ref32[i]),
                     _l2(ref16[i], ref32[i]))
        err = _rel(got16[i], ref16[i])
        print(f"measured: {method} {what} port vs lt_tpu bf16 {err:.2e}")
        assert err <= REL_CHAIN or (method, what) == ("max", "gradient")


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (5, 3, 2, 2, 2)])
def test_batchnorm_bf16_training_matches_flax(shape):
    """One BatchNorm training call on a bfloat16 input (the activations
    under autocast) vs lt_tpu's (flax's nn.BatchNorm, dtype the input's,
    float32 parameters): the output bfloat16 within REL_ONE of flax's
    (measured 0: the same bits), the running mean and biased variance
    float32 and within relative 1e-6 of flax's (measured 0 and 1.9e-7 /
    7.2e-8), statistics moved once."""
    import flax.linen as fnn

    from lt_tpu_torch.models.batchnorm import BatchNorm

    rng = np.random.RandomState(5)
    x = rng.normal(3.0, 2.0, shape).astype(np.float32)
    x16 = torch.from_numpy(x).to(BF16)
    mean0, var0 = rng.rand(3), rng.rand(3) + 0.5
    scale, bias = rng.normal(1, 0.2, 3), rng.normal(0, 0.2, 3)
    bn = BatchNorm(3).train()
    with torch.no_grad():
        for t, v in ((bn.running_mean, mean0), (bn.running_var, var0),
                     (bn.weight, scale), (bn.bias, bias)):
            t.copy_(torch.from_numpy(v))
    y = bn(x16)
    ref, mutated = fnn.BatchNorm(
        use_running_average=False, momentum=0.9, epsilon=1e-5,
        dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale, jnp.float32),
                    "bias": jnp.asarray(bias, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(mean0, jnp.float32),
                         "var": jnp.asarray(var0, jnp.float32)}},
        jnp.asarray(np.moveaxis(_np(x16), 1, -1), jnp.bfloat16),
        mutable=["batch_stats"])
    assert y.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    err = _rel(y, np.moveaxis(_np(ref), -1, 1))
    stats = mutated["batch_stats"]
    errs = (_rel(bn.running_mean, stats["mean"]),
            _rel(bn.running_var, stats["var"]))
    print(f"measured: output {err:.2e}, mean, var {errs}")
    assert err <= REL_ONE and max(errs) <= 1e-6
    assert int(bn.num_batches_tracked) == 1


# ---------------------------------------------------------------------------
# (b) whole training steps from the trained fixtures
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _synthetic_batch(rotations=ROTATIONS, n_views=4):
    """Two training poses of the synthetic set (128^2, ``n_views`` views),
    with the cuboid rotations ``rotations``."""
    ds = SyntheticMultiViewDataset(n_samples=B, n_views=n_views,
                                   image_size=128)
    val = [ds[i] for i in range(B)]
    kp = np.stack([s["keypoints_3d"] for s in val]).astype(np.float32)
    return {"images": np.stack([np.stack(s["images"]) for s in val])
            .astype(np.float32),
            "proj_matrices": np.stack([np.stack(s["proj_matrices"])
                                       for s in val]).astype(np.float32),
            "keypoints_3d": kp, "keypoints_validity": kp[..., 3:].copy(),
            "view_mask": np.ones((B, n_views), np.float32),
            "rotation_thetas": np.asarray(rotations, np.float32)}


@functools.lru_cache(maxsize=None)
def _family(kind):
    """(yaml, port overrides, lt_tpu model of a compute dtype, lt_tpu
    variables, lt_tpu variables -> port state_dict names) of ``kind``:
    'vol' (vol_rn18_synth.npz, 'softmax'), 'conf' (the same weights and
    the 'conf' aggregation, whose confidence head, absent from the
    fixture, keeps the port's seeded initialization) or 'alg'
    (backbone_rn18_synth.npz, no confidences)."""
    if kind in ("vol", "conf"):
        method = "softmax" if kind == "vol" else "conf"
        variables = load_npz_variables(VOL_FIXTURE)
        if kind == "conf":
            port = factory.make_model(cfg.load_config(VOL_YAML, {
                "model.volume_aggregation_method": "conf",
                "model.init_weights": False,
                "model.backbone.init_weights": False}), device="cpu")
            missing, _ = port.load_state_dict(
                volumetric_state_dict(variables, 18), strict=False)
            assert missing and all(".vol_confidences." in k
                                   for k in missing)
            variables = import_volumetric_model(
                {k: v.numpy() for k, v in port.state_dict().items()}, 18)
        return (VOL_YAML, {"model.volume_aggregation_method": method},
                lambda dt: JVolNet(
                    num_joints=17, num_layers=18, volume_size=32,
                    cuboid_side=2500.0, kind="mpii",
                    volume_aggregation_method=method, compute_dtype=dt),
                variables, lambda v: volumetric_state_dict(v, 18))
    src = load_npz_variables(BACKBONE_FIXTURE)
    variables = {"params": {"backbone": src["params"]},
                 "batch_stats": {"backbone": src["batch_stats"]}}
    return (ALG_YAML, {"model.use_confidences": False}, lambda dt: JAlg(
                num_joints=17, num_layers=18, use_confidences=False,
                compute_dtype=dt),
            variables, lambda v: algebraic_state_dict(v, 18))


class Step:
    """One training step's loss, gradients, BatchNorm statistics after it
    and Adam's update, float64 numpy by the port's state_dict names, and
    the forward's keypoints (B, J, 3)."""

    def __init__(self, loss, grads, stats, update, keypoints):
        self.loss, self.grads, self.stats, self.update = (loss, grads, stats,
                                                          update)
        self.keypoints = keypoints


@functools.lru_cache(maxsize=None)
def _lt_tpu_steps(kind, dtypes=("bfloat16",), rotation_sets=(ROTATIONS,),
                  n_views=4):
    """lt_tpu's train steps of ``kind``: for each of ``dtypes`` one jitted
    step (the model's train apply, compute_losses, the gradients, float32
    as the parameters, and its Adam's update), run on the batch of
    ``n_views`` views with each pair of ``rotation_sets``, from the fixture
    the port's steps take.  Returns {dtype: [Step for each pair]}."""
    yaml_path, _, make, variables, names = _family(kind)
    config = j_cfg.load_config(yaml_path)
    config.model.use_confidences = False
    family = "vol" if kind == "conf" else kind
    criterion = j_factory.make_criterion(config)
    params = variables["params"]
    tx = j_factory.make_optimizer(config, params, family)

    def by_name(p, bstats):
        tree = jax.tree_util.tree_map(np.asarray, {"params": p,
                                                   "batch_stats": bstats})
        return {k: v.double().numpy() for k, v in names(tree).items()}

    out = {}
    for dtype in dtypes:
        model = make(getattr(jnp, dtype))

        def loss_fn(p, jb, model=model):
            args = (jb["images"], jb["proj_matrices"])
            kw = dict(train=True, view_mask=jb["view_mask"],
                      mutable=["batch_stats"])
            if family == "vol":   # use_gt_pelvis: the ground truth's pelvis
                args += (jb["keypoints_3d"],)
                kw["rotation_thetas"] = jb["rotation_thetas"]
            res, mutated = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                *args, **kw)
            total, _ = j_steps.compute_losses(family, criterion, config, res,
                                              jb)
            return total, (mutated["batch_stats"], res.keypoints_3d)

        def step(p, jb, loss_fn=loss_fn):
            (loss, (stats, kp)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p, jb)
            update, _ = tx.update(grads, tx.init(p), p)
            return loss, grads, stats, update, kp

        run = jax.jit(step)
        out[dtype] = []
        for rotations in rotation_sets:
            jb = {k: jnp.asarray(v) for k, v in
                  _synthetic_batch(rotations, n_views).items()}
            loss, grads, stats, update, kp = run(params, jb)
            out[dtype].append(Step(
                float(loss), by_name(grads, variables["batch_stats"]),
                by_name(params, stats),
                by_name(update, variables["batch_stats"]), _np(kp)))
    return out


@functools.lru_cache(maxsize=None)
def _port_step(kind, dtype, rotations=ROTATIONS, n_views=4):
    """The port's train step of ``kind`` (``bf16: true`` for bfloat16)
    from the same weights and batch (``n_views`` views), with the cuboid
    rotations ``rotations``, on STEP_THREADS; also returns the names left
    out of the gradient comparisons and the model."""
    yaml_path, extra, _, variables, names = _family(kind)
    config = cfg.load_config(yaml_path, {
        "bf16": dtype == "bfloat16", "model.init_weights": False,
        "model.backbone.init_weights": False, **extra})
    model = factory.make_model(config, device="cpu")
    model.load_state_dict(names(variables))
    opt = factory.make_optimizer(config, model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    outputs = []
    hook = model.register_forward_hook(lambda m, i, o: outputs.append(o))
    with torch_threads(STEP_THREADS):
        metrics = steps.train_step(
            model, opt, factory.make_criterion(config), config,
            {k: torch.from_numpy(v)
             for k, v in _synthetic_batch(rotations, n_views).items()})
    hook.remove()
    step = Step(metrics["total_loss"],
                {k: p.grad.double().numpy() for k, p in
                 model.named_parameters() if p.grad is not None},
                {k: v.double().numpy() for k, v in
                 model.state_dict().items()},
                {k: (p.detach() - before[k]).double().numpy()
                 for k, p in model.named_parameters()},
                _np(outputs[0][0]))
    # The frozen parameters (no gradient) and the gradients that are 0 in
    # exact arithmetic.
    zero = bn_fed_biases(model) | {"volume_net.output_layer.bias",
                                   "backbone.final_layer.bias"} | {
        k for k, p in model.named_parameters() if not p.requires_grad}
    return step, zero, model


def _groups(kind):
    return ("backbone",) if kind == "alg" else factory.GROUPS


def _group_l2(a, b, model, group, skip=()):
    """Relative L2 distance of ``a`` from ``b`` over the parameters of
    ``model`` in ``group``, less ``skip`` (``a`` and ``b`` by state_dict
    name)."""
    keys = [k for k, _ in model.named_parameters()
            if k.startswith(group + ".") and k not in skip]
    num = sum(((a[k] - b[k]) ** 2).sum() for k in keys)
    return np.sqrt(num / sum((b[k] ** 2).sum() for k in keys))


def distances(kind, step, ref=None, rotations=ROTATIONS, n_views=4):
    """``step``'s distances from the float32 step ``ref`` of ``kind``
    (default: the port's, with ``rotations`` and ``n_views``): the loss
    (relative), the forward's keypoints (mean absolute difference, mm), each
    optimizer group's gradient (relative L2, less the frozen parameters
    and the gradients that are 0 in exact arithmetic) and Adam's update,
    and the BatchNorm statistics' moves in the step (running mean and
    variance after it minus before it).  Adam's first step is about -lr *
    sign(g): its distance counts the gradients whose sign rounding
    flips."""
    port32, zero, model = _port_step(kind, "float32", rotations, n_views)
    ref = ref or port32
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    dist = {"loss": abs(step.loss - ref.loss) / abs(ref.loss),
            "keypoints": float(np.abs(step.keypoints - ref.keypoints).mean())}
    for group in _groups(kind):
        dist[f"{group} gradient"] = _group_l2(step.grads, ref.grads, model,
                                              group, zero)
        dist[f"{group} Adam update"] = _group_l2(step.update, ref.update,
                                                 model, group, frozen)
    _, _, _, variables, names = _family(kind)
    before = {k: v.double().numpy() for k, v in names(variables).items()}
    for stat in ("running_mean", "running_var"):
        keys = [k for k in ref.stats if k.endswith(stat)]

        def moved(st):
            return np.concatenate([(st.stats[k] - before[k]).ravel()
                                   for k in keys])

        dist[f"{stat} move"] = _l2(moved(step), moved(ref))
    return dist


def check_bf16_step(kind, rotations=ROTATIONS, n_views=4):
    """The port's bfloat16 step of ``kind``: the parameters, gradients,
    Adam's moments and BatchNorm statistics float32, every gradient and
    the loss finite, a frozen parameter put.  Returns the step."""
    got, _, model = _port_step(kind, "bfloat16", rotations, n_views)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(g).all() and p.grad.dtype == torch.float32
               for (_, p), g in zip(
                   [(k, p) for k, p in model.named_parameters()
                    if p.grad is not None], got.grads.values()))
    assert all(v.dtype == torch.float32 for k, v in
               model.state_dict().items() if "running" in k)
    assert np.isfinite(got.loss)
    for k, p in model.named_parameters():
        if not p.requires_grad:
            assert not got.update[k].any(), k
    return got


def check_within_band(kind, band, which):
    """The port's bfloat16 step of ``kind`` (``check_bf16_step``) from its
    float32 step: each of ``distances`` whose name holds one of ``which``
    within RATIO times ``band`` (lt_tpu's bfloat16 step's distances from
    the same float32 step).  In float32 the port's and lt_tpu's steps'
    gradients lie 1e-2 apart, a twentieth of bfloat16's distance
    (tests/test_torch_train.py holds the float32 step to lt_tpu's in
    float64)."""
    got = check_bf16_step(kind)
    for what, d in distances(kind, got).items():
        if any(w in what for w in which):
            _within_band(f"{kind} {what}", d, band[what])


#: lt_tpu's bfloat16 steps of the algebraic model and of the 'conf'
#: aggregation: their distances from the port's float32 step
#: (``distances(kind, _lt_tpu_steps(kind)["bfloat16"][0])``; the port's
#: float32 step on eight threads) on an 8-core Intel Xeon CPU when the
#: tests were written: ``JAX_PLATFORMS=cpu python -m
#: tests.test_torch_bf16_train``
#: prints them again (about 2 minutes).  Each of lt_tpu's steps is an XLA
#: compilation (25-60 s alone on that CPU, several times that beside the
#: test suite's other processes), which the suite's time limit has no room
#: for beside the volumetric step's, run live (``vol_distances``).
LT_TPU_BAND = {
    "alg": {"loss": 9.658e-3, "backbone gradient": 0.1583,
            "backbone Adam update": 0.4742, "running_mean move": 1.966e-2,
            "running_var move": 1.303e-2},
    "conf": {"loss": 4.640e-3, "backbone gradient": 0.1313,
             "backbone Adam update": 0.4008,
             "process_features gradient": 0.0731,
             "process_features Adam update": 0.2238,
             "volume_net gradient": 0.0835, "volume_net Adam update": 0.3193,
             "running_mean move": 3.955e-3, "running_var move": 1.680e-3}}

#: The volumetric steps: two views of the fixture's synthetic poses (its
#: four cost lt_tpu's two live steps 8 s more a rotation here) and three
#: pairs of cuboid rotations drawn from a seeded generator (the first three
#: of ``np.random.RandomState(0).uniform(0, 2 pi, (4, 2))``, two
#: decimals).
#: One bfloat16 step's distance from float32 is one draw of a wide
#: distribution: rounding's last bits, amplified through the trained
#: network, move lt_tpu's process_features gradient distance between 0.10
#: and 0.70 from one rotation to the next, and the port's with its thread
#: count (0.20 on one thread, 0.51 on two, 0.29 on eight at (0.7, 2.9)).
#: The rule holds the means over the three rotations.
VOL_VIEWS = 2
VOL_ROTATIONS = ((3.45, 4.49), (3.79, 3.42), (2.66, 4.06))

#: The distances of the volumetric rule that are taken from each side's own
#: float32 step, not from lt_tpu's: there the port's and lt_tpu's float32
#: steps already lie further apart than lt_tpu's bfloat16 step lies from
#: its float32 one, for reasons that are not bfloat16's (four views, at
#: VOL_ROTATIONS, on the CPU: the loss 2e-4-4.7e-3, where a ground-truth
#: keypoint sits on a tie of two voxels of the volumetric CE; Adam's
#: first update, about -lr * sign(g), 0.47-0.88 on V2V, whose deepest
#: levels' gradients are 1e-7-1e-20 and take their sign from rounding).
OWN_REFERENCE = ("loss", "Adam update")

#: The scalar loss of the volumetric bfloat16 step, relative to float32:
#: a fixed limit, not RATIO times lt_tpu's live distance.  It is a sum of
#: some hundred terms of either sign, and its distance is the widest draw
#: of all: lt_tpu's 8.2e-4-6.7e-3 over eight rotations, the port's
#: 1.4e-4-7.8e-3 over twelve (four views, the forward on eight threads);
#: three draws do not fix a mean.  The limit is RATIO times lt_tpu's
#: largest.  The keypoints the loss is computed from are held to the live
#: band.
VOL_LOSS_LIMIT = 1e-2


_LIVE = {}


def _vol_live():
    """The future of lt_tpu's bfloat16 and float32 volumetric steps at
    VOL_ROTATIONS (``_lt_tpu_steps``), computed in a thread of its own:
    XLA's compilations and runs overlap the port's steps and tests."""
    if "vol" not in _LIVE:
        _LIVE["vol"] = concurrent.futures.ThreadPoolExecutor(1).submit(
            _lt_tpu_steps, "vol", ("bfloat16", "float32"), VOL_ROTATIONS,
            VOL_VIEWS)
    return _LIVE["vol"]


@functools.lru_cache(maxsize=None)
def vol_distances():
    """(port, lt_tpu): lists over VOL_ROTATIONS of ``distances`` of the
    port's and of lt_tpu's bfloat16 'softmax' steps from lt_tpu's float32
    step (OWN_REFERENCE: each from its own float32 step), all run here
    (lt_tpu's steps in one cached call, ``_vol_live``)."""
    future = _vol_live()
    got = [check_bf16_step("vol", rotations, VOL_VIEWS)
           for rotations in VOL_ROTATIONS]
    for rotations in VOL_ROTATIONS:
        _port_step("vol", "float32", rotations, VOL_VIEWS)
    live = future.result()
    port, ref = [], []
    for i, rotations in enumerate(VOL_ROTATIONS):
        f32 = live["float32"][i]
        lt_tpu = distances("vol", got[i], f32, rotations, VOL_VIEWS)
        own = distances("vol", got[i], None, rotations, VOL_VIEWS)
        port.append({k: own[k] if k.endswith(OWN_REFERENCE) else d
                     for k, d in lt_tpu.items()})
        ref.append(distances("vol", live["bfloat16"][i], f32, rotations,
                             VOL_VIEWS))
    return port, ref


def _mean(ds):
    return {k: float(np.mean([d[k] for d in ds])) for k in ds[0]}


def check_vol_within_band(which):
    """The means over VOL_ROTATIONS of each of ``distances`` whose name
    holds one of ``which``: the port's within RATIO times lt_tpu's."""
    port, ref = (_mean(d) for d in vol_distances())
    for what, d in port.items():
        if any(w in what for w in which):
            _within_band(f"vol {what} (mean of {len(VOL_ROTATIONS)})", d,
                         ref[what])


def test_bf16_step_loss_and_gradients_within_lt_tpu_band():
    """The volumetric 'softmax' step (the flagship recipe's model: the
    fused aggregation, K5 and K6 in the backward) at each of
    VOL_ROTATIONS: the means of the keypoints' and of each group's
    gradient's distance of the port's bfloat16 step from lt_tpu's float32
    step within RATIO times the means of lt_tpu's own bfloat16 step's; the
    loss within VOL_LOSS_LIMIT of the float32 loss at each rotation.
    Measured (means), port / lt_tpu: keypoints 2.88 / 3.55 mm, backbone
    0.106 / 0.099, process_features 0.082 / 0.081, volume_net 0.101 /
    0.099; the loss at the three rotations 3.2e-3, 5.7e-4, 2.6e-3."""
    port, _ = vol_distances()
    losses = [d["loss"] for d in port]
    print(f"measured: vol loss distances {losses}")
    assert max(losses) <= VOL_LOSS_LIMIT
    check_vol_within_band(("keypoints", "gradient"))


def test_bf16_step_batchnorm_and_adam_within_lt_tpu_band():
    """The same steps' BatchNorm moves and Adam's update (its distances
    from each side's own float32 step).  Measured (means), port / lt_tpu:
    Adam 0.370 / 0.363, 0.319 / 0.299, 0.347 / 0.392; mean moves 1.47e-2 /
    1.32e-2, variance moves 2.08e-3 / 4.22e-3."""
    check_vol_within_band(("move", "Adam"))


if __name__ == "__main__":
    # lt_tpu's bands (LT_TPU_BAND) measured again, beside the port's own
    # distances, and the volumetric means:
    # JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_train
    for fam in LT_TPU_BAND:
        with torch_threads(1):
            band = distances(fam, _lt_tpu_steps(fam)["bfloat16"][0])
            port = distances(fam, _port_step(fam, "bfloat16")[0])
        for what in band:
            print(f"{fam} {what}: lt_tpu {band[what]:.4e} (constant "
                  f"{LT_TPU_BAND[fam].get(what, np.nan):.4e}), port "
                  f"{port[what]:.4e}")
    with torch_threads(1):
        port, band = (_mean(d) for d in vol_distances())
    for what in band:
        print(f"vol {what}: lt_tpu {band[what]:.4e}, port {port[what]:.4e}")
