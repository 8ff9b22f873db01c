"""The port's training step vs lt_tpu on the CPU: one whole train step
(loss, every gradient, BatchNorm running statistics, parameters after
Adam) from the same weights and rotations, the optimizer groups and the
frozen final layer, gradient clipping.  The losses, one BatchNorm call,
remat, checkpoints and the CLI are tests/test_torch_train_engine.py.

JAX runs its XLA path here (the Pallas gates need a TPU); the port runs
its kernels' plain versions, including the fused aggregation's backward
(K5 and K6).  Inputs come from numpy seeds; weights move through
``lt_tpu_torch.utils.weights``.

The step is compared in float64 on both sides.  At random weights its
gradients amplify rounding about a million-fold at this size (V2V's 1^3
level normalizes two values per channel): the two float64 steps agree to
1e-10 (relative L2 per optimizer group), but float32 rounding alone moves
the port's gradients by 4e-3 to 5e-3 and lt_tpu's by 2.7e-2 to 3.5e-2.  So
parity is held in float64 at the stated tolerances, and the port's float32
step is held to the float64 reference within its own rounding.
"""

import contextlib
import fcntl
import functools
import os
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lt_tpu.engine import factory as j_factory
from lt_tpu.engine import steps as j_steps
from lt_tpu.models.triangulation import \
    VolumetricTriangulationNet as JVolNet
from lt_tpu.utils import cfg as j_cfg
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.models.batchnorm import bn_fed_biases
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_train_batch
from lt_tpu_torch.utils.weights import volumetric_state_dict

FLAGSHIP_YAML = "experiments/human36m/train/human36m_vol_softmax.yaml"
SYNTH_YAML = "experiments/synthetic/vol_tiny_2stage.yaml"
# The flagship training recipe (MAE + 0.01 CE, scale 0.1, lr 1e-4 backbone,
# 1e-3 elsewhere) cut to RN-18 at 64^2, 2 views, 32^3, batch 2.
SMALL = {"model.backbone.num_layers": 18, "model.volume_size": 32,
         "model.backbone.init_weights": False}
B, V, IMG, J = 2, 2, 64, 17
# The port's float32 step vs the float64 reference: relative L2 error of
# each optimizer group's gradient.  Measured 5.2e-3 (backbone), 3.8e-3
# (process_features), 4.2e-3 (volume_net); lt_tpu's own float32 step is at
# 3.5e-2, 2.7e-2 and 3.1e-2.  A dropped term of the fused aggregation's
# softmax VJP gives 0.2.
F32_GRAD_L2 = 1e-2


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _batch(seed=0):
    """example_train_batch with one joint of sample 1 invalid."""
    batch = example_train_batch(B, IMG, J, n_views=V, seed=seed)
    batch["keypoints_validity"][1, 3] = 0.0
    batch["keypoints_3d"][1, 3, 3] = 0.0
    return batch


def _torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(dtype)
            for k, v in batch.items()}


@contextlib.contextmanager
def _lt_tpu_in_float64():
    """x64 on, and ``jnp.float32`` -- the dtype that lt_tpu's coordinate,
    sampling, aggregation and soft-argmax code casts to -- read as float64
    while lt_tpu traces, so that its step is float64 throughout."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = f32


#: The directory of this test run that the pytest-xdist workers share
#: (set by the ``shared_run_dir`` fixture; None outside xdist).
SHARED = {"dir": None}


@pytest.fixture(scope="module", autouse=True)
def shared_run_dir(tmp_path_factory):
    """Under pytest-xdist, the run's temporary directory above each
    worker's own (pytest keeps the last three runs' and removes older
    ones), for :func:`_once_per_run`."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        SHARED["dir"] = tmp_path_factory.getbasetemp().parent


def _once_per_run(name, compute):
    """``compute()``, computed once per test run and shared by the
    pytest-xdist workers: the first worker to ask computes it and pickles
    it into the run's directory (:data:`SHARED`), the others wait for it on
    a lock and load it (``lt_tpu``'s float64 step costs minutes of a
    worker, and tests/test_torch_spatial_train.py holds its sharded step to
    it too).  Outside xdist: computed here."""
    folder = SHARED["dir"]
    if folder is None:
        return compute()
    path = pathlib.Path(folder) / f"{name}.pkl"
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path.with_suffix(".tmp"), "wb") as f:
            pickle.dump(value, f)
        os.replace(path.with_suffix(".tmp"), path)
        return value


def _jax_config():
    config = j_cfg.load_config(FLAGSHIP_YAML)
    for k, v in SMALL.items():
        node = config
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    return config


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """lt_tpu's float32-initialized variables of the SMALL model (numpy),
    the weights of both sides of the step."""
    batch = _batch()
    model = JVolNet(num_joints=J, num_layers=18, volume_size=32,
                    cuboid_side=2500.0, kind="mpii")
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        *(jnp.asarray(batch[k][:1]) for k in
          ("images", "proj_matrices", "pred_keypoints_3d")))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """lt_tpu's side of one flagship-recipe train step in float64: the
    model's train apply, compute_losses, the gradients and
    factory.make_optimizer's Adam, from float32-initialized weights.
    Returns (config, float32 variables, loss, grads, new stats, new params)
    with the last three float64 (:func:`_once_per_run`)."""
    return (_jax_config(), _jax_variables()) + _once_per_run(
        "lt_tpu_float64_step", _jax_step_values)


def _jax_step_values():
    """(loss, grads, new stats, new params) of :func:`_jax_step`."""
    config = _jax_config()
    batch = _batch()
    variables = _jax_variables()
    criterion = j_factory.make_criterion(config)

    def as_np(tree):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))

    with _lt_tpu_in_float64():
        model = JVolNet(num_joints=J, num_layers=18, volume_size=32,
                        cuboid_side=2500.0, kind="mpii",
                        compute_dtype=jnp.float64)
        var = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables)
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": var["batch_stats"]},
                jb["images"], jb["proj_matrices"], jb["pred_keypoints_3d"],
                train=True, view_mask=jb["view_mask"],
                rotation_thetas=jb["rotation_thetas"],
                mutable=["batch_stats"])
            total, _ = j_steps.compute_losses("vol", criterion, config, out,
                                              jb)
            return total, mutated["batch_stats"]

        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(var["params"])
        tx = j_factory.make_optimizer(config, var["params"], "vol")
        updates, _ = tx.update(grads, tx.init(var["params"]), var["params"])
        new_params = optax.apply_updates(var["params"], updates)
        return (float(loss), as_np(grads), as_np(stats), as_np(new_params))


def _port_setup(overrides=None, dtype=torch.float32, **model_kw):
    """The port's model (in ``dtype``), criterion, optimizer and config
    from the same weights as :func:`_jax_step`."""
    variables = _jax_variables()
    config = cfg.load_config(FLAGSHIP_YAML, {**SMALL, **(overrides or {})})
    model = factory.make_model(config, device="cpu", **model_kw)
    model.load_state_dict(volumetric_state_dict(variables, 18))
    model.to(dtype)
    return (config, model, factory.make_criterion(config),
            factory.make_optimizer(config, model))


@functools.lru_cache(maxsize=None)
def _port_step(dtype=torch.float64):
    config, model, criterion, opt = _port_setup(dtype=dtype)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = steps.train_step(model, opt, criterion, config,
                               _torch_batch(_batch(), dtype))
    return model, before, metrics


def _by_name(tree_variables):
    """lt_tpu variables -> the port's state_dict names (numpy)."""
    return {k: v.numpy() for k, v in volumetric_state_dict(
        tree_variables, 18).items()}


def _ref_grads():
    _, variables, _, grads, _, _ = _jax_step()
    return _by_name({"params": grads, "batch_stats": variables["batch_stats"]})


def test_train_step_loss_matches_lt_tpu():
    """float64: the step's loss within relative 1e-5 (measured 4e-16)."""
    _, _, ref_loss, *_ = _jax_step()
    _, _, metrics = _port_step()
    assert abs(metrics["total_loss"] - ref_loss) <= 1e-5 * abs(ref_loss)


def _group_l2_errors(model, ref):
    """Relative L2 error of the gradient of each optimizer group."""
    errs = {}
    for group in factory.GROUPS:
        num = den = 0.0
        for name, p in model.named_parameters():
            if name.startswith(group + ".") and p.grad is not None:
                r = ref[name].astype(np.float64)
                num += ((p.grad.double().numpy() - r) ** 2).sum()
                den += (r ** 2).sum()
        errs[group] = np.sqrt(num / den)
    return errs


def _check_grads_per_tensor(model, ref, tol=1e-4):
    """Every gradient within ``tol`` of ``ref`` relative to its tensor's
    max.  The gradients that are zero in exact arithmetic -- biases that
    feed a BatchNorm, and V2V's output bias, whose per-joint shift the
    soft-argmax's softmax ignores -- within ``tol`` of their group's largest
    gradient."""
    fed = bn_fed_biases(model) | {"volume_net.output_layer.bias"}
    scale = {g: max(np.abs(v).max() for k, v in ref.items()
                    if k.startswith(g + ".") and k not in fed)
             for g in factory.GROUPS}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if name in fed:
            err = np.abs(_np(p.grad) - ref[name]).max()
            assert err <= tol * scale[name.split(".")[0]], (name, err)
        else:
            assert _rel(p.grad, ref[name]) <= tol, (name, _rel(
                p.grad, ref[name]))


def test_train_step_gradients_match_lt_tpu():
    """float64: every trainable tensor has a gradient, the frozen final
    layer none, and each gradient is within relative 1e-4 of lt_tpu's
    (measured 4e-9 at worst)."""
    model, _, _ = _port_step()
    for name, p in model.named_parameters():
        frozen = name.startswith("backbone.final_layer.")
        assert (p.grad is None) == frozen, name
    _check_grads_per_tensor(model, _ref_grads())


def test_train_step_batchnorm_stats_match_lt_tpu():
    """float64: every running statistic after the step within relative 1e-5
    of lt_tpu's (measured 5e-11).  flax moves the running variance towards
    the biased batch variance, and so does the port; PyTorch's own unbiased
    update would be off by a factor 2 in the variance's step at V2V's 1^3
    level, two values per channel at batch 2."""
    _, variables, _, _, stats, _ = _jax_step()
    model, _, _ = _port_step()
    ref = _by_name({"params": variables["params"], "batch_stats": stats})
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(names) > 100
    state = model.state_dict()
    for name in names:
        assert _rel(state[name], ref[name]) <= 1e-5, name


def test_train_step_adam_update_matches_lt_tpu():
    """float64: Adam's first step is -lr * g / (|g| + eps), about
    -lr * sign(g).  Where |g_ref| is at least 1e-4 of its tensor's max the
    updates agree within 1e-4 * lr; elsewhere (a sign that rounding can
    flip) within 2 lr.  The frozen layer stays put."""
    config, variables, _, grads, _, new = _jax_step()
    model, before, _ = _port_step()
    stats = variables["batch_stats"]
    g_ref = _by_name({"params": grads, "batch_stats": stats})
    p_ref = _by_name({"params": new, "batch_stats": stats})
    lrs = {"backbone": config.opt.lr,
           "process_features": config.opt.process_features_lr,
           "volume_net": config.opt.volume_net_lr}
    for name, p in model.named_parameters():
        if name.startswith("backbone.final_layer."):
            assert torch.equal(p, before[name])
            continue
        lr = lrs[name.split(".")[0]]
        diff = np.abs(_np(p) - p_ref[name])
        gr = np.abs(g_ref[name])
        large = gr >= 1e-4 * gr.max()
        assert (diff <= 1e-4 * lr)[large].all(), name
        assert diff.max() <= 2 * lr, name


def test_float32_train_step_within_rounding_of_lt_tpu():
    """The port's own dtype: its float32 step against lt_tpu's float64 one.
    Loss within relative 1e-5; each optimizer group's gradient within
    relative L2 F32_GRAD_L2, about twice what float32 rounding gives."""
    _, _, ref_loss, *_ = _jax_step()
    model, _, metrics = _port_step(torch.float32)
    assert abs(metrics["total_loss"] - ref_loss) <= 1e-5 * abs(ref_loss)
    for group, err in _group_l2_errors(model, _ref_grads()).items():
        assert err <= F32_GRAD_L2, (group, err)


def test_optimizer_groups_and_frozen_final_layer():
    config, model, _, opt = _port_setup()
    groups = {g["name"]: g for g in opt.param_groups}
    assert {k: g["lr"] for k, g in groups.items()} == {
        "backbone": 1e-4, "process_features": 1e-3, "volume_net": 1e-3}
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.startswith("backbone.final_layer.")
        assert (id(p) in in_opt) == (not frozen), name
        assert p.requires_grad == (not frozen), name
        if not frozen:
            group = name.split(".")[0]
            assert any(p is q for q in groups[group]["params"]), name


def test_grad_clip_matches_optax():
    """float64, opt.grad_clip: the trainable gradients are clipped to the
    global norm grad_clip / lr as optax.clip_by_global_norm clips lt_tpu's
    (each within relative 1e-4), and grad_norm_times_lr reports the capped
    norm times lr."""
    ref = _ref_grads()
    lr = 1e-4
    config, model, criterion, opt = _port_setup({"opt.grad_clip": 1.0},
                                                dtype=torch.float64)
    names = {k for k, p in model.named_parameters() if p.requires_grad}
    trainable = {k: v for k, v in ref.items() if k in names}
    norm = float(np.sqrt(sum((v ** 2).sum() for v in trainable.values())))
    clip = 0.5 * norm * lr                      # clip to half the norm
    config.opt.grad_clip = clip
    metrics = steps.train_step(model, opt, criterion, config,
                               _torch_batch(_batch(), torch.float64))
    with jax.enable_x64(True):
        clipped = optax.clip_by_global_norm(clip / lr).update(
            {k: jnp.asarray(v) for k, v in trainable.items()}, None)[0]
        clipped = {k: np.asarray(v) for k, v in clipped.items()}
    _check_grads_per_tensor(model, clipped)
    norm_after = float(torch.nn.utils.get_total_norm(
        [p.grad for p in model.parameters() if p.grad is not None]))
    assert abs(norm_after - clip / lr) <= 1e-5 * clip / lr
    assert abs(metrics["grad_norm_times_lr"] - clip) <= 1e-5 * clip


