"""The port's training path vs lt_tpu on the CPU: losses, one whole train
step (loss, every gradient, BatchNorm running statistics, parameters after
Adam) from the same weights and rotations, the optimizer groups, the frozen
final layer, gradient clipping, remat, checkpoints and the CLI.

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
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lt_tpu.engine import factory as j_factory
from lt_tpu.engine import steps as j_steps
from lt_tpu.models import losses as j_losses
from lt_tpu.models.triangulation import \
    VolumetricTriangulationNet as JVolNet
from lt_tpu.utils import cfg as j_cfg
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.models import losses
from lt_tpu_torch.models.batchnorm import BatchNorm, bn_fed_biases
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


@functools.lru_cache(maxsize=None)
def _jax_step():
    """lt_tpu's side of one flagship-recipe train step in float64: the
    model's train apply, compute_losses, the gradients and
    factory.make_optimizer's Adam, from float32-initialized weights.
    Returns (config, float32 variables, loss, grads, new stats, new params)
    with the last three float64."""
    config = j_cfg.load_config(FLAGSHIP_YAML)
    for k, v in SMALL.items():
        node = config
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    batch = _batch()
    model = JVolNet(num_joints=J, num_layers=18, volume_size=32,
                    cuboid_side=2500.0, kind="mpii")
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        *(jnp.asarray(batch[k][:1]) for k in
          ("images", "proj_matrices", "pred_keypoints_3d")))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    criterion = j_factory.make_criterion(config)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)

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
        return (config, variables, float(loss), as_np(grads), as_np(stats),
                as_np(new_params))


def _port_setup(overrides=None, dtype=torch.float32, **model_kw):
    """The port's model (in ``dtype``), criterion, optimizer and config
    from the same weights as :func:`_jax_step`."""
    _, variables, *_ = _jax_step()
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


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 1, 1, 1)])
def test_batchnorm_update_matches_flax(shape):
    """One BatchNorm training call vs flax's nn.BatchNorm (momentum 0.9):
    output, running mean and running (biased) variance, float64, within
    relative 1e-12; the second shape normalizes two values per channel."""
    import flax.linen as fnn

    rng = np.random.RandomState(5)
    x = rng.normal(3.0, 2.0, shape)
    mean0, var0 = rng.rand(3), rng.rand(3) + 0.5
    scale, bias = rng.normal(1, 0.2, 3), rng.normal(0, 0.2, 3)
    bn = BatchNorm(3).double().train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    y = bn(torch.from_numpy(x))
    with jax.enable_x64(True):
        ref, mutated = fnn.BatchNorm(
            use_running_average=False, momentum=0.9, epsilon=1e-5,
            dtype=jnp.float64, param_dtype=jnp.float64).apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}},
            jnp.asarray(np.moveaxis(x, 1, -1)), mutable=["batch_stats"])
        ref = np.moveaxis(np.asarray(ref), -1, 1)
        stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    assert _rel(y, ref) <= 1e-12
    assert _rel(bn.running_mean, stats["mean"]) <= 1e-12
    assert _rel(bn.running_var, stats["var"]) <= 1e-12
    assert int(bn.num_batches_tracked) == 1


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


@pytest.mark.parametrize("name", ["MSE", "MSESmooth", "MAE", "l2", "ce"])
def test_losses_match_lt_tpu(name):
    rng = np.random.RandomState(11)
    b, j = 3, 5
    pred = rng.uniform(-40, 40, (b, j, 3)).astype(np.float32)
    gt = rng.uniform(-40, 40, (b, j, 3)).astype(np.float32)
    validity = (rng.rand(b, j, 1) > 0.3).astype(np.float32)
    if name == "ce":
        cv = rng.uniform(-50, 50, (b, 4, 4, 4, 3)).astype(np.float32)
        vols = rng.rand(b, j, 4, 4, 4).astype(np.float32)
        vols /= vols.sum((2, 3, 4), keepdims=True)
        args = (cv, vols, gt, validity)
        ref = j_losses.volumetric_ce_loss(*map(jnp.asarray, args))
        got = losses.volumetric_ce_loss(*map(torch.from_numpy, args))
    elif name == "l2":
        args = (pred, gt, validity)
        ref = j_losses.keypoints_l2_loss(*map(jnp.asarray, args))
        got = losses.keypoints_l2_loss(*map(torch.from_numpy, args))
    else:
        args = (pred, gt, validity)
        ref = j_losses.make_criterion(name, 100.0)(*map(jnp.asarray, args))
        got = losses.make_criterion(name, 100.0)(*map(torch.from_numpy,
                                                      args))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# Port-only behaviour: remat, packed weights, checkpoints, the CLI
# ---------------------------------------------------------------------------

TINY = {"model.backbone.num_layers": 18, "model.volume_size": 32,
        "model.backbone.init_weights": False, "model.init_weights": False}


def _tiny(seed=0, remat=False):
    config = cfg.load_config(SYNTH_YAML, {**TINY, "opt.remat": remat})
    model = factory.make_model(config, device="cpu", seed=seed)
    return (config, model, factory.make_criterion(config),
            factory.make_optimizer(config, model))


def test_remat_gives_the_same_step():
    """opt.remat (per-block torch.utils.checkpoint) changes no gradient
    and moves the BatchNorm statistics once, not again in the recompute."""
    batch = _torch_batch(_batch(seed=3))
    results = []
    for remat in (False, True):
        config, model, criterion, opt = _tiny(remat=remat)
        steps.train_step(model, opt, criterion, config, batch)
        results.append(({k: p.grad.clone() for k, p in
                         model.named_parameters() if p.grad is not None},
                        {k: v.clone() for k, v in model.state_dict().items()
                         if "running" in k or "num_batches" in k}))
    for k, g in results[0][0].items():
        assert _rel(results[1][0][k], g) <= 1e-5, k
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v), k


def test_packed_params_rebuilt_after_an_optimizer_step():
    """The eval kernel path folds V2V's BatchNorm once per weight version:
    an in-place Adam step (and the BN update) must invalidate the fold."""
    config, model, criterion, opt = _tiny()
    v2v = model.volume_net
    first = v2v.packed_params()
    assert v2v.packed_params() is first
    steps.train_step(model, opt, criterion, config,
                     _torch_batch(_batch(seed=4)))
    model.eval()
    second = v2v.packed_params()
    assert second is not first
    w, b = v2v.front_layers[0].folded()
    assert torch.equal(second["front"][0], w)
    assert not torch.equal(second["front"][0], first["front"][0])


def test_checkpoint_round_trip_resumes_bit_exactly(tmp_path):
    """Save after one step, then the second step from the live state and
    from the restored one agree bit for bit, the drawn rotations too."""
    batch = _torch_batch(_batch(seed=5))
    del batch["rotation_thetas"]                 # drawn from the generator
    config, model, criterion, opt = _tiny(seed=1)
    gen = torch.Generator().manual_seed(9)
    steps.train_step(model, opt, criterion, config, batch, gen)
    ckpt.save_checkpoint(str(tmp_path / "checkpoints" / "0000"), model, opt,
                         1, gen)
    live = steps.train_step(model, opt, criterion, config, batch, gen)

    config, model2, criterion, opt2 = _tiny(seed=2)
    gen2 = torch.Generator().manual_seed(0)
    step = ckpt.restore_checkpoint(
        ckpt.resolve_checkpoint_dir(str(tmp_path)), model2, opt2, gen2)
    assert step == 1
    resumed = steps.train_step(model2, opt2, criterion, config, batch, gen2)
    assert resumed == live
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k


def _train_lines(logdir):
    exp = next(p for p in logdir.iterdir() if p.is_dir())
    lines = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    return exp, [x for x in lines if x["tag"] == "train"]


def test_cli_trains_one_epoch_and_resumes(tmp_path):
    """python -m lt_tpu_torch.train on the synthetic two-stage config, one
    epoch on the CPU: 8 finite train records and a checkpoint; a resumed
    run continues at epoch 1, step 8."""
    from lt_tpu_torch import train as cli

    base = ["--config", SYNTH_YAML, "--device", "cpu"]
    metric = cli.main(base + ["--logdir", str(tmp_path / "a"),
                              "--max_epochs", "1"])
    assert np.isfinite(metric)
    exp, lines = _train_lines(tmp_path / "a")
    assert len(lines) == 8
    assert all(np.isfinite(x["total_loss"]) and np.isfinite(
        x["volumetric_ce_loss"]) for x in lines)
    assert ckpt.latest_epoch_dir(str(exp / "checkpoints")).endswith("0000")
    assert (exp / "checkpoints" / "0000" / ckpt.STATE_FILE).is_file()

    # The resumed epoch is cut to 2 steps to keep the test short.
    from lt_tpu_torch.engine.train import run

    run(SYNTH_YAML, str(tmp_path / "b"), max_epochs=2, resume_dir=str(exp),
        device="cpu", overrides={"dataset.train.n_samples": 4})
    exp_b, lines_b = _train_lines(tmp_path / "b")
    assert [x["step"] for x in lines_b] == [8, 9]
    assert ckpt.latest_epoch_dir(str(exp_b / "checkpoints")).endswith("0001")


@pytest.mark.slow
def test_end_to_end_volumetric_training_learns(tmp_path):
    """The port's analogue of test_data_and_engine's learning test: three
    epochs (24 steps) from the stage-1 backbone fixture with a fresh V2V;
    total loss and CE each drop below 0.95x (4-step means)."""
    from lt_tpu_torch.engine.train import run

    metric = run(SYNTH_YAML, str(tmp_path), max_epochs=3, device="cpu",
                 overrides={"model.init_weights": False})
    assert np.isfinite(metric)
    _, lines = _train_lines(tmp_path)
    assert len(lines) == 24
    for key in ("total_loss", "volumetric_ce_loss"):
        first = np.mean([x[key] for x in lines[:4]])
        last = np.mean([x[key] for x in lines[-4:]])
        assert last < 0.95 * first, f"{key}: {first} -> {last}"
