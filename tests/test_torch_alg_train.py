"""The algebraic and RANSAC families in the port's training engine, on the
CPU: one algebraic train step held to lt_tpu's in float64 (loss within
relative 1e-5, every gradient within relative 1e-4 of its tensor's
largest, BatchNorm statistics within 1e-5, Adam's update within 1e-4 * lr
where the gradient is not near 0), the losses and metrics each family
computes, RANSAC's step (no parameter reaches its loss: gradients of 0, as
in lt_tpu, so only the BatchNorm statistics move), the weights a run
starts from, and an ``alg_tiny.yaml`` CLI epoch and its resume.

Size: RN-18, 64^2 images, 5 joints, 4 views, batch 2 (alg_tiny.yaml's
recipe otherwise: MSESmooth, scale 0.1, lr 3e-4).
"""

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
from lt_tpu.models.triangulation import AlgebraicTriangulationNet as JAlg
from lt_tpu.utils import cfg as j_cfg
from lt_tpu.utils.fixture import save_model_npz
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.engine.train import init_model_state, run
from lt_tpu_torch.models.batchnorm import bn_fed_biases
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_train_batch
from lt_tpu_torch.utils.weights import (algebraic_state_dict,
                                        load_algebraic_npz,
                                        load_npz_variables)
from tests.test_torch_train import _lt_tpu_in_float64

ALG_YAML = "experiments/synthetic/alg_tiny.yaml"
FIXTURE = "tests/fixtures/backbone_rn18_synth.npz"
RANSAC_YAML = "experiments/human36m/eval/human36m_ransac.yaml"
B, V, IMG, J = 2, 4, 64, 5
SMALL = {"model.backbone.num_joints": J, "image_shape": [IMG, IMG]}
LOSS_TOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
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


def _config(path=ALG_YAML, extra=None):
    return cfg.load_config(path, {**SMALL, **(extra or {})})


@functools.lru_cache(maxsize=None)
def _jax_step():
    """lt_tpu's side of one algebraic train step in float64: the model's
    train apply, compute_losses('alg'), the gradients and its Adam, from
    float32-initialized weights.  Returns (config, float32 variables,
    loss, metrics, grads, new stats, new params), the last four float64."""
    config = j_cfg.load_config(ALG_YAML)
    config.model.backbone.num_joints = J
    batch = _batch()
    model = JAlg(num_joints=J, num_layers=18)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"][:1]),
        jnp.asarray(batch["proj_matrices"][:1]))))
    criterion = j_factory.make_criterion(config)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    with _lt_tpu_in_float64():
        model = JAlg(num_joints=J, num_layers=18, compute_dtype=jnp.float64)
        var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": var["batch_stats"]},
                jb["images"], jb["proj_matrices"], train=True,
                view_mask=jb["view_mask"], mutable=["batch_stats"])
            total, metrics = j_steps.compute_losses("alg", criterion, config,
                                                    out, jb)
            return total, (metrics, mutated["batch_stats"])

        (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(var["params"])
        tx = j_factory.make_optimizer(config, var["params"], "alg")
        updates, _ = tx.update(grads, tx.init(var["params"]), var["params"])
        new_params = optax.apply_updates(var["params"], updates)
        return (config, variables, float(loss), as_np(metrics), as_np(grads),
                as_np(stats), as_np(new_params))


def _by_name(params, stats):
    return {k: v.numpy() for k, v in algebraic_state_dict(
        {"params": params, "batch_stats": stats}, 18).items()}


@functools.lru_cache(maxsize=None)
def _port_step():
    _, variables, *_ = _jax_step()
    config = _config()
    model = factory.make_model(config, device="cpu")
    model.load_state_dict(algebraic_state_dict(variables, 18))
    model.double()
    opt = factory.make_optimizer(config, model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = steps.train_step(model, opt, factory.make_criterion(config),
                               config, _torch_batch(_batch(), torch.float64))
    return model, before, metrics


def test_algebraic_train_step_loss_and_metrics_match_lt_tpu():
    """float64: the loss within relative 1e-5 and the same metrics (the
    criterion, total_loss, l2: no volumetric CE or base_point_l2)."""
    _, _, ref_loss, ref_metrics, *_ = _jax_step()
    _, _, metrics = _port_step()
    assert abs(metrics["total_loss"] - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert set(metrics) == set(ref_metrics) | {"grad_norm_times_lr"}
    for k, v in ref_metrics.items():
        assert abs(metrics[k] - float(v)) <= LOSS_TOL * abs(float(v)), k


def _zero_in_exact_arithmetic(model):
    """The gradients that are 0 in exact arithmetic: biases that feed a
    BatchNorm, and the heatmap layer's bias, whose per-joint shift the 2D
    soft-argmax's softmax ignores."""
    return bn_fed_biases(model) | {"backbone.final_layer.bias"}


def test_algebraic_train_step_gradients_match_lt_tpu():
    """float64: every parameter, the final layer included (lt_tpu freezes
    it for 'vol' only), has a gradient within relative 1e-4 of its
    tensor's largest; the gradients that are 0 in exact arithmetic within
    1e-4 of the largest gradient."""
    _, variables, _, _, grads, _, _ = _jax_step()
    model, _, _ = _port_step()
    ref = _by_name(grads, variables["batch_stats"])
    fed = _zero_in_exact_arithmetic(model)
    scale = max(np.abs(v).max() for k, v in ref.items() if k not in fed)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if name in fed:
            assert np.abs(p.grad.numpy() - ref[name]).max() <= \
                GRAD_TOL * scale, name
        else:
            assert _rel(p.grad, ref[name]) <= GRAD_TOL, name


def test_algebraic_train_step_stats_and_adam_match_lt_tpu():
    """float64: every BatchNorm running statistic within relative 1e-5;
    Adam's first step within 1e-4 * lr where |g| is at least 1e-4 of its
    tensor's largest and not 0 in exact arithmetic, within 2 lr elsewhere
    (a sign rounding can flip)."""
    config, variables, _, _, grads, stats, new = _jax_step()
    model, _, _ = _port_step()
    state = model.state_dict()
    ref_stats = _by_name(variables["params"], stats)
    names = [k for k in ref_stats if k.endswith(("running_mean",
                                                 "running_var"))]
    assert len(names) > 20
    for name in names:
        assert _rel(state[name], ref_stats[name]) <= STATS_TOL, name
    g_ref = _by_name(grads, variables["batch_stats"])
    p_ref = _by_name(new, variables["batch_stats"])
    lr = config.opt.lr
    zero = _zero_in_exact_arithmetic(model)
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - p_ref[name])
        gr = np.abs(g_ref[name])
        if name not in zero:
            assert (diff <= 1e-4 * lr)[gr >= 1e-4 * gr.max()].all(), name
        assert diff.max() <= 2 * lr, name


def test_volumetric_terms_stay_with_the_volumetric_model():
    """An algebraic config that asks for the volumetric CE loss gets the
    criterion only, as lt_tpu's compute_losses gives it: no CE, no
    base_point_l2 (which read volumes and cuboid base points)."""
    config = _config(extra={"opt.use_volumetric_ce_loss": True,
                            "model.backbone.num_layers": 18})
    model = factory.make_model(config, device="cpu")
    batch = _torch_batch(_batch())
    kp, metrics = steps.eval_step(model, factory.make_criterion(config),
                                  config, batch)
    assert kp.shape == (B, J, 3)
    assert set(metrics) == {"MSESmooth", "total_loss", "l2"}
    assert metrics["total_loss"] == metrics["MSESmooth"]


def test_ransac_train_step_moves_only_the_batchnorm_statistics():
    """RANSAC's keypoints come from a hard argmax, so no parameter reaches
    the loss: the step gives gradients of 0 (lt_tpu's jax.grad gives the
    same), Adam leaves every parameter as it was, grad_norm_times_lr is 0,
    and the BatchNorm statistics move (batch statistics in training)."""
    config = _config(RANSAC_YAML, {"model.backbone.num_layers": 18,
                                   "opt.batch_size": B})
    model = factory.make_model(config, device="cpu")
    opt = factory.make_optimizer(config, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = steps.train_step(model, opt, factory.make_criterion(config),
                               config, _torch_batch(_batch(1)))
    assert np.isfinite(metrics["total_loss"])
    assert metrics["grad_norm_times_lr"] == 0.0
    after = model.state_dict()
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name
        assert p.grad is not None and not bool(p.grad.any()), name
    moved = [k for k in after if k.endswith("running_mean")
             and not torch.equal(after[k], before[k])]
    assert len(moved) > 10


def test_init_model_state_reads_whole_model_and_backbone_npz(tmp_path):
    """model.checkpoint: an lt_tpu whole-model .npz of the algebraic model
    (float16 weights, as lt_tpu.utils.fixture saves them) gives the port's
    state_dict of those variables (load_algebraic_npz gives the same);
    model.backbone.checkpoint: the trained
    backbone fixture fills the backbone where names and shapes match (17
    joints: not the 5-joint final layer)."""
    _, variables, *_ = _jax_step()
    path = str(tmp_path / "alg.npz")
    save_model_npz(path, variables["params"], variables["batch_stats"])
    config = _config(extra={"model.init_weights": True,
                            "model.checkpoint": path})
    model = factory.make_model(config, device="cpu", seed=4)
    init_model_state(config, model)
    ref = algebraic_state_dict(load_npz_variables(path), 18)
    loaded = factory.make_model(config, device="cpu", seed=5)
    load_algebraic_npz(loaded, path, 18)
    for (k, v), w in zip(model.state_dict().items(),
                         loaded.state_dict().values()):
        assert torch.equal(v, ref[k]) and torch.equal(w, v), k

    config = _config(extra={"model.backbone.init_weights": True,
                            "model.backbone.checkpoint": FIXTURE})
    model = factory.make_model(config, device="cpu", seed=4)
    fresh = model.backbone.final_layer.weight.clone()
    init_model_state(config, model)
    src = load_npz_variables(FIXTURE)["params"]
    assert torch.equal(model.backbone.conv1.weight, torch.from_numpy(
        src["conv1"]["kernel"]).permute(3, 2, 0, 1))
    assert torch.equal(model.backbone.final_layer.weight, fresh)


def test_alg_tiny_cli_epoch_and_resume(tmp_path):
    """python -m lt_tpu_torch.train on alg_tiny.yaml on the CPU (cut to 16
    training and 8 validation poses): 4 finite train records, a
    checkpoint, the AlgebraicTriangulationNet experiment directory; a
    resumed run continues at epoch 1, step 4."""
    from lt_tpu_torch import train as cli

    cut = {"dataset.train.n_samples": 16, "dataset.val.n_samples": 8}
    args = cli.parse_args(["--config", ALG_YAML, "--device", "cpu",
                           "--logdir", str(tmp_path / "a"),
                           "--max_epochs", "1"])
    metric = run(args.config, args.logdir, max_epochs=args.max_epochs,
                 device=args.device, overrides=cut)
    assert np.isfinite(metric)
    exp = next((tmp_path / "a").iterdir())
    assert "AlgebraicTriangulationNet@" in exp.name
    lines = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    train = [x for x in lines if x["tag"] == "train"]
    assert len(train) == 4
    assert all(np.isfinite(x["total_loss"]) for x in train)
    assert (exp / "checkpoints" / "0000" / ckpt.STATE_FILE).is_file()
    run(ALG_YAML, str(tmp_path / "b"), max_epochs=2, resume_dir=str(exp),
        device="cpu", overrides=cut)
    exp_b = next((tmp_path / "b").iterdir())
    steps_b = [json.loads(x)["step"] for x in open(exp_b / "metrics.jsonl")
               if json.loads(x)["tag"] == "train"]
    assert steps_b == [4, 5, 6, 7]
    assert ckpt.latest_epoch_dir(str(exp_b / "checkpoints")).endswith("0001")


@pytest.mark.parametrize("name", ["alg", "ransac"])
def test_training_in_bfloat16_raises(name):
    """bf16: true trains (it raised before bfloat16 training was ported;
    the name stays): the step's loss is finite, the parameters, their
    gradients and Adam's moments stay float32; the algebraic model's
    parameters move, RANSAC's gradients are 0 (its hard argmax, as in
    float32).  tests/test_torch_bf16_steps.py holds the algebraic bfloat16
    step to lt_tpu's."""
    path = ALG_YAML if name == "alg" else RANSAC_YAML
    config = _config(path, {"bf16": True, "model.backbone.num_layers": 18,
                            "opt.batch_size": B})
    model = factory.make_model(config, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    opt = factory.make_optimizer(config, model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = steps.train_step(model, opt, factory.make_criterion(config),
                               config, _torch_batch(_batch()))
    assert np.isfinite(metrics["total_loss"])
    params = dict(model.named_parameters())
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in params.values())
    assert all(t.dtype == torch.float32 for st in opt.state.values()
               for t in st.values() if t.dim())
    moved = sum(not torch.equal(p, before[k]) for k, p in params.items())
    if name == "alg":
        assert moved > len(params) // 2
    else:
        assert metrics["grad_norm_times_lr"] == 0.0 and moved == 0


def _fixture_keypoints_lt_tpu(family, images, proj):
    """lt_tpu's float32 and bfloat16 keypoints of ``family`` on the trained
    backbone fixture."""
    from lt_tpu.models import triangulation as jtri
    from lt_tpu.utils.fixture import load_backbone_npz

    src = load_backbone_npz(FIXTURE)
    variables = {"params": {"backbone": src["params"]},
                 "batch_stats": {"backbone": src["batch_stats"]}}
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        if family == "alg":
            model = jtri.AlgebraicTriangulationNet(
                num_joints=17, num_layers=18, use_confidences=False,
                compute_dtype=dt)
        else:
            model = jtri.RANSACTriangulationNet(num_joints=17, num_layers=18,
                                                compute_dtype=dt)
        out[dt] = np.asarray(jax.jit(model.apply)(
            variables, jnp.asarray(images), jnp.asarray(proj)).keypoints_3d)
    return out[jnp.float32], out[jnp.bfloat16]


@pytest.mark.parametrize("family", ["alg", "ransac"])
def test_fixture_bfloat16_band_of_lt_tpu(family):
    """The band chip_smoke.py's [alg fixture] phase holds bfloat16 to, on
    the trained backbone fixture and 8 validation poses (128^2), measured
    for lt_tpu and for the port on the CPU: the rel MPJPE of bfloat16
    within 3 mm of float32's for both models; the algebraic model's
    per-joint distances within mean 12 / max 100 mm (lt_tpu measured mean
    5.57, max 49.5 mm: the volumetric fixture's 3 / 15 mm does not hold
    for lt_tpu itself here; RANSAC's argmax moves a joint by up to 215 mm
    in lt_tpu and is held by its MPJPE only)."""
    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
    from lt_tpu_torch.models.triangulation import (AlgebraicTriangulationNet,
                                                   RANSACTriangulationNet)
    from lt_tpu_torch.utils.weights import load_backbone_npz

    ds = SyntheticMultiViewDataset(n_samples=8, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    val = [ds[i] for i in range(len(ds))]
    images = np.stack([np.stack(s["images"]) for s in val]).astype(
        np.float32)
    proj = np.stack([np.stack(s["proj_matrices"]) for s in val]).astype(
        np.float32)
    port = {}
    for dt in (torch.float32, torch.bfloat16):
        net = (AlgebraicTriangulationNet(num_joints=17, num_layers=18,
                                         use_confidences=False, device="cpu",
                                         compute_dtype=dt)
               if family == "alg" else
               RANSACTriangulationNet(num_joints=17, num_layers=18,
                                      device="cpu", compute_dtype=dt))
        load_backbone_npz(net, FIXTURE, 18)
        port[dt] = net(torch.from_numpy(images),
                       torch.from_numpy(proj)).keypoints_3d.numpy()
    for name, (f32, bf16) in (
            ("lt_tpu", _fixture_keypoints_lt_tpu(family, images, proj)),
            ("port", (port[torch.float32], port[torch.bfloat16]))):
        d = np.linalg.norm(bf16 - f32, axis=-1)
        dm = abs(ds.evaluate(bf16)[0] - ds.evaluate(f32)[0])
        print(f"{family} {name}: bfloat16 vs float32 per joint mean "
              f"{d.mean():.3f} max {d.max():.3f} mm, rel MPJPE difference "
              f"{dm:.3f} mm")
        assert np.isfinite(d).all() and dm <= 3.0, (name, dm)
        if family == "alg":
            assert d.mean() <= 12.0 and d.max() <= 100.0, (name, d.mean(),
                                                            d.max())
