"""bfloat16 training steps of the algebraic model and of the unfused
volumetric path on the CPU, by tests/test_torch_bf16_train.py's rule: from
the committed trained fixtures, the port's bfloat16 step's loss, per-group
gradients, Adam's update and BatchNorm statistics' moves within RATIO
(1.5) times lt_tpu's own bfloat16 step's distance from the float32 step.

'alg': the trained backbone fixture in the algebraic model without
confidences.  'conf': the volumetric fixture with the 'conf' aggregation,
which trains through the unfused path (K5 into bfloat16 samples, the
aggregation, K6); its confidence head is the port's seeded
initialization.  lt_tpu's distances are tests/test_torch_bf16_train.py's
LT_TPU_BAND, measured from the same fixtures, batch and rotations; the
unfused path itself is held to lt_tpu's Pallas path live
(test_torch_bf16_train.py::test_unprojection_training_paths_bf16_match_lt_tpu).
"""

import json

import numpy as np
import pytest
import torch
import yaml

from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_train_batch
from tests.test_torch_bf16_train import (ALG_YAML, B, LT_TPU_BAND, VOL_YAML,
                                         check_within_band, torch_threads)

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread outside the whole steps (which take
    STEP_THREADS): see tests/test_torch_bf16_train.py."""
    with torch_threads(1):
        yield


def test_bf16_step_loss_and_gradients_within_lt_tpu_band():
    """The algebraic step's loss and gradient.  Measured, port / lt_tpu:
    loss 2.52e-3 / 9.66e-3, backbone 0.153 / 0.158 (the port on
    STEP_THREADS; on one thread its loss reads 2.56e-2: the scalar loss is
    one draw, see test_torch_bf16_train.VOL_LOSS_LIMIT)."""
    check_within_band("alg", LT_TPU_BAND["alg"], ("loss", "gradient"))


def test_bf16_step_batchnorm_and_adam_within_lt_tpu_band():
    """The algebraic step's BatchNorm moves and Adam's update.  Measured,
    port / lt_tpu: mean moves 0.0203 / 0.0197, variance moves 0.0148 /
    0.0130, Adam 0.484 / 0.474."""
    check_within_band("alg", LT_TPU_BAND["alg"], ("move", "Adam"))


def test_conf_bf16_step_within_lt_tpu_band():
    """The 'conf' step (the unfused path), every distance.  Measured,
    port / lt_tpu: loss 2.1e-3 / 4.6e-3; gradients 0.148 / 0.131, 0.052 /
    0.073, 0.093 / 0.084; Adam 0.426 / 0.401, 0.209 / 0.224, 0.323 /
    0.319; moves 3.62e-3 / 3.96e-3, 5.9e-4 / 1.68e-3 (on one thread
    too)."""
    check_within_band("conf", LT_TPU_BAND["conf"],
                      ("loss", "gradient", "Adam", "move"))


# ---------------------------------------------------------------------------
# remat, the CLI and checkpoints in bfloat16
# ---------------------------------------------------------------------------


def _small_batch():
    """example_train_batch at batch 2, 2 views of 64^2: the port-only
    bfloat16 tests need no fixture."""
    return {k: torch.from_numpy(v) for k, v in example_train_batch(
        B, 64, 17, n_views=2, seed=7).items()}


def test_bf16_remat_gives_the_same_step():
    """opt.remat with bf16: true (vol_tiny_2stage.yaml at RN-18, 32^3,
    random weights): torch.utils.checkpoint recomputes each block under
    the forward's autocast state, so every gradient equals the step
    without remat's bit for bit and the BatchNorm statistics move once,
    not again in the recompute."""
    batch = _small_batch()
    results = []
    for remat in (False, True):
        config = cfg.load_config(VOL_YAML, {
            "bf16": True, "opt.remat": remat, "model.init_weights": False,
            "model.backbone.init_weights": False})
        model = factory.make_model(config, device="cpu", seed=3)
        steps.train_step(model, factory.make_optimizer(config, model),
                         factory.make_criterion(config), config, batch)
        results.append(({k: p.grad for k, p in model.named_parameters()
                         if p.grad is not None},
                        {k: v for k, v in model.state_dict().items()
                         if "running" in k or "num_batches" in k}))
    for k, g in results[0][0].items():
        assert torch.equal(results[1][0][k], g), k
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v), k


def _bf16_yaml(tmp_path, path, n_train, n_val):
    """``path`` with ``bf16: true`` and its data cut (2 views of 64^2,
    ``n_train`` / ``n_val`` poses), as a file."""
    with open(path) as f:
        config = yaml.safe_load(f)
    config["bf16"] = True
    config["image_shape"] = [64, 64]
    config["dataset"]["n_views"] = 2
    config["dataset"]["train"]["n_samples"] = n_train
    config["dataset"]["val"]["n_samples"] = n_val
    out = tmp_path / "bf16.yaml"
    out.write_text(yaml.safe_dump(config))
    return str(out)


def test_cli_bf16_epoch_and_resume(tmp_path):
    """python -m lt_tpu_torch.train on alg_tiny.yaml with ``bf16: true``
    (8 training and 4 validation poses, 2 views of 64^2): an epoch of
    finite train records
    and a float32 checkpoint; a resumed run continues at the next step.
    (The volumetric model's bfloat16 resume: the checkpoint test below.)"""
    from lt_tpu_torch import train as cli

    steps_per_epoch = 2
    path = _bf16_yaml(tmp_path, ALG_YAML, 8, 4)
    base = ["--config", path, "--device", "cpu"]
    metric = cli.main(base + ["--logdir", str(tmp_path / "a"),
                              "--max_epochs", "1"])
    assert np.isfinite(metric)
    exp = next((tmp_path / "a").iterdir())
    lines = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    train = [x for x in lines if x["tag"] == "train"]
    assert len(train) == steps_per_epoch
    assert all(np.isfinite(x["total_loss"]) for x in train)
    state = torch.load(exp / "checkpoints" / "0000" / ckpt.STATE_FILE,
                       weights_only=False)
    floats = [t for t in _tensors(state) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    cli.main(base + ["--logdir", str(tmp_path / "b"), "--max_epochs", "2",
                     "--resume", str(exp)])
    exp_b = next((tmp_path / "b").iterdir())
    steps_b = [json.loads(x)["step"] for x in open(exp_b / "metrics.jsonl")
               if json.loads(x)["tag"] == "train"]
    assert steps_b == list(range(steps_per_epoch, 2 * steps_per_epoch))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def test_bf16_checkpoint_resumes_bit_exactly(tmp_path):
    """A bfloat16 volumetric run (vol_tiny_2stage.yaml at RN-18, 32^3,
    random weights): save after one step, then the second step from the
    live state and from the restored one agree bit for bit, its drawn
    rotations too; Adam's state is float32."""
    config = cfg.load_config(VOL_YAML, {
        "bf16": True, "model.init_weights": False,
        "model.backbone.init_weights": False})
    batch = _small_batch()
    del batch["rotation_thetas"]                 # drawn from the generator

    def setup(seed):
        model = factory.make_model(config, device="cpu", seed=seed)
        return (model, factory.make_optimizer(config, model),
                factory.make_criterion(config))

    model, opt, criterion = setup(1)
    gen = torch.Generator().manual_seed(9)
    steps.train_step(model, opt, criterion, config, batch, gen)
    for st in opt.state.values():
        assert all(t.dtype == torch.float32 for t in st.values()
                   if t.is_floating_point() and t.dim())
    ckpt.save_checkpoint(str(tmp_path / "checkpoints" / "0000"), model, opt,
                         1, gen)
    live = steps.train_step(model, opt, criterion, config, batch, gen)
    model2, opt2, criterion = setup(2)
    gen2 = torch.Generator().manual_seed(0)
    assert ckpt.restore_checkpoint(ckpt.resolve_checkpoint_dir(
        str(tmp_path)), model2, opt2, gen2) == 1
    resumed = steps.train_step(model2, opt2, criterion, config, batch, gen2)
    assert resumed == live and np.isfinite(live["total_loss"])
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k


def test_cpu_bf16_step_refuses_nonfinite_gradients():
    """bf16: true on the CPU (alg_tiny.yaml, random weights, 2 views of
    64^2): a step whose gradients are not finite (a hook makes one
    weight's infinite) raises FloatingPointError before Adam, and no
    parameter moves."""
    config = cfg.load_config(ALG_YAML, {
        "bf16": True, "model.init_weights": False,
        "model.backbone.init_weights": False})
    model = factory.make_model(config, device="cpu", seed=0)
    opt = factory.make_optimizer(config, model)
    weight = next(p for p in model.parameters() if p.requires_grad)
    weight.register_hook(lambda g: g * float("inf"))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    with pytest.raises(FloatingPointError, match="refused"):
        steps.train_step(model, opt, factory.make_criterion(config), config,
                         _small_batch())
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
    assert not opt.state


def test_cpu_bf16_volumetric_step_refuses_a_faulty_conv3d(monkeypatch):
    """bf16: true on the CPU: where steps.cpu_bf16_conv3d_fault finds the
    bfloat16 conv3d weight gradient wrong (made so here), the volumetric
    step raises RuntimeError before its forward, and no parameter or
    statistic moves; the probe itself runs (None on a right torch)."""
    fault = steps.cpu_bf16_conv3d_fault()
    print(f"measured: cpu_bf16_conv3d_fault() on torch "
          f"{torch.__version__}: {fault}")
    assert fault is None or "relative error" in fault
    config = cfg.load_config(VOL_YAML, {
        "bf16": True, "model.init_weights": False,
        "model.backbone.init_weights": False})
    model = factory.make_model(config, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setattr(steps, "cpu_bf16_conv3d_fault",
                        lambda: "relative error 1.8e+17 against float64")
    with pytest.raises(RuntimeError, match="conv3d weight gradient"):
        steps.train_step(model, factory.make_optimizer(config, model),
                         factory.make_criterion(config), config,
                         _small_batch())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
