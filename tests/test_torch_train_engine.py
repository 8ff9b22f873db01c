"""The port's training engine on the CPU: losses and one BatchNorm call
against lt_tpu / flax, remat, the packed eval weights after an optimizer
step, checkpoints and the CLI.  The whole train step against lt_tpu's
(loss, gradients, BatchNorm statistics, Adam, gradient clipping, the
optimizer groups) is tests/test_torch_train.py, whose cached float64
lt_tpu step these tests do not need: in a file of their own they run on
another worker under ``--dist loadfile``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.models import losses as j_losses
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.models import losses
from lt_tpu_torch.models.batchnorm import BatchNorm
from lt_tpu_torch.utils import cfg
from tests.test_torch_train import SYNTH_YAML, _batch, _rel, _torch_batch


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on two threads, as tests/test_torch_h36m.py's fixture: these
    tests' small steps gain little from more, and beside the suite's other
    processes lose many times their work waiting for descheduled threads
    (the CLI test took 324-506 s of a worker in the suite on eight, 67 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
