"""The training engine's observability in lt_tpu_torch on the CPU.

- The port's copies of lt_tpu's utilities: the vis panels equal lt_tpu's
  pixel for pixel on the same seeded inputs (tensors on the port's side,
  numpy on lt_tpu's; both packages' layouts are the same),
  ``AverageMeter``, ``calc_gradient_norm`` (relative 1e-6) and
  ``config_to_str`` (equal strings).
- One cut ``vol_tiny.yaml`` CLI epoch with ``vis_freq: 1``,
  ``debug_nans: true`` and ``profile_dir``: the tensorboard events hold
  lt_tpu's tags (scalars, the keypoint and volume panels, the parameter
  histograms, the config text) and the profile directory one trace; the
  algebraic model's panels add the heatmaps.
- ``debug_nans``: a NaN image makes the training step raise
  ``FloatingPointError``; without it the step returns a NaN loss.
"""

import pathlib

import numpy as np
import pytest
import torch

from lt_tpu.utils import cfg as j_cfg
from lt_tpu.utils import misc as j_misc
from lt_tpu.utils import vis as j_vis
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.engine.train import log_vis_panels, run
from lt_tpu_torch.utils import cfg, misc, vis
from lt_tpu_torch.utils.example import example_train_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOL_YAML = str(ROOT / "experiments/synthetic/vol_tiny.yaml")
ALG_YAML = str(ROOT / "experiments/synthetic/alg_tiny.yaml")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vis_inputs():
    rng = np.random.RandomState(0)
    b, v, h, j = 2, 3, 48, 17
    proj = np.tile(np.array([[50, 0, 24, 0], [0, 50, 24, 0],
                             [0, 0, 1, 3000.0]], np.float32), (b, v, 1, 1))
    proj[:, :, :2, 3] = rng.uniform(-2e3, 2e3, (b, v, 2))
    kp3 = rng.uniform(-300, 300, (b, j, 3)).astype(np.float32)
    return {"images": rng.randn(b, v, h, h, 3).astype(np.float32),
            "proj": proj, "kp3": kp3,
            "kp3_pred": (kp3 + rng.normal(0, 30, kp3.shape)).astype(
                np.float32),
            "kp2": rng.uniform(0, h, (b, v, j, 2)).astype(np.float32),
            "conf": rng.rand(b, v, j).astype(np.float32),
            "heatmaps": rng.rand(b, v, j, 12, 12).astype(np.float32),
            "volumes": rng.rand(b, j, 8, 8, 8).astype(np.float32),
            "corners": rng.uniform(-100, 100, (b, 3)).astype(np.float32)}


def _panel(module, name, x, tensor):
    """One panel drawn by ``module`` (lt_tpu's vis or the port's) from
    :func:`_vis_inputs`, as tensors where ``tensor``."""
    t = {k: torch.from_numpy(v) if tensor else v for k, v in x.items()}
    sides = np.full(3, 500.0, np.float32)
    if name == "batch":
        return module.visualize_batch(
            t["images"], None, t["kp2"], t["proj"], t["kp3"], t["kp3_pred"],
            confidences=t["conf"], cuboids=(t["corners"], sides),
            batch_index=1)
    if name == "batch_cmu":
        return module.visualize_batch(
            t["images"], None, None, t["proj"], t["kp3"][:, :19],
            t["kp3_pred"], kind="cmu")
    if name == "heatmaps":
        return module.visualize_heatmaps(t["images"], t["heatmaps"],
                                         batch_index=1)
    if name == "volumes":
        return module.visualize_volumes(t["images"], t["volumes"], t["proj"],
                                        batch_index=1)
    if name == "voxels":
        return module.draw_voxels(t["volumes"][0, 3])
    image = (x["images"][0, 0] * 50 + 128).clip(0, 255)
    return module.draw_2d_pose_image(t["kp2"][0, 0], image)


@pytest.mark.parametrize("name", ["batch", "batch_cmu", "heatmaps",
                                  "volumes", "voxels", "pose_image"])
def test_vis_panels_are_lt_tpus_pixel_for_pixel(name):
    x = _vis_inputs()
    got, ref = _panel(vis, name, x, True), _panel(j_vis, name, x, False)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    assert got.ndim == 3 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, ref)
    assert got.std() > 0


def test_misc_and_config_text_are_lt_tpus():
    meter, j_meter = misc.AverageMeter(), j_misc.AverageMeter()
    for val, n in ((3.0, 2), (5.5, 1), (-1.0, 4)):
        meter.update(val, n)
        j_meter.update(val, n)
    assert vars(meter) == vars(j_meter)
    rng = np.random.RandomState(1)
    grads = {"a": rng.randn(3, 4).astype(np.float32),
             "b": rng.randn(7).astype(np.float32) * 100}
    got = misc.calc_gradient_norm({k: torch.from_numpy(v)
                                   for k, v in grads.items()})
    ref = j_misc.calc_gradient_norm(grads)
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    assert abs(float(misc.calc_gradient_norm(
        [torch.from_numpy(v) for v in grads.values()])) - float(ref)) <= \
        1e-6 * abs(float(ref))
    for path in (VOL_YAML, ALG_YAML):
        assert cfg.config_to_str(cfg.load_config(path)) == \
            j_cfg.config_to_str(j_cfg.load_config(path))


def _events(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(str(logdir), size_guidance={"images": 0,
                                                       "histograms": 0,
                                                       "tensors": 0,
                                                       "scalars": 0})
    acc.Reload()
    return acc.Tags()


def test_cli_epoch_writes_lt_tpus_tensorboard_panels_and_a_profile(
        tmp_path):
    profile = tmp_path / "profile"
    cut = {"vis_freq": 1, "vis_n_elements": 1, "debug_nans": True,
           "profile_dir": str(profile), "opt.n_iters_per_epoch": 2,
           "image_shape": [64, 64], "dataset.n_views": 2,
           "dataset.train.n_samples": 4, "dataset.val.n_samples": 4}
    metric = run(VOL_YAML, str(tmp_path / "logs"), max_epochs=1,
                 device="cpu", overrides=cut)
    assert np.isfinite(metric)
    assert not torch.is_anomaly_enabled()          # restored after the run
    exp = next((tmp_path / "logs").iterdir())
    tags = _events(exp / "tb")
    for name in ("total_loss", "MAE", "volumetric_ce_loss", "l2",
                 "base_point_l2", "grad_norm_times_lr", "batch_time"):
        assert f"train/{name}" in tags["scalars"], name
    for name in ("total_loss", "MAE", "dataset_metric"):
        assert f"val_epoch/{name}" in tags["scalars"], name
    assert "val_batch/batch_time" in tags["scalars"]
    # The volumetric model outputs no heatmaps: no heatmap panel, as lt_tpu.
    assert set(tags["images"]) == {"train/keypoints_vis/0",
                                   "train/volumes_vis/0"}
    model = factory.make_model(cfg.load_config(VOL_YAML), device="cpu")
    assert {f"model/{k.replace('.', '/')}" for k, _ in
            model.named_parameters()} == set(tags["histograms"])
    assert "config/text_summary" in tags["tensors"]
    traces = list(profile.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def _alg_setup(extra=None):
    config = cfg.load_config(ALG_YAML, {"model.backbone.num_joints": 5,
                                        "image_shape": [64, 64],
                                        **(extra or {})})
    model = factory.make_model(config, device="cpu", seed=1)
    batch = {k: torch.from_numpy(v) for k, v in
             example_train_batch(2, 64, 5, n_views=2, seed=2).items()}
    return config, model, batch


def test_algebraic_panels_add_the_heatmaps(tmp_path):
    from tensorboardX import SummaryWriter

    config, model, batch = _alg_setup({"vis_n_elements": 1})
    numpy_batch = {k: v.numpy() for k, v in batch.items()}
    with SummaryWriter(str(tmp_path)) as writer:
        log_vis_panels(writer, model, numpy_batch, batch, config, 7)
    tags = _events(tmp_path)
    assert set(tags["images"]) == {"train/keypoints_vis/0",
                                   "train/heatmaps_vis/0"}
    assert len(tags["histograms"]) == len(list(model.parameters()))


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_refuses_a_nan_image(debug_nans):
    config, model, batch = _alg_setup({"debug_nans": debug_nans})
    batch["images"][1, 0, 5, 7, 1] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = factory.make_optimizer(config, model)
    criterion = factory.make_criterion(config)
    if debug_nans:
        with pytest.raises(FloatingPointError, match="debug_nans"):
            steps.train_step(model, optimizer, criterion, config, batch)
        for k, v in model.state_dict().items():
            if "running" not in k and "num_batches" not in k:
                assert torch.equal(v, before[k]), k
    else:
        metrics = steps.train_step(model, optimizer, criterion, config,
                                   batch)
        assert np.isnan(metrics["total_loss"])
