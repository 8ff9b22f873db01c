"""The Human3.6M slice end to end on the CPU, and the weight sources.

- ``run(..., eval_only=True, device="cpu")`` of
  ``experiments/human36m/eval/human36m_vol_softmax.yaml`` on a small
  Human3.6M tree (``chip_smoke.write_h36m_tree``: 160^2 frames, 5 test
  rows, one view missing; RN-18, 64^2 images, 32^3, val batch 2: two full
  batches and a ragged one) in the port and in ``lt_tpu.engine.train.run``
  from the same whole-model ``.pth``, saved by the port with DDP's
  ``module.`` names: keypoints within 0.05 mm, the same ``metric.json``
  breakdown within relative 1e-5 (keypoints of a few hundred mm at random
  weights), the same order.
- That ``.pth`` read by ``lt_tpu``'s ``torch_import.import_volumetric_model``
  is the port's state_dict exactly; a backbone ``.pth`` with and without
  ``backbone.`` in its names loads as ``lt_tpu``'s ``import_pose_resnet``
  imports it (the final layer adapted to the joint count as there); a
  partial or misshapen whole-model ``.pth`` is refused; an experiment
  directory serves as backbone and as whole-model weights.
- One training epoch of ``experiments/human36m/train/human36m_vol_softmax
  .yaml`` on the tree, from a backbone ``.pth``, and its resume.
"""

import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from lt_tpu.utils import torch_import  # noqa: E402
from lt_tpu_torch.engine import checkpoint as ckpt  # noqa: E402
from lt_tpu_torch.engine import factory  # noqa: E402
from lt_tpu_torch.engine import train as engine  # noqa: E402
from lt_tpu_torch.utils import cfg, weights  # noqa: E402
from tests.test_torch_data import assert_same_metric  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

EVAL_YAML = "experiments/human36m/eval/human36m_vol_softmax.yaml"
TRAIN_YAML = "experiments/human36m/train/human36m_vol_softmax.yaml"
SMALL = {"image_shape": [64, 64], "model.volume_size": 32,
         "model.backbone.num_layers": 18, "opt.val_batch_size": 2}
N_TEST, LAYERS = 5, 18


def _randomize_stats(model, seed):
    """BatchNorm statistics away from their init (mean 0, var 1), so that
    importing them is tested."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
            elif k.endswith("running_var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=g))
    return model


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on two threads for this module's small shapes: more gain
    little here and, beside other busy processes, lose many times their
    work waiting for a descheduled thread (the training test alone: 5.8 s
    on 8 threads, 66 s beside 7 busy processes on 8 cores; 10.7 and 13.7
    s on 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("h36m")
    out = chip_smoke.write_h36m_tree(root / "tree", seed=0, frame=160,
                                     n_test=N_TEST, n_train=5)
    out["pth"] = str(root / "human36m_vol_softmax.pth")
    config = cfg.load_config(EVAL_YAML, SMALL)
    model = _randomize_stats(factory.make_model(config, device="cpu",
                                                seed=3), 0)
    chip_smoke.save_ddp_pth(model, out["pth"])
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def _overrides(tree):
    return {**SMALL, **chip_smoke.h36m_overrides(tree),
            "model.checkpoint": tree["pth"]}


def _outputs(logdir):
    (exp,) = [p for p in Path(logdir).iterdir() if p.is_dir()]
    ck = exp / "checkpoints" / "0000"
    with open(ck / "results.pkl", "rb") as f:
        results = pickle.load(f)
    return results, json.loads((ck / "metric.json").read_text())


def test_eval_run_is_lt_tpus(tree, tmp_path, capsys):
    from lt_tpu.engine.train import run as j_run

    got_metric = engine.run(EVAL_YAML, str(tmp_path / "port"),
                            eval_only=True, overrides=_overrides(tree),
                            device="cpu")
    printed = capsys.readouterr().out
    assert "Image decoder: native libjpeg pipeline" in printed
    assert ("Loaded model weights from" in printed
            and "0 of its entries unused" in printed)
    want_metric = j_run(EVAL_YAML, str(tmp_path / "jax"), eval_only=True,
                        overrides=_overrides(tree))
    got, got_json = _outputs(tmp_path / "port")
    want, want_json = _outputs(tmp_path / "jax")
    np.testing.assert_array_equal(got["indexes"], want["indexes"])
    assert got["keypoints_3d"].shape == (N_TEST, 17, 3)
    err = np.abs(got["keypoints_3d"] - want["keypoints_3d"]).max()
    assert err <= 0.05, err
    np.testing.assert_allclose(got_metric, want_metric, rtol=1e-5)
    assert_same_metric(got_json, want_json, rel=1e-5)
    ds = engine.make_datasets(cfg.load_config(EVAL_YAML, _overrides(tree)),
                              is_train=False)[1]
    chip_smoke.check_h36m_metric(got_json, got, ds)


def test_pth_reads_the_same_in_lt_tpu(tree):
    """The port's .pth through lt_tpu's importer and back is the port's
    state_dict, and the port's strict load leaves nothing over."""
    sd = torch_import.load_state_dict(tree["pth"])
    back = weights.volumetric_state_dict(
        torch_import.import_volumetric_model(sd, LAYERS, 17), LAYERS)
    state = tree["state"]
    assert set(back) == set(state)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    model = factory.make_model(cfg.load_config(EVAL_YAML, SMALL),
                               device="cpu", seed=0)
    assert weights.load_strict(model, weights.load_pth(tree["pth"]),
                               "model") == []
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def _bare_backbone_pth(tree, path, prefix, joints=17):
    """The tree's model's backbone as a pose network's .pth: names under
    ``prefix``, a final layer of ``joints``."""
    sd = {k[len("backbone."):]: v for k, v in tree["state"].items()
          if k.startswith("backbone.")}
    if joints != 17:
        sd["final_layer.weight"] = torch.randn(joints, 256, 1, 1)
        sd["final_layer.bias"] = torch.randn(joints)
    torch.save({"state_dict": {prefix + k: v for k, v in sd.items()}}, path)
    return path


@pytest.mark.parametrize("name, prefix, joints", [
    *[("vol", p, j) for p in ("", "backbone.", "module.backbone.")
      for j in (17, 16)],
    ("alg", "", 16), ("alg", "backbone.", 17)])
def test_backbone_pth_loads_as_lt_tpu_imports_it(tree, tmp_path, prefix,
                                                 joints, name):
    """A pose network's .pth, its names bare or under ``backbone.`` (and
    DDP's ``module.``), its final layer for 17 joints or 16 (re-made for
    17 as lt_tpu makes it), into the volumetric model and into the
    algebraic one, whose confidence head the .pth lacks."""
    path = _bare_backbone_pth(tree, str(tmp_path / "bb.pth"), prefix,
                              joints)
    yaml = EVAL_YAML if name == "vol" else \
        "experiments/human36m/eval/human36m_alg.yaml"
    config = cfg.load_config(yaml, {
        **SMALL, "model.init_weights": False,
        "model.backbone.init_weights": True,
        "model.backbone.checkpoint": path})
    model = factory.make_model(config, device="cpu", seed=1)
    report = engine.init_model_state(config, model)
    assert report["backbone"]["unused"] == []
    sd = torch_import.load_state_dict(path)
    strip = "backbone." if prefix else ""
    ref = weights.backbone_state_dict(torch_import.import_pose_resnet(
        {k[len(strip):]: v for k, v in sd.items()}, LAYERS, 17), LAYERS)
    state = model.state_dict()
    for k, v in ref.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_partial_or_misshapen_model_pth_is_refused(tree, tmp_path):
    config = cfg.load_config(EVAL_YAML, _overrides(tree))
    sd = torch.load(tree["pth"], weights_only=True)
    partial = dict(sd)
    del partial["module.volume_net.back_layers.1.block.0.weight"]
    misshapen = dict(sd)
    misshapen["module.process_features.0.bias"] = torch.zeros(3)
    for label, bad in (("missing", partial), ("shape", misshapen)):
        path = str(tmp_path / f"{label}.pth")
        torch.save(bad, path)
        config.model.checkpoint = path
        with pytest.raises(ValueError, match="model weights"):
            engine.init_model_state(config, factory.make_model(
                config, device="cpu", seed=0))


def test_epoch_trains_from_a_backbone_pth_and_resumes(tree, tmp_path,
                                                      capsys):
    """One training epoch of the vol training config on the tree (one
    step at batch 2, 32^2 images, the backbone from a .pth, one row
    evaluated) and its resume for a second; then that experiment as the
    backbone of a model and as the train state ``run`` restores from
    ``model.checkpoint``."""
    bb = _bare_backbone_pth(tree, str(tmp_path / "pose_resnet.pth"), "")
    ov = {**SMALL, **chip_smoke.h36m_overrides(tree),
          **{f"dataset.train.{k}": tree[k] for k in ("h36m_root",
                                                     "labels_path")},
          "dataset.train.pred_results_path": None,
          "dataset.val.retain_every_n_frames_in_test": N_TEST,
          "model.backbone.checkpoint": bb, "image_shape": [32, 32],
          "opt.batch_size": 2, "opt.n_objects_per_epoch": 2,
          "opt.val_batch_size": 1}
    logdir = tmp_path / "train"
    first = engine.run(TRAIN_YAML, str(logdir), max_epochs=1, overrides=ov,
                       device="cpu")
    (exp,) = list(logdir.iterdir())
    assert np.isfinite(first)
    engine.run(TRAIN_YAML, str(tmp_path / "resumed"), max_epochs=2,
               resume_dir=str(exp), overrides=ov, device="cpu")
    (exp2,) = list((tmp_path / "resumed").iterdir())
    records = [json.loads(x) for x in
               (exp2 / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if r["tag"] == "train"] == [1]
    latest = ckpt.resolve_checkpoint_dir(str(exp2))
    assert latest.endswith("0001")
    trained = ckpt.load_model_state(latest)

    # The experiment as backbone weights (merged where names and shapes
    # match) and as model.checkpoint: run restores its train state
    # (weights, optimizer, step), as lt_tpu restores its Orbax state.
    scalar = engine.run(EVAL_YAML, str(tmp_path / "eval"), eval_only=True,
                        overrides={**_overrides(tree),
                                   "model.checkpoint": str(exp2),
                                   "model.backbone.init_weights": True,
                                   "model.backbone.checkpoint": str(exp2),
                                   "dataset.val.retain_every_n_frames_in_test":
                                   N_TEST, "opt.val_batch_size": 1},
                        device="cpu")
    assert np.isfinite(scalar)
    printed = capsys.readouterr().out
    n_backbone = sum(k.startswith("backbone.") for k in trained)
    assert (f"Loaded backbone weights from {exp2}: {n_backbone} tensors"
            in printed)
    assert f"Restored the train state of {latest} (step 2)" in printed
