"""The two-stage synthetic volumetric recipe, on the port.

The port's counterpart of ``benchmarks/vol_two_stage.py``.  A volumetric
model trained from a random backbone on the synthetic set plateaus at the
cuboid-centroid floor (~330-380 mm rel MPJPE); the reference's workflow
starts from a pretrained 2D pose network, and so does this recipe:

Stage 1: the backbone alone on 2D heatmaps (``engine/pretrain_2d.py``),
         exported as an ``lt_tpu`` float16 ``.npz`` (``utils/fixture.py``).
Stage 2: ``experiments/synthetic/vol_pretrain.yaml`` from that backbone
         with the synthetic-domain recipe: volumetric CE weight 1.0,
         learning rates 5e-3 for the fresh process_features and V2V, the
         ground-truth pelvis.  A fresh V2V first learns the pose prior
         (val near the centroid floor), then couples to the image evidence
         around epoch 25-30: train MAE falls from 15 to below 5.
Polish:  the stage-2 train state continued on 2048 samples at the
         reference's CE weight 0.01 (:func:`polish`).

    python -m lt_tpu_torch.two_stage [bb_steps] [vol_epochs] [n_samples]
    python -m lt_tpu_torch.two_stage --resume VOL_DIR [bb_steps] [vol_epochs] \
        [n_samples]
    python -m lt_tpu_torch.two_stage --polish VOL_DIR

Defaults 600, 100, 1024 and ``--out logs/two_stage``; VOL_DIR is a stage-2
experiment directory (``VOL_DIR`` in the output).  ``--resume``
continues a stage 2 that was cut (``run(resume_dir=...)``: its newest epoch
checkpoint, up to ``vol_epochs``), without stage 1.  Every stage-2 or
polish run ends by writing its final weights as an ``lt_tpu`` ``.npz``,
``model.npz`` in its experiment directory, which ``lt_tpu``'s and the
port's ``run(..., eval_only=True)`` read as ``model.checkpoint``.  The
stages run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import pretrain_2d
from lt_tpu_torch.engine.train import run
from lt_tpu_torch.utils import fixture

VOL_YAML = "experiments/synthetic/vol_pretrain.yaml"
NUM_LAYERS = pretrain_2d.NUM_LAYERS
VOXEL_PITCH_MM = 2500.0 / 31


def stage2_overrides(bb_npz: Optional[str], n_samples: int,
                     epochs: int) -> dict:
    """``benchmarks/vol_two_stage.py``'s overrides of ``VOL_YAML``.  With no
    backbone ``.npz`` (a resumed run, whose train state holds the
    backbone) the backbone is not loaded."""
    return {"model.backbone.init_weights": bb_npz is not None,
            "model.backbone.checkpoint": bb_npz or "",
            "opt.volumetric_ce_loss_weight": 1.0,
            "opt.volume_net_lr": 5e-3,
            "opt.process_features_lr": 5e-3,
            "model.use_gt_pelvis": True,
            "dataset.train.n_samples": n_samples,
            "opt.n_epochs": epochs}


def export_npz(exp_dir: str) -> str:
    """The newest checkpoint of a volumetric experiment -> ``model.npz``
    beside it, in ``lt_tpu``'s format; returns its path."""
    state = ckpt.load_model_state(ckpt.resolve_checkpoint_dir(exp_dir))
    path = os.path.join(exp_dir, "model.npz")
    fixture.save_npz(path, fixture.import_volumetric_model(
        state, NUM_LAYERS, pretrain_2d.NUM_JOINTS))
    return path


def stage1(bb_steps: int, out: str, device="cuda") -> str:
    """Stage 1, then its backbone as ``out/backbone.npz``; returns that
    path."""
    bb_dir = pretrain_2d.main(n_steps=bb_steps,
                              out_dir=os.path.join(out, "backbone2d"),
                              device=device)
    state = ckpt.load_model_state(ckpt.resolve_checkpoint_dir(bb_dir))
    bb_npz = os.path.join(out, "backbone.npz")
    fixture.save_npz(bb_npz, fixture.import_pose_resnet(
        state, NUM_LAYERS, pretrain_2d.NUM_JOINTS, prefix="backbone."))
    print(f"STAGE1 backbone fixture: {bb_npz}", flush=True)
    return bb_npz


def _run_new(logdir: str, **kwargs):
    """``run(VOL_YAML, logdir, ...)``; returns its metric and the
    experiment directory it made under ``logdir``."""
    before = set(os.listdir(logdir)) if os.path.isdir(logdir) else set()
    metric = run(VOL_YAML, logdir, **kwargs)
    (name,) = set(os.listdir(logdir)) - before
    return metric, os.path.join(logdir, name)


def stage2(bb_npz: Optional[str], vol_epochs: int, n_samples: int, out: str,
           device="cuda", resume_dir: Optional[str] = None):
    """Stage 2 from the backbone ``bb_npz`` (or continued from
    ``resume_dir``); returns (val rel MPJPE, experiment directory)."""
    metric, vol_dir = _run_new(
        os.path.join(out, "vol"), resume_dir=resume_dir, device=device,
        overrides=stage2_overrides(bb_npz, n_samples, vol_epochs))
    print(f"STAGE2 vol MPJPE rel = {metric:.1f} mm "
          f"(voxel pitch {VOXEL_PITCH_MM:.1f} mm)", flush=True)
    print("VOL_DIR", vol_dir, flush=True)
    print("EXPORT", export_npz(vol_dir), flush=True)
    return metric, vol_dir


def polish(vol_dir: str, n_samples: int = 2048, epochs: int = 30,
           out: str = "logs/two_stage", device="cuda"):
    """The stage-2 train state of ``vol_dir`` (model, Adam, step) trained
    on for ``epochs`` epochs of ``n_samples`` samples at the reference's
    volumetric CE weight 0.01; returns (val rel MPJPE, experiment
    directory)."""
    overrides = {**stage2_overrides(None, n_samples, epochs),
                 "opt.volumetric_ce_loss_weight": 0.01,
                 "model.init_weights": True, "model.checkpoint": vol_dir}
    metric, pol_dir = _run_new(os.path.join(out, "polish"), device=device,
                               overrides=overrides)
    print(f"POLISH vol MPJPE rel = {metric:.1f} mm", flush=True)
    print("POLISH_DIR", pol_dir, flush=True)
    print("EXPORT", export_npz(pol_dir), flush=True)
    return metric, pol_dir


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bb_steps", type=int, nargs="?", default=600)
    ap.add_argument("vol_epochs", type=int, nargs="?", default=100)
    ap.add_argument("n_samples", type=int, nargs="?", default=1024)
    ap.add_argument("--out", default="logs/two_stage",
                    help="directory of the stages' outputs")
    ap.add_argument("--resume", default=None,
                    help="a stage-2 experiment dir to continue (no stage 1)")
    ap.add_argument("--polish", default=None,
                    help="a stage-2 experiment dir to polish (only that)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.polish:
        metric, pol_dir = polish(args.polish, out=args.out,
                                 device=args.device)
        return {"polish": metric, "polish_dir": pol_dir}
    bb_npz = (None if args.resume
              else stage1(args.bb_steps, args.out, args.device))
    metric, vol_dir = stage2(bb_npz, args.vol_epochs, args.n_samples,
                             args.out, args.device, args.resume)
    return {"stage2": metric, "vol_dir": vol_dir, "backbone_npz": bb_npz}


if __name__ == "__main__":
    main()
