"""Factories: config -> model, criterion, optimizer.

Port of ``lt_tpu/engine/factory.py`` for the volumetric model: Adam with
per-module learning-rate groups, the ``grad_clip / lr`` clipping convention
and the frozen backbone ``final_layer``, which here is left out of the
optimizer with ``requires_grad=False`` (``lt_tpu`` zeroes its update with
an optax mask).
"""

from __future__ import annotations

import torch

from lt_tpu_torch.models import losses
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet

#: Optimizer groups in the order the optimizer holds them.
GROUPS = ("backbone", "process_features", "volume_net")


def make_model(config, device="cuda", use_kernels="fused",
               seed: int = 0) -> VolumetricTriangulationNet:
    """The configured volumetric model on ``device`` (the CUDA kernels
    there; their plain versions only where ``device`` is the CPU).

    ``use_kernels``: ``"fused"``, ``"conv"`` or ``False``
    (``models/v2v.py``).  ``bf16: true`` in the config (top level or under
    ``model``) builds the bfloat16 eval model, as in ``lt_tpu``; training
    it raises ``NotImplementedError``: the port trains in float32."""
    m = config.model
    if m.name != "vol":
        raise NotImplementedError(f"the port has the volumetric model only, "
                                  f"not {m.name!r}")
    bf16 = bool(config.get("bf16", m.get("bf16", False)))
    backbone = m.backbone
    return VolumetricTriangulationNet(
        num_joints=backbone.num_joints, num_layers=backbone.num_layers,
        style=backbone.get("style", "simple"),
        volume_aggregation_method=m.get("volume_aggregation_method",
                                        "softmax"),
        volume_softmax=m.get("volume_softmax", True),
        volume_multiplier=m.get("volume_multiplier", 1.0),
        volume_size=m.get("volume_size", 64),
        cuboid_side=m.get("cuboid_side", 2500.0),
        kind=m.get("kind", "mpii"),
        transfer_cmu_to_human36m=m.get("transfer_cmu_to_human36m", False),
        use_kernels=use_kernels, remat=bool(config.opt.get("remat", False)),
        device=device, seed=seed,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)


def make_criterion(config):
    """The keypoint criterion of ``opt.criterion``."""
    return losses.make_criterion(
        config.opt.criterion, config.opt.get("mse_smooth_threshold", 400.0))


def make_optimizer(config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam with the backbone at ``opt.lr``, ``process_features`` at
    ``opt.process_features_lr`` and ``volume_net`` at ``opt.volume_net_lr``
    (each defaulting to ``opt.lr``); freezes ``backbone.final_layer``,
    which the optimizer does not hold.  ``opt.grad_clip`` is applied by
    ``engine.steps.train_step`` as ``clip_grad_norm_(grad_clip / lr)``."""
    opt = config.opt
    lrs = {"backbone": opt.lr,
           "process_features": opt.get("process_features_lr", opt.lr),
           "volume_net": opt.get("volume_net_lr", opt.lr)}
    model.backbone.final_layer.requires_grad_(False)
    return torch.optim.Adam(
        [{"params": [p for p in getattr(model, g).parameters()
                     if p.requires_grad], "lr": lrs[g], "name": g}
         for g in GROUPS])
