"""Factories: config -> model, criterion, optimizer.

Port of ``lt_tpu/engine/factory.py`` for the three model families
(``MODEL_NAMES``): the algebraic model ('alg'), the volumetric model
('vol') and RANSAC ('ransac').  Adam with per-module learning-rate groups
for 'vol' and one group at ``opt.lr`` for the others, the ``grad_clip /
lr`` clipping convention, and the volumetric model's frozen backbone
``final_layer``, which here is left out of the optimizer with
``requires_grad=False`` (``lt_tpu`` zeroes its update with an optax mask).
"""

from __future__ import annotations

import torch

from lt_tpu_torch.models import losses
from lt_tpu_torch.models.triangulation import (AlgebraicTriangulationNet,
                                               RANSACTriangulationNet,
                                               VolumetricTriangulationNet)

MODEL_NAMES = ("ransac", "alg", "vol")
#: The volumetric model's optimizer groups, in the order the optimizer holds
#: them.
GROUPS = ("backbone", "process_features", "volume_net")


def make_model(config, device="cuda", use_kernels="fused", seed: int = 0):
    """The configured model family on ``device`` (the CUDA kernels there;
    their plain versions only where ``device`` is the CPU).

    ``use_kernels`` (the volumetric model's only: the algebraic and RANSAC
    models launch no kernel of the port): ``"fused"``, ``"conv"`` or
    ``False`` (``models/v2v.py``).  ``bf16: true`` in the config (top level
    or under ``model``) computes in bfloat16, as in ``lt_tpu``
    (``lt_tpu/engine/factory.py:37-43``), in eval and in training: the
    parameters stay float32 (the master weights, which Adam updates from
    float32 gradients and checkpoints save), the convolutions run in
    bfloat16.  ``opt.remat`` recomputes the backbone's (and V2V's) blocks in
    the backward."""
    m = config.model
    bf16 = bool(config.get("bf16", m.get("bf16", False)))
    backbone = m.backbone
    common = dict(num_joints=backbone.num_joints,
                  num_layers=backbone.num_layers,
                  style=backbone.get("style", "simple"),
                  remat=bool(config.opt.get("remat", False)),
                  device=device, seed=seed,
                  compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    if m.name == "alg":
        return AlgebraicTriangulationNet(
            use_confidences=m.get("use_confidences", True),
            heatmap_softmax=m.get("heatmap_softmax", True),
            heatmap_multiplier=m.get("heatmap_multiplier", 100.0), **common)
    if m.name == "vol":
        return VolumetricTriangulationNet(
            volume_aggregation_method=m.get("volume_aggregation_method",
                                            "softmax"),
            volume_softmax=m.get("volume_softmax", True),
            volume_multiplier=m.get("volume_multiplier", 1.0),
            volume_size=m.get("volume_size", 64),
            cuboid_side=m.get("cuboid_side", 2500.0),
            kind=m.get("kind", "mpii"),
            transfer_cmu_to_human36m=m.get("transfer_cmu_to_human36m", False),
            use_kernels=use_kernels, **common)
    if m.name == "ransac":
        return RANSACTriangulationNet(
            direct_optimization=m.get("direct_optimization", True), **common)
    raise ValueError(f"Unknown model name: {m.name}")


def make_criterion(config):
    """The keypoint criterion of ``opt.criterion``."""
    return losses.make_criterion(
        config.opt.criterion, config.opt.get("mse_smooth_threshold", 400.0))


def make_optimizer(config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam.  'vol': the backbone at ``opt.lr``, ``process_features`` at
    ``opt.process_features_lr`` and ``volume_net`` at ``opt.volume_net_lr``
    (each defaulting to ``opt.lr``); freezes ``backbone.final_layer``,
    which the optimizer does not hold.  'alg' and 'ransac': every parameter
    in one group at ``opt.lr``.  ``opt.grad_clip`` is applied by
    ``engine.steps.train_step`` as ``clip_grad_norm_(grad_clip / lr)``."""
    opt = config.opt
    if config.model.name != "vol":
        return torch.optim.Adam([{"params": list(model.parameters()),
                                  "lr": opt.lr, "name": "backbone"}])
    lrs = {"backbone": opt.lr,
           "process_features": opt.get("process_features_lr", opt.lr),
           "volume_net": opt.get("volume_net_lr", opt.lr)}
    model.backbone.final_layer.requires_grad_(False)
    return torch.optim.Adam(
        [{"params": [p for p in getattr(model, g).parameters()
                     if p.requires_grad], "lr": lrs[g], "name": g}
         for g in GROUPS])
