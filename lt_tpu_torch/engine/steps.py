"""The training and evaluation steps.

Port of ``lt_tpu/engine/steps.py:36-197``: the criterion plus, for the
volumetric model, the weighted volumetric CE and ``base_point_l2``, with
the reference's keypoint scaling, and the ``l2`` metric; one train step is
forward, loss, backward, clipping and the Adam update.  The model family
is ``config.model.name``: only 'vol' takes a pelvis and rotations.

A model that ``lt_tpu_torch.parallel.mesh.data_parallel`` wrapped trains
on this rank's rows of the global batch as ``lt_tpu`` trains on a batch
sharded over its mesh: the losses' normalizers and the logged metrics are
global, and the gradient is the global loss's.

A volumetric model under volume-axis sharding (``volume_axis_sharding``, a
``parallel.spatial.SlabGroup``) trains on the whole batch in every rank,
each rank holding its slab of every volume: the volumetric CE gathers the
whole volume (differentiable), the loss and metrics come out replicated,
and the gradients are averaged over the group before the norm and the
clipping (the convention of ``parallel/spatial.py``), so that every rank
takes the one-process step.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from lt_tpu_torch.models import losses
from lt_tpu_torch.models.triangulation import draw_rotation_thetas
from lt_tpu_torch.parallel.mesh import (all_sum, data_group, rank, unwrap,
                                        world_size)


def model_outputs(model, batch: Dict[str, torch.Tensor], config,
                  generator: Optional[torch.Generator] = None):
    """The model's forward over a batch dict.  The volumetric model's
    pelvis comes from the ground truth when ``model.use_gt_pelvis``, else
    from ``pred_keypoints_3d`` where the batch has it; an optional
    ``rotation_thetas`` (B,) pins its training rotations.  The algebraic
    and RANSAC models take images, projections and the view mask."""
    if config.model.name != "vol":
        return model(batch["images"], batch["proj_matrices"],
                     view_mask=batch.get("view_mask"))
    if config.model.get("use_gt_pelvis", False):
        pelvis = batch["keypoints_3d"]
    else:
        pelvis = batch.get("pred_keypoints_3d", batch["keypoints_3d"])
    return model(batch["images"], batch["proj_matrices"], pelvis,
                 view_mask=batch.get("view_mask"),
                 rotation_thetas=batch.get("rotation_thetas"),
                 generator=generator)


@functools.lru_cache(maxsize=None)
def cpu_bf16_conv3d_fault() -> Optional[str]:
    """None where the CPU's bfloat16 ``conv3d`` weight gradient (under
    autocast, as V2V trains) is right at V2V's 2^3 level (batch 2, 128
    channels, k=3, padding 1), else how far off it is.  PyTorch 2.11's is
    wrong there, by another amount on each call and on any thread count
    (1^3 and 4^3 are right), and made a V2V weight gradient of a CPU
    training step huge or its gradients' norm NaN; torch 2.13's is right
    (relative error 3.4e-3)."""
    gen = torch.Generator().manual_seed(0)
    x, gy = (torch.randn((2, 128, 2, 2, 2), generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    ref = torch.nn.grad.conv3d_weight(x.double(), (128, 128, 3, 3, 3),
                                      gy.double(), padding=1)
    worst = 0.0
    for _ in range(3):              # the faulty kernel differs call by call
        w = torch.zeros(ref.shape, requires_grad=True)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = torch.nn.functional.conv3d(x, w, padding=1)
        y.backward(gy.to(y.dtype))
        err = (w.grad.double() - ref).abs().max() / ref.abs().max()
        worst = max(worst, float(err.nan_to_num(float("inf"))))
    if worst <= 0.05:
        return None
    return (f"relative error {worst:.3e} against float64, whose max "
            f"|grad| is {float(ref.abs().max()):.3e}")


def _bf16(config) -> bool:
    """``bf16: true`` at the config's top level or under ``model``."""
    return bool(config.get("bf16", config.model.get("bf16", False)))


def _single_view_relative(kp_pred, kp_gt, base_joint: int):
    """Pelvis-relative keypoints for the one-view case."""
    j = kp_gt.shape[1]
    mask = (torch.arange(j, device=kp_gt.device) != base_joint).to(
        kp_gt.dtype)[None, :, None]
    gt = kp_gt - kp_gt[:, base_joint:base_joint + 1] * mask
    pred = kp_pred - kp_pred[:, base_joint:base_joint + 1] * mask
    return pred, gt


def whole_volumes(out, slabs):
    """A volumetric output whose ``volumes`` and ``coord_volumes`` are the
    whole volumes, gathered from the ranks' slabs where ``slabs`` (a
    ``SlabGroup``) is set (differentiable: ``SlabGroup.gather_x``)."""
    if slabs is None:
        return out
    return out._replace(volumes=slabs.gather_x(out.volumes, dim=2),
                        coord_volumes=slabs.gather_x(out.coord_volumes))


def compute_losses(criterion, config, out, batch, group=None):
    """(total loss, metrics): the criterion on scaled keypoints, plus for
    the volumetric model the weighted volumetric CE where
    ``opt.use_volumetric_ce_loss`` and ``base_point_l2``.  With a
    data-parallel ``group`` every normalizer is global and each value is
    this rank's share of the global one (their sum over the ranks)."""
    vol = config.model.name == "vol"
    kp_pred = out.keypoints_3d
    kp_gt = batch["keypoints_3d"][:, :, :3]
    validity = (batch["keypoints_validity"] > 0.0).to(kp_gt.dtype)
    scale = config.opt.get("scale_keypoints_3d", 1.0)

    if batch["images"].shape[1] == 1:
        base_joint = 6 if config.get("kind", "human36m") == "human36m" else 11
        kp_pred, kp_gt = _single_view_relative(kp_pred, kp_gt, base_joint)

    metrics = {}
    loss = criterion(kp_pred * scale, kp_gt * scale, validity, group=group)
    metrics[config.opt.criterion] = loss
    total = loss

    if vol and config.opt.get("use_volumetric_ce_loss", False):
        ce = losses.volumetric_ce_loss(out.coord_volumes, out.volumes, kp_gt,
                                       validity, group)
        metrics["volumetric_ce_loss"] = ce
        total = total + config.opt.get("volumetric_ce_loss_weight", 1.0) * ce

    kind = config.model.get("kind", "mpii")
    n_joints = kp_gt.shape[1]
    gt_base = None
    if vol and kind == "coco" and n_joints > 12:
        gt_base = (kp_gt[:, 11] + kp_gt[:, 12]) / 2.0
    elif vol and kind != "coco" and n_joints > 6:
        gt_base = kp_gt[:, 6]
    if gt_base is not None:
        diff = (out.base_points - gt_base) * scale
        # Samples with no valid joint (a padded eval tail) count for nothing.
        w = (validity.sum((1, 2)) > 0.0).to(validity.dtype)
        metrics["base_point_l2"] = ((diff ** 2).sum(-1).sqrt() * w).sum() \
            / all_sum(w.sum(), group).clamp_min(1.0)

    metrics["total_loss"] = total
    metrics["l2"] = losses.keypoints_l2_loss(kp_pred * scale, kp_gt * scale,
                                             validity, group)
    return total, metrics


def train_step(model, optimizer, criterion, config,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> dict:
    """One training step in place on ``model`` and ``optimizer``.

    Returns the metrics as floats, with ``grad_norm_times_lr``: the L2 norm
    of the trainable gradients before clipping, capped at the clip
    threshold, times ``opt.lr`` (``lt_tpu/engine/steps.py:153-163``).  A
    loss that no parameter reaches (RANSAC's hard argmax) has gradients of
    0, as in ``lt_tpu``: the step then updates only the BatchNorm
    statistics.

    ``model`` may be a ``data_parallel`` wrapper: ``batch`` is then this
    rank's rows, the volumetric model's rotations are this rank's rows of
    the global batch's draw, each rank's backward starts from the world
    size times its share of the global loss (the wrapper averages the
    gradients over the ranks), and the norm and the clipping see the
    reduced gradients.

    Under volume-axis sharding every rank trains on the whole batch and
    backpropagates the replicated loss; the gradients are then averaged
    over the slab group (``SlabGroup.average_grads``).

    ``debug_nans: true`` in the config: a non-finite metric (before the
    backward) or gradient norm (before Adam) raises
    ``FloatingPointError``, as ``jax_debug_nans`` stops ``lt_tpu``.

    ``bf16: true`` on the CPU: the volumetric model's step raises
    ``RuntimeError`` where :func:`cpu_bf16_conv3d_fault` finds this
    torch's bfloat16 ``conv3d`` weight gradient wrong, and any step whose
    gradients are not finite (their norm NaN or infinite) raises
    ``FloatingPointError`` before Adam would write them into the weights.
    """
    if _bf16(config) and config.model.name == "vol" and not any(
            p.is_cuda for p in model.parameters()):
        fault = cpu_bf16_conv3d_fault()
        if fault:
            raise RuntimeError(
                f"bf16: true on the CPU: torch {torch.__version__}'s "
                f"bfloat16 conv3d weight gradient is wrong at V2V's 2^3 "
                f"level ({fault}); train in float32 on the CPU, or on the "
                f"card")
    group = data_group(model)
    if (group is not None and config.model.name == "vol"
            and generator is not None and "rotation_thetas" not in batch):
        batch = {**batch, "rotation_thetas": draw_rotation_thetas(
            batch["images"].shape[0], generator, rank(group),
            world_size(group))}
    slabs = getattr(unwrap(model), "volume_axis_sharding", None)
    model.train()
    out = model_outputs(model, batch, config, generator)
    if slabs is not None and config.opt.get("use_volumetric_ce_loss"):
        out = whole_volumes(out, slabs)
    total, metrics = compute_losses(criterion, config, out, batch, group)
    names = list(metrics)
    values = all_sum(torch.stack([metrics[k].detach().double()
                                  for k in names]), group)
    debug = bool(config.get("debug_nans", False))
    if debug and not bool(values.isfinite().all()):
        raise FloatingPointError(f"debug_nans: non-finite metrics "
                                 f"{dict(zip(names, values.tolist()))}")
    optimizer.zero_grad(set_to_none=True)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if total.requires_grad:
        (total if group is None else total * world_size(group)).backward()
    else:
        for p in params:
            p.grad = torch.zeros_like(p)
    if slabs is not None:
        slabs.average_grads(params)
    lr = config.opt.lr
    norm = torch.nn.utils.get_total_norm(
        [p.grad for p in params if p.grad is not None])
    if ((debug or (_bf16(config) and not norm.is_cuda))
            and not bool(torch.isfinite(norm))):
        raise FloatingPointError(
            f"the gradients' norm is {float(norm)}; the step is refused "
            f"({'debug_nans: true' if debug else 'bf16: true on the CPU'}"
            f", torch {torch.__version__}: see "
            f"lt_tpu_torch.engine.steps.train_step)")
    if config.opt.get("grad_clip") is not None:
        max_norm = config.opt.grad_clip / lr
        torch.nn.utils.clip_grads_with_norm_(params, max_norm, norm)
        norm = norm.clamp_max(max_norm)
    optimizer.step()
    values = torch.cat([values, (norm * lr).double().view(1).to(
        values.device)])
    return dict(zip(names + ["grad_norm_times_lr"], values.tolist()))


@torch.no_grad()
def eval_step(model, criterion, config, batch: Dict[str, torch.Tensor]):
    """(keypoints (B, J, 3), metrics as floats) of the eval forward; for a
    ``data_parallel`` model, this rank's keypoints and the global
    metrics.  Under volume-axis sharding the volumetric CE (where
    configured) is taken on the whole volume, gathered from the ranks'
    slabs."""
    group = data_group(model)
    net = unwrap(model).eval()
    out = model_outputs(net, batch, config)
    slabs = getattr(net, "volume_axis_sharding", None)
    if slabs is not None and config.opt.get("use_volumetric_ce_loss"):
        out = whole_volumes(out, slabs)
    _, metrics = compute_losses(criterion, config, out, batch, group)
    values = all_sum(torch.stack([v.detach().double()
                                  for v in metrics.values()]), group)
    return out.keypoints_3d, dict(zip(metrics, values.tolist()))


@torch.no_grad()
def vis_step(model, config, batch: Dict[str, torch.Tensor]):
    """The eval-mode forward's whole output (heatmaps or volumes,
    confidences, base points) for the training panels: ``lt_tpu``'s
    ``make_vis_step`` (``lt_tpu/engine/steps.py:171-182``).  No collective
    runs, and one rank may call it alone, except under volume-axis
    sharding: there every rank of the slab group calls it (the forward's
    exchanges), and each gets the whole volumes."""
    net = unwrap(model).eval()
    return whole_volumes(model_outputs(net, batch, config),
                         getattr(net, "volume_axis_sharding", None))
