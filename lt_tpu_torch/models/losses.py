"""Keypoint and volumetric losses.

Port of ``lt_tpu/models/losses.py``: masked by per-joint validity and
normalized by the valid count with a floor of 1; the volumetric CE is the
vectorised nearest-voxel form.

``group``: the process group over which the batch is split under data
parallelism (``lt_tpu_torch.parallel``).  Each normalizer is then the
global one (the valid count, the CE's (sample, joint) pairs), as ``lt_tpu``
computes it on a batch sharded over its mesh, and a rank's loss is its
share of the global loss: the shares sum to it.
"""

from __future__ import annotations

import torch

from lt_tpu_torch.parallel.mesh import all_sum, world_size


def _valid_count(validity: torch.Tensor, group=None) -> torch.Tensor:
    return all_sum(validity.sum(), group).clamp_min(1.0)


def keypoints_mse_loss(pred: torch.Tensor, gt: torch.Tensor,
                       validity: torch.Tensor, group=None) -> torch.Tensor:
    """Masked MSE.  pred, gt: (B, J, D); validity: (B, J, 1)."""
    loss = ((gt - pred) ** 2 * validity).sum()
    return loss / (pred.shape[-1] * _valid_count(validity, group))


def keypoints_mse_smooth_loss(pred: torch.Tensor, gt: torch.Tensor,
                              validity: torch.Tensor,
                              threshold: float = 400.0,
                              group=None) -> torch.Tensor:
    """Masked MSE whose squared errors above ``threshold`` are compressed
    to ``diff ** 0.1 * threshold ** 0.9``."""
    diff = (gt - pred) ** 2 * validity
    # pow() gets a safe argument so the untaken branch cannot make a NaN
    # gradient.
    safe = torch.where(diff > threshold, diff, torch.full_like(diff,
                                                               threshold))
    diff = torch.where(diff > threshold, safe ** 0.1 * threshold ** 0.9,
                       diff)
    return diff.sum() / (pred.shape[-1] * _valid_count(validity, group))


def keypoints_mae_loss(pred: torch.Tensor, gt: torch.Tensor,
                       validity: torch.Tensor, group=None) -> torch.Tensor:
    """Masked MAE."""
    loss = ((gt - pred).abs() * validity).sum()
    return loss / (pred.shape[-1] * _valid_count(validity, group))


def keypoints_l2_loss(pred: torch.Tensor, gt: torch.Tensor,
                      validity: torch.Tensor, group=None) -> torch.Tensor:
    """Mean per-joint euclidean distance (the metric 'l2')."""
    sq = ((gt - pred) ** 2 * validity).sum(2)
    return sq.clamp_min(0.0).sqrt().sum() / _valid_count(validity, group)


def volumetric_ce_loss(coord_volumes: torch.Tensor,
                       volumes_pred: torch.Tensor,
                       keypoints_gt: torch.Tensor,
                       validity: torch.Tensor, group=None) -> torch.Tensor:
    """-log p at the voxel nearest each ground-truth joint.

    Args:
      coord_volumes: (B, X, Y, Z, 3) world-mm voxel centres.
      volumes_pred: (B, J, X, Y, Z) probability volumes.
      keypoints_gt: (B, J, 3); validity: (B, J, 1).
    The denominator counts every (sample, joint) pair, valid or not, as in
    ``lt_tpu`` and the reference.
    """
    b, j = volumes_pred.shape[:2]
    coords = coord_volumes.reshape(b, 1, -1, 3)
    dists = ((coords - keypoints_gt[:, :, None, :]) ** 2).sum(-1)
    idx = dists.argmin(-1).detach()                       # (B, J)
    p = volumes_pred.reshape(b, j, -1).gather(-1, idx[..., None])[..., 0]
    ranks = 1 if group is None else world_size(group)
    return (validity[..., 0] * -torch.log(p + 1e-6)).sum() / (b * ranks * j)


CRITERIA = {
    "MSE": keypoints_mse_loss,
    "MSESmooth": keypoints_mse_smooth_loss,
    "MAE": keypoints_mae_loss,
}


def make_criterion(name: str, mse_smooth_threshold: float = 400.0):
    """The keypoint criterion named by ``opt.criterion``."""
    if name == "MSESmooth":
        return lambda p, g, v, group=None: keypoints_mse_smooth_loss(
            p, g, v, mse_smooth_threshold, group)
    return CRITERIA[name]
