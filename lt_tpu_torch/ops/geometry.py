"""Homogeneous helpers and projection.

Port of ``lt_tpu/ops/geometry.py:114-140``.
"""

from __future__ import annotations

import torch


def euclidean_to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., M) -> (..., M + 1) by appending ones."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([points, ones], dim=-1)


def homogeneous_to_euclidean(points: torch.Tensor) -> torch.Tensor:
    """(..., M + 1) -> (..., M) by dividing by the last coordinate."""
    return points[..., :-1] / points[..., -1:]


def project_points(proj_matrix: torch.Tensor, points_3d: torch.Tensor,
                   convert_back_to_euclidean: bool = True) -> torch.Tensor:
    """Project (..., N, 3) world points through (..., 3, 4) matrices.

    Leading dims broadcast.  The contraction is an explicit multiply-sum so
    it stays in full float32 on every device (no TF32).
    """
    homo = euclidean_to_homogeneous(points_3d)
    result = (homo[..., :, None, :] * proj_matrix[..., None, :, :]).sum(-1)
    if convert_back_to_euclidean:
        result = homogeneous_to_euclidean(result)
    return result
