"""Fused unprojection with cross-view aggregation (kernel K1).

Port of ``lt_tpu/ops/pallas/unproject.py:360-435, 710-775``
(``_sample_views_agg_impl`` and ``unproject_heatmaps_affine`` with
``fuse_aggregation=True``).  The CUDA kernel is ``csrc/unproject_agg.cu``;
:func:`unproject_agg_plain` is its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.volumetric import (aggregate_views, index_grid,
                                        sample_homogeneous)

METHODS = {"softmax": 0, "sum": 1, "max": 2, "conf": 3, "conf_norm": 3}


def compose_grid_projection(proj_matrices: torch.Tensor,
                            grid_affine: torch.Tensor) -> torch.Tensor:
    """m = P @ [A; 0 0 0 1]: (B, V, 3, 4) grid-index -> homogeneous pixel,
    as an explicit float32 multiply-sum."""
    b = grid_affine.shape[0]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                          device=grid_affine.device).expand(b, 1, 4)
    affine4 = torch.cat([grid_affine.float(), bottom], dim=1)  # (B, 4, 4)
    return (proj_matrices.float()[..., :, :, None]
            * affine4[:, None, None, :, :]).sum(-2)


def unproject_agg_plain(features: torch.Tensor, m: torch.Tensor,
                        view_mask: torch.Tensor,
                        vol_confidences: Optional[torch.Tensor],
                        method: str, grid_size: int) -> torch.Tensor:
    """Plain version of K1: (B, V, H, W, C), m (B, V, 3, 4) -> (B, S^3, C)."""
    grid = index_grid(grid_size, features.device).reshape(-1, 4)
    uvw = (m[:, :, None, :, :] * grid[None, None, :, None, :]).sum(-1)
    return aggregate_views(sample_homogeneous(features, uvw), method,
                           vol_confidences, view_mask)


def unproject_agg(features: torch.Tensor, m: torch.Tensor,
                  view_mask: torch.Tensor,
                  vol_confidences: Optional[torch.Tensor],
                  method: str, grid_size: int) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (B, V, H, W, C) float32.
      m: (B, V, 3, 4) composed grid-index -> pixel matrices.
      view_mask: (B, V); views with mask <= 0 are left out.
      vol_confidences: (B, V, C) for 'conf' / 'conf_norm', else None.
    Returns:
      (B, S^3, C) with voxel n = (gx * S + gy) * S + gz.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown volume_aggregation_method: {method}")
    if method.startswith("conf") and vol_confidences is None:
        raise ValueError(f"{method!r} aggregation needs vol_confidences")
    if not features.is_cuda:
        return unproject_agg_plain(features, m, view_mask, vol_confidences,
                                   method, grid_size)
    b, v, h, w, c = features.shape
    _build.check_cuda(features, "features", 5)
    m = m.contiguous()
    _build.check_cuda(m, "m", 4)
    view_mask = view_mask.to(torch.float32).contiguous()
    _build.check_cuda(view_mask, "view_mask", 2)
    if tuple(m.shape) != (b, v, 3, 4) or tuple(view_mask.shape) != (b, v):
        raise ValueError(f"shape mismatch: m {tuple(m.shape)}, view_mask "
                         f"{tuple(view_mask.shape)}, features {(b, v)}")
    conf_ptr = None
    if method.startswith("conf"):
        vol_confidences = vol_confidences.contiguous()
        _build.check_cuda(vol_confidences, "vol_confidences", 3)
        if tuple(vol_confidences.shape) != (b, v, c):
            raise ValueError(f"vol_confidences {tuple(vol_confidences.shape)}"
                             f" != {(b, v, c)}")
        conf_ptr = vol_confidences.data_ptr()
    out = torch.empty((b, grid_size ** 3, c), dtype=torch.float32,
                      device=features.device)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch(
        "unproject_agg", "unproject_agg", features.device,
        [p, p, p, p, p, i, i, i, i, i, i, i, f, f],
        features.data_ptr(), m.data_ptr(), view_mask.data_ptr(), conf_ptr,
        out.data_ptr(), b, v, h, w, c, grid_size, METHODS[method],
        (w - 1) / w, (h - 1) / h)
    return out


def unproject_heatmaps_affine(features: torch.Tensor,
                              proj_matrices: torch.Tensor,
                              grid_affine: torch.Tensor, grid_size: int,
                              volume_aggregation_method: str = "softmax",
                              vol_confidences: Optional[torch.Tensor] = None,
                              view_mask: Optional[torch.Tensor] = None,
                              channels_last: bool = False) -> torch.Tensor:
    """Fused-unprojection equivalent of ``volumetric.unproject_heatmaps``:
    ``lt_tpu``'s ``unproject_heatmaps_affine(..., fuse_aggregation=True)``
    (the per-view, unfused variant serves training, not ported yet).

    Args:
      features: (B, V, H, W, C); proj_matrices: (B, V, 3, 4) in heatmap
        pixels; grid_affine: (B, 3, 4) grid index -> world mm
        (``volumetric.coord_volume_affine``).
      channels_last: return (B, S, S, S, C) -- the kernel's own voxel
        order -- instead of (B, C, S, S, S).
    """
    b, v = features.shape[:2]
    c = features.shape[-1]
    m = compose_grid_projection(proj_matrices, grid_affine)
    if view_mask is None:
        view_mask = torch.ones((b, v), dtype=torch.float32,
                               device=features.device)
    volume = unproject_agg(features, m, view_mask, vol_confidences,
                           volume_aggregation_method, grid_size)
    s = grid_size
    if channels_last:
        return volume.reshape(b, s, s, s, c)
    return volume.transpose(1, 2).reshape(b, c, s, s, s)
