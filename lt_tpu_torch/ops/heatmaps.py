"""Volumetric soft-argmax (port of ``lt_tpu/ops/heatmaps.py:90-149``).

Plain PyTorch: these are reductions, not Pallas kernels, in ``lt_tpu``.
The coordinate expectations are explicit multiply-sums in the inputs'
dtype, so float32 stays full float32 on the card (no TF32).
"""

from __future__ import annotations

import torch


def _normalize(x_flat: torch.Tensor, softmax: bool) -> torch.Tensor:
    return torch.softmax(x_flat, -1) if softmax else torch.relu(x_flat)


def integrate_tensor_3d_with_coordinates(volumes: torch.Tensor,
                                         coord_volumes: torch.Tensor,
                                         softmax: bool = True):
    """(B, J, X, Y, Z) volumes, (B, X, Y, Z, 3) coords -> keypoints (B, J, 3)
    in world mm and the normalized volumes (B, J, X, Y, Z)."""
    b, j, xs, ys, zs = volumes.shape
    vols = _normalize(volumes.reshape(b, j, -1), softmax)
    cv = coord_volumes.reshape(b, 1, -1, 3)
    coords = (vols[..., None] * cv).sum(2)
    return coords, vols.reshape(b, j, xs, ys, zs)


def integrate_tensor_3d_with_coordinates_channels_last(
        volumes: torch.Tensor, coord_volumes: torch.Tensor,
        softmax: bool = True):
    """Channels-last twin: (B, X, Y, Z, J) volumes straight from the NDHWC
    V2V net.  Softmax is normalized after the reductions,
    E[x] = sum(e * x) / sum(e) with e = exp(l - max), as in ``lt_tpu``.  A
    bfloat16 volume is widened to float32 before the maximum, the
    exponential and the sums; keypoints and volumes come back float32.

    Returns (keypoints (B, J, 3), normalized volumes (B, J, X, Y, Z)).
    """
    b, xs, ys, zs, j = volumes.shape
    flat = volumes.reshape(b, xs * ys * zs, j)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    cv = coord_volumes.reshape(b, -1, 1, 3)
    if softmax:
        e = torch.exp(flat - flat.amax(1, keepdim=True))
        den = e.sum(1)                                   # (B, J)
        coords = (e[..., None] * cv).sum(1) / den[..., None]
        vols = e / den[:, None, :]
    else:
        vols = torch.relu(flat)
        coords = (vols[..., None] * cv).sum(1)
    vols = vols.reshape(b, xs, ys, zs, j)
    return coords, vols.permute(0, 4, 1, 2, 3)
