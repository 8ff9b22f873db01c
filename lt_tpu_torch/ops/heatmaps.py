"""Soft-argmax over 2D heatmaps and 3D volumes, and Gaussian rendering
(port of ``lt_tpu/ops/heatmaps.py``).

Plain PyTorch: these are reductions, not Pallas kernels, in ``lt_tpu``.
The coordinate expectations are explicit multiply-sums in the inputs'
dtype (a bfloat16 input is widened to float32 first), so float32 stays
full float32 on the card (no TF32).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _widen(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def _normalize(x_flat: torch.Tensor, softmax: bool) -> torch.Tensor:
    return torch.softmax(x_flat, -1) if softmax else torch.relu(x_flat)


def _index(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device)


def integrate_tensor_2d(heatmaps: torch.Tensor, softmax: bool = True):
    """Soft-argmax over (..., H, W) heatmaps: softmax over H * W (or ReLU
    with the mass normalized), per-axis marginals, the expected index.

    Returns (coordinates (..., 2) as (x, y), normalized heatmaps
    (..., H, W)).
    """
    *lead, h, w = heatmaps.shape
    maps = _normalize(_widen(heatmaps).reshape(*lead, h * w),
                      softmax).reshape(*lead, h, w)
    mass_x = maps.sum(-2)                                # (..., W)
    mass_y = maps.sum(-1)                                # (..., H)
    x = (mass_x * _index(w, maps)).sum(-1)
    y = (mass_y * _index(h, maps)).sum(-1)
    if not softmax:
        x = x / mass_x.sum(-1)
        y = y / mass_y.sum(-1)
    return torch.stack([x, y], -1), maps


def integrate_tensor_3d(volumes: torch.Tensor, softmax: bool = True):
    """Soft-argmax over (..., X, Y, Z) volumes in index space.

    Returns (coordinates (..., 3) as (x, y, z) voxel indices, normalized
    volumes).
    """
    *lead, xs, ys, zs = volumes.shape
    vols = _normalize(_widen(volumes).reshape(*lead, xs * ys * zs),
                      softmax).reshape(*lead, xs, ys, zs)
    mass_x = vols.sum((-2, -1))
    mass_y = vols.sum((-3, -1))
    mass_z = vols.sum((-3, -2))
    x = (mass_x * _index(xs, vols)).sum(-1)
    y = (mass_y * _index(ys, vols)).sum(-1)
    z = (mass_z * _index(zs, vols)).sum(-1)
    if not softmax:
        x = x / mass_x.sum(-1)
        y = y / mass_y.sum(-1)
        z = z / mass_z.sum(-1)
    return torch.stack([x, y, z], -1), vols


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
        softmax: bool = True, slabs=None):
    """Channels-last twin: (B, X, Y, Z, J) volumes straight from the NDHWC
    V2V net.  Softmax is normalized after the reductions,
    E[x] = sum(e * x) / sum(e) with e = exp(l - max), as in ``lt_tpu``.  A
    bfloat16 volume is widened to float32 before the maximum, the
    exponential and the sums; keypoints and volumes come back float32.

    ``slabs``: a ``parallel.spatial.SlabGroup`` whose ranks each hold a
    slab of the volume on X (and the coordinates' same rows): the maximum
    is reduced over the group (``all_reduce`` MAX, without a gradient: the
    shift cancels in the quotient), then the exponential sums and the
    weighted coordinate sums (SUM, in the widened type, differentiable:
    the backward sums the cotangents over the group), so that every rank
    returns the whole volume's keypoints and its own slab of the
    normalized volume, in eval and under autograd.

    Returns (keypoints (B, J, 3), normalized volumes (B, J, X, Y, Z)).
    """
    b, xs, ys, zs, j = volumes.shape
    flat = volumes.reshape(b, xs * ys * zs, j)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    cv = coord_volumes.reshape(b, -1, 1, 3)
    if softmax:
        mx = flat.amax(1, keepdim=True)
        if slabs is not None:
            mx = slabs.all_reduce(mx, dist.ReduceOp.MAX)
        e = torch.exp(flat - mx)
        den = e.sum(1)                                   # (B, J)
        num = (e[..., None] * cv).sum(1)                 # (B, J, 3)
        if slabs is not None:
            sums = slabs.all_reduce(torch.cat([num, den[..., None]], -1))
            num, den = sums[..., :3], sums[..., 3]
        coords = num / den[..., None]
        vols = e / den[:, None, :]
    else:
        vols = torch.relu(flat)
        coords = (vols[..., None] * cv).sum(1)
        if slabs is not None:
            coords = slabs.all_reduce(coords)
    vols = vols.reshape(b, xs, ys, zs, j)
    return coords, vols.permute(0, 4, 1, 2, 3)


def gaussian_2d_pdf(coords: torch.Tensor, means: torch.Tensor,
                    sigmas: torch.Tensor, normalize: bool = True
                    ) -> torch.Tensor:
    """Axis-aligned 2D Gaussian density of (..., 2) broadcastable
    coordinates, means and sigmas; normalized by 2 pi sigma_x^2, as
    ``lt_tpu`` and the reference normalize it."""
    z = ((coords[..., 0] - means[..., 0]) ** 2 / sigmas[..., 0] ** 2
         + (coords[..., 1] - means[..., 1]) ** 2 / sigmas[..., 1] ** 2)
    pdf = torch.exp(-z / 2.0)
    if normalize:
        pdf = pdf / (2 * math.pi * sigmas[..., 0] * sigmas[..., 0])
    return pdf


def render_points_as_2d_gaussians(points: torch.Tensor, sigmas: torch.Tensor,
                                  image_shape, normalize: bool = True
                                  ) -> torch.Tensor:
    """Render (..., N, 2) points with (..., N, 2) sigmas as (..., N, H, W)
    Gaussian images."""
    h, w = image_shape
    yy, xx = torch.meshgrid(_index(h, points), _index(w, points),
                            indexing="ij")
    grid = torch.stack([xx, yy], -1)                     # (H, W, 2) as (x, y)
    return gaussian_2d_pdf(grid, points[..., None, None, :],
                           sigmas[..., None, None, :], normalize=normalize)
