"""Coordinate volumes, rotations and the plain projective unprojection.

Port of ``lt_tpu/ops/volumetric.py:48-298``.  ``unproject_heatmaps`` is the
plain PyTorch path (the reference's semantics, op.py:99-166 of the original
code); the fused CUDA kernel behind
:func:`lt_tpu_torch.ops.kernels.unproject.unproject_heatmaps_affine`
computes the same volumes from the affine form of the coordinate volume.
"""

from __future__ import annotations

from typing import Optional

import torch

from lt_tpu_torch.ops.geometry import project_points


def rotation_matrix(axis, theta: torch.Tensor) -> torch.Tensor:
    """Rotation about ``axis`` by ``theta`` radians (Euler-Rodrigues form).

    Same sign convention as ``lt_tpu.ops.volumetric.rotation_matrix``.
    ``theta`` (...,) broadcasts; returns (..., 3, 3) in its floating dtype.
    """
    theta = torch.as_tensor(theta)
    if not theta.is_floating_point():
        theta = theta.float()
    axis = torch.as_tensor(axis, dtype=theta.dtype, device=theta.device)
    axis = axis / torch.sqrt((axis * axis).sum(-1, keepdim=True))
    a = torch.cos(theta / 2.0)
    sin_half = torch.sin(theta / 2.0)
    b = -axis[..., 0] * sin_half
    c = -axis[..., 1] * sin_half
    d = -axis[..., 2] * sin_half
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    rows = [
        torch.stack([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)], -1),
        torch.stack([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)], -1),
        torch.stack([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc], -1),
    ]
    return torch.stack(rows, dim=-2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., I, J) x (..., J) -> (..., I) as a multiply-sum (full f32)."""
    return (m * v[..., None, :]).sum(-1)


def coord_volume_affine(base_points: torch.Tensor, cuboid_side: float,
                        volume_size: int,
                        thetas: Optional[torch.Tensor] = None,
                        axis=(0.0, 0.0, 1.0),
                        transfer_cmu_to_human36m: bool = False
                        ) -> torch.Tensor:
    """The (B, 3, 4) affine mapping integer grid indices -> world mm, in
    the dtype of ``base_points``."""
    b = base_points.shape[0]
    dev, dt = base_points.device, base_points.dtype
    s = volume_size
    spacing = cuboid_side / (s - 1)
    half = cuboid_side / 2.0

    if thetas is not None:
        rot = rotation_matrix(axis, thetas.to(dev, dt))
    else:
        rot = torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3)

    lin = rot * spacing
    offset = _matvec(rot, torch.full((b, 3), -half, dtype=dt, device=dev)) + base_points

    if transfer_cmu_to_human36m:
        perm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                             [0.0, 0.0, 1.0]], dtype=dt, device=dev)
        shift = torch.tensor([float(s - 1), 0.0, 0.0], dtype=dt, device=dev)
        offset = offset + _matvec(lin, shift.expand(b, 3))
        lin = (lin[..., :, :, None] * perm[None, None, :, :]).sum(-2)

    return torch.cat([lin, offset[..., None]], dim=-1)


def index_grid(s: int, device, dtype=torch.float32) -> torch.Tensor:
    """(S, S, S, 4) homogeneous voxel indices (gx, gy, gz, 1); flattened,
    voxel n = (gx * S + gy) * S + gz."""
    g = torch.arange(s, dtype=dtype, device=device)
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([gx, gy, gz, torch.ones_like(gx)], -1)


def build_coord_volumes(base_points: torch.Tensor, cuboid_side: float,
                        volume_size: int,
                        thetas: Optional[torch.Tensor] = None,
                        axis=(0.0, 0.0, 1.0),
                        transfer_cmu_to_human36m: bool = False
                        ) -> torch.Tensor:
    """(B, S, S, S, 3) pelvis-centred world-mm voxel centres."""
    s = volume_size
    affine = coord_volume_affine(base_points, cuboid_side, volume_size,
                                 thetas, axis, transfer_cmu_to_human36m)
    grid = index_grid(s, affine.device, affine.dtype)
    return (affine[:, None, None, None, :, :]
            * grid[None, :, :, :, None, :]).sum(-1)


def bilinear_sample_2d(images: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (..., H, W, C) at pixel coords (..., N).

    ``F.grid_sample(align_corners=True, padding_mode='zeros')`` semantics
    once coordinates are in pixels: out-of-bounds taps contribute zero.
    Returns (..., N, C).
    """
    h, w, c = images.shape[-3:]
    lead = images.shape[:-3]
    imgs = images.reshape(lead + (h * w, c))

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx = x - x0
    wy = y - y0

    def tap(xi, yi, weight):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        idx = (yc * w + xc)[..., None].expand(*xc.shape, c)
        vals = torch.gather(imgs, -2, idx)
        return vals * (weight * valid.to(weight.dtype))[..., None]

    return (tap(x0, y0, (1 - wx) * (1 - wy)) + tap(x1, y0, wx * (1 - wy))
            + tap(x0, y1, (1 - wx) * wy) + tap(x1, y1, wx * wy))


def unproject_heatmaps(heatmaps: torch.Tensor, proj_matrices: torch.Tensor,
                       coord_volumes: torch.Tensor,
                       volume_aggregation_method: str = "sum",
                       vol_confidences: Optional[torch.Tensor] = None,
                       view_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Lift (B, V, H, W, C) feature maps into (B, C, X, Y, Z) volumes.

    Projects every voxel centre through each view's 3x4 matrix, masks
    non-positive depth, samples bilinearly and aggregates across views
    ('sum' | 'max' | 'softmax' | 'conf' | 'conf_norm'); ``view_mask`` (B, V)
    removes views from the aggregation.
    """
    b, c = heatmaps.shape[0], heatmaps.shape[-1]
    xs, ys, zs = coord_volumes.shape[1:4]
    n = xs * ys * zs

    grid = coord_volumes.reshape(b, 1, n, 3)
    uvw = project_points(proj_matrices, grid,
                         convert_back_to_euclidean=False)   # (B, V, N, 3)
    volume = aggregate_views(sample_homogeneous(heatmaps, uvw),
                             volume_aggregation_method, vol_confidences,
                             view_mask)
    return volume.transpose(1, 2).reshape(b, c, xs, ys, zs)


def sample_homogeneous(heatmaps: torch.Tensor, uvw: torch.Tensor
                       ) -> torch.Tensor:
    """Sample (B, V, H, W, C) maps at homogeneous pixel coords (B, V, N, 3).

    Depth w <= 0 gives 0 (only an exact 0 is replaced by 1 before the
    divide); x is normalized by the width and y by the height with
    align_corners=True.  Returns (B, V, N, C).
    """
    h, w = heatmaps.shape[2:4]
    z = uvw[..., 2]
    invalid = z <= 0.0
    z_safe = torch.where(z == 0.0, torch.ones_like(z), z)
    x_pix = uvw[..., 0] / z_safe * ((w - 1) / w)
    y_pix = uvw[..., 1] / z_safe * ((h - 1) / h)
    sampled = bilinear_sample_2d(heatmaps, x_pix, y_pix)
    return torch.where(invalid[..., None], torch.zeros_like(sampled), sampled)


def aggregate_views(sampled: torch.Tensor, method: str,
                    vol_confidences: Optional[torch.Tensor] = None,
                    view_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Aggregate (B, V, N, C) per-view samples over views -> (B, N, C).

    'softmax' weighs with a softmax over views whose masked logits are
    -1e9; 'max' maps an all-masked -inf to 0; 'conf*' weighs by (B, V, C)
    confidences.

    bfloat16 samples (the unfused training path under ``bf16: true``) keep
    ``lt_tpu``'s type at each step (``lt_tpu/ops/pallas/unproject.py:
    791-825``): 'conf*' multiplies by the float32 confidences and sums in
    float32; 'sum', 'max' and 'softmax' stay bfloat16 (masked logits -1e9
    rounded to bfloat16, as ``jnp.where`` rounds it).  Where the port
    widens: PyTorch's bfloat16 ``sum`` and ``softmax`` accumulate in
    float32 and round their result once.
    """
    mask = (None if view_mask is None
            else view_mask.to(torch.bool)[:, :, None, None])
    zero = torch.zeros((), dtype=sampled.dtype, device=sampled.device)
    if method.startswith("conf"):
        conf = vol_confidences[:, :, None, :]
        if mask is not None:
            conf = torch.where(mask, conf, zero)
        return (sampled * conf).sum(1)
    if method == "sum":
        if mask is not None:
            sampled = torch.where(mask, sampled, zero)
        return sampled.sum(1)
    if method == "max":
        if mask is not None:
            sampled = torch.where(mask, sampled, zero - float("inf"))
        volume = sampled.amax(1)
        if mask is not None:
            volume = torch.where(torch.isneginf(volume), zero, volume)
        return volume
    if method == "softmax":
        logits = sampled
        if mask is not None:
            logits = torch.where(mask, logits, zero - 1e9)
        weights = torch.softmax(logits, dim=1)
        contrib = (torch.where(mask, sampled, zero) if mask is not None
                   else sampled)
        return (contrib * weights).sum(1)
    raise ValueError(f"Unknown volume_aggregation_method: {method}")
