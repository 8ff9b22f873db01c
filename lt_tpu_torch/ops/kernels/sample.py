"""Per-view sampling of an affine voxel grid and its feature gradient, in
both output orientations.

Channels-major, (BV, C, S^3): kernels K5 and K6, the training path.  Port
of ``lt_tpu/ops/pallas/unproject.py:612-658`` (``_sample_views_fwd_impl_t``),
``:993-1037`` (``_sample_views_grad_features_t``) and ``:1040-1070``
(``sample_views_affine_t``); CUDA kernels ``csrc/sample_views_t.cu`` and
``csrc/sample_views_grad_t.cu``.

Voxels-major, (BV, S^3, C): kernels K7 and K8.  Port of ``:507-586``
(``_sample_views_fwd_impl``), ``:896-918`` (``_sample_views_grad_features``)
and ``:1073-1108`` (``sample_views_affine``); CUDA kernels
``csrc/sample_views.cu`` and ``csrc/sample_views_grad.cu``.  The forward
takes float32 or bfloat16 features and writes ``out_dtype``; the gradient
is float32, computed in float32.

The ``*_plain`` functions are the plain versions.  The plain gradients are
explicit ``index_add_`` scatters, not autograd of the plain sampling, so
that they check K6 and K8 independently of K5 and K7.
"""

from __future__ import annotations

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.volumetric import index_grid, sample_homogeneous


def _check_affine(affine: torch.Tensor, bv: int) -> None:
    if tuple(affine.shape) != (bv, 3, 4):
        raise ValueError(f"affine {tuple(affine.shape)} != {(bv, 3, 4)}")


def _project(affine: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(BV, 3, 4) -> homogeneous pixels (BV, S^3, 3) of every voxel."""
    grid = index_grid(grid_size, affine.device, affine.dtype).reshape(-1, 4)
    return (affine[:, None, :, :] * grid[None, :, None, :]).sum(-1)


def sample_views_t_plain(features: torch.Tensor, affine: torch.Tensor,
                         grid_size: int) -> torch.Tensor:
    """Plain version of K5: (BV, H, W, C), (BV, 3, 4) -> (BV, C, S^3)."""
    uvw = _project(affine, grid_size)
    return sample_homogeneous(features[None], uvw[None])[0].transpose(
        1, 2).contiguous()


def sample_views_t(features: torch.Tensor, affine: torch.Tensor,
                   grid_size: int) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (BV, H, W, C) float32 feature maps.
      affine: (BV, 3, 4) composed grid-index -> heatmap-pixel matrices.
    Returns:
      (BV, C, S^3) samples, voxel n = (gx * S + gy) * S + gz; 0 where
      w <= 0 or a tap falls outside the map.
    """
    bv, h, w, c = features.shape
    _check_affine(affine, bv)
    if not features.is_cuda:
        return sample_views_t_plain(features, affine, grid_size)
    _build.check_cuda(features, "features", 4)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    out = torch.empty((bv, c, grid_size ** 3), dtype=torch.float32,
                      device=features.device)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_t", features.device,
                  [p, p, p, i, i, i, i, i, f, f], features.data_ptr(),
                  affine.data_ptr(), out.data_ptr(), bv, h, w, c, grid_size,
                  (w - 1) / w, (h - 1) / h)
    return out


def sample_views_grad_t_plain(g: torch.Tensor, affine: torch.Tensor,
                              feat_shape, grid_size: int) -> torch.Tensor:
    """Plain version of K6: g (BV, C, S^3) -> dF (BV, H, W, C) by an
    ``index_add_`` of every voxel's four weighted taps."""
    return _scatter_taps(g.transpose(1, 2), affine, feat_shape, grid_size)


def _scatter_taps(gt: torch.Tensor, affine: torch.Tensor, feat_shape,
                  grid_size: int) -> torch.Tensor:
    """gt (BV, S^3, C) -> dF (BV, H, W, C): every voxel's gradient row added
    to its four taps with their bilinear weights."""
    bv, h, w, c = feat_shape
    uvw = _project(affine, grid_size)                      # (BV, N, 3)
    z = uvw[..., 2]
    valid = z > 0.0
    z_safe = torch.where(z == 0.0, torch.ones_like(z), z)
    x = uvw[..., 0] / z_safe * ((w - 1) / w)
    y = uvw[..., 1] / z_safe * ((h - 1) / h)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    base = torch.arange(bv, device=gt.device)[:, None] * (h * w)
    df = torch.zeros((bv * h * w, c), dtype=gt.dtype, device=gt.device)
    for xi, yi, wt in ((x0, y0, (1 - wx) * (1 - wy)),
                       (x0 + 1, y0, wx * (1 - wy)),
                       (x0, y0 + 1, (1 - wx) * wy),
                       (x0 + 1, y0 + 1, wx * wy)):
        keep = valid & (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        wt = torch.where(keep, wt, torch.zeros_like(wt))
        idx = base + (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        df.index_add_(0, idx.reshape(-1), (gt * wt[..., None]).reshape(-1, c))
    return df.reshape(bv, h, w, c)


def sample_views_grad_t(g: torch.Tensor, affine: torch.Tensor, feat_shape,
                        grid_size: int) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      g: (BV, C, S^3) float32 cotangent of :func:`sample_views_t`.
      affine: (BV, 3, 4) as there.
      feat_shape: (BV, H, W, C) of the sampled features.
    Returns:
      dF (BV, H, W, C) float32.
    """
    bv, h, w, c = feat_shape
    _check_affine(affine, bv)
    if tuple(g.shape) != (bv, c, grid_size ** 3):
        raise ValueError(f"g {tuple(g.shape)} != {(bv, c, grid_size ** 3)}")
    if not g.is_cuda:
        return sample_views_grad_t_plain(g, affine, feat_shape, grid_size)
    _build.check_cuda(g, "g", 3)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    df = torch.zeros((bv, h, w, c), dtype=torch.float32, device=g.device)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_grad_t", g.device,
                  [p, p, p, i, i, i, i, i, f, f], g.data_ptr(),
                  affine.data_ptr(), df.data_ptr(), bv, h, w, c, grid_size,
                  (w - 1) / w, (h - 1) / h)
    return df


class _SampleViewsAffineT(torch.autograd.Function):
    """Forward K5, backward K6; ``affine`` gets no gradient."""

    @staticmethod
    def forward(ctx, features, affine, grid_size):
        ctx.save_for_backward(affine)
        ctx.feat_shape = tuple(features.shape)
        ctx.grid_size = grid_size
        return sample_views_t(features, affine, grid_size)

    @staticmethod
    def backward(ctx, g):
        (affine,) = ctx.saved_tensors
        df = sample_views_grad_t(g.contiguous(), affine, ctx.feat_shape,
                                 ctx.grid_size)
        return df, None, None


def sample_views_affine_t(features: torch.Tensor, affine: torch.Tensor,
                          grid_size: int) -> torch.Tensor:
    """Differentiable :func:`sample_views_t`: (BV, H, W, C) -> (BV, C, S^3),
    gradients to ``features`` only (cameras and grids are inputs)."""
    return _SampleViewsAffineT.apply(features, affine, grid_size)


# ---------------------------------------------------------------------------
# The voxels-major orientation: K7 / K8
# ---------------------------------------------------------------------------


def sample_views_plain(features: torch.Tensor, affine: torch.Tensor,
                       grid_size: int, out_dtype=torch.float32
                       ) -> torch.Tensor:
    """Plain version of K7: (BV, H, W, C), (BV, 3, 4) -> (BV, S^3, C).
    bfloat16 features are widened to float32; the result is rounded once."""
    uvw = _project(affine, grid_size)
    f = features.float() if features.dtype == torch.bfloat16 else features
    return sample_homogeneous(f[None], uvw[None])[0].to(out_dtype)


def sample_views(features: torch.Tensor, affine: torch.Tensor,
                 grid_size: int, out_dtype=torch.float32) -> torch.Tensor:
    """K7 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (BV, H, W, C) feature maps, float32 or bfloat16.
      affine: (BV, 3, 4) float32 composed grid-index -> heatmap-pixel
        matrices.
      out_dtype: float32 or bfloat16.
    Returns:
      (BV, S^3, C) samples, voxel n = (gx * S + gy) * S + gz; 0 where
      w <= 0 or a tap falls outside the map.
    """
    bv, h, w, c = features.shape
    _check_affine(affine, bv)
    if not features.is_cuda:
        return sample_views_plain(features, affine, grid_size, out_dtype)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype: kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    _build.check_cuda(features, "features", 4, dtypes=_build.F32_BF16)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    out = torch.empty((bv, grid_size ** 3, c), dtype=out_dtype,
                      device=features.device)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views", features.device,
                  [p, p, p, i, i, i, i, i, f, f, i, i], features.data_ptr(),
                  affine.data_ptr(), out.data_ptr(), bv, h, w, c, grid_size,
                  (w - 1) / w, (h - 1) / h,
                  _build.DTYPE_CODES[features.dtype],
                  _build.DTYPE_CODES[out_dtype])
    return out


def sample_views_grad_plain(g: torch.Tensor, affine: torch.Tensor,
                            feat_shape, grid_size: int) -> torch.Tensor:
    """Plain version of K8: g (BV, S^3, C) -> float32 dF (BV, H, W, C) by an
    ``index_add_`` of every voxel's four weighted taps."""
    return _scatter_taps(g.float() if g.dtype == torch.bfloat16 else g,
                         affine, feat_shape, grid_size)


def sample_views_grad(g: torch.Tensor, affine: torch.Tensor, feat_shape,
                      grid_size: int) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      g: (BV, S^3, C) cotangent of :func:`sample_views`, float32 or
        bfloat16.
      affine: (BV, 3, 4) as there.
      feat_shape: (BV, H, W, C) of the sampled features.
    Returns:
      dF (BV, H, W, C) float32.
    """
    bv, h, w, c = feat_shape
    _check_affine(affine, bv)
    if tuple(g.shape) != (bv, grid_size ** 3, c):
        raise ValueError(f"g {tuple(g.shape)} != {(bv, grid_size ** 3, c)}")
    if not g.is_cuda:
        return sample_views_grad_plain(g, affine, feat_shape, grid_size)
    _build.check_cuda(g, "g", 3, dtypes=_build.F32_BF16)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    df = torch.zeros((bv, h, w, c), dtype=torch.float32, device=g.device)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_grad", g.device,
                  [p, p, p, i, i, i, i, i, f, f, i], g.data_ptr(),
                  affine.data_ptr(), df.data_ptr(), bv, h, w, c, grid_size,
                  (w - 1) / w, (h - 1) / h, _build.DTYPE_CODES[g.dtype])
    return df


class _SampleViewsAffine(torch.autograd.Function):
    """Forward K7, backward K8; ``affine`` gets no gradient."""

    @staticmethod
    def forward(ctx, features, affine, grid_size, out_dtype):
        ctx.save_for_backward(affine)
        ctx.feat_shape = tuple(features.shape)
        ctx.feat_dtype = features.dtype
        ctx.grid_size = grid_size
        return sample_views(features, affine, grid_size, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (affine,) = ctx.saved_tensors
        df = sample_views_grad(g.contiguous(), affine, ctx.feat_shape,
                               ctx.grid_size)
        return df.to(ctx.feat_dtype), None, None, None


def sample_views_affine(features: torch.Tensor, affine: torch.Tensor,
                        grid_size: int, out_dtype=torch.float32
                        ) -> torch.Tensor:
    """Differentiable :func:`sample_views`: (BV, H, W, C) -> (BV, S^3, C) in
    ``out_dtype``, gradients to ``features`` only (cameras and grids are
    inputs), computed in float32 and cast to the features' type."""
    return _SampleViewsAffine.apply(features, affine, grid_size, out_dtype)
