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
``csrc/sample_views.cu`` and ``csrc/sample_views_grad.cu``.

In both orientations the forward takes float32 or bfloat16 features and
writes ``out_dtype`` (float32 or bfloat16); the gradient takes a float32 or
bfloat16 cotangent and is float32, computed in float32.  bfloat16 is
widened where it is read and a bfloat16 output is rounded once.

All four work on voxel bricks (``csrc/sample_brick.cuh``: K5 on one
elongated in z, K6-K8 on K1's), each voxel projected once, K8 sharing K6's
pre-reduction; they are launched with the plan of :func:`sample_plan`.

The ``*_plain`` functions are the plain versions.  The plain gradients are
explicit ``index_add_`` scatters, not autograd of the plain sampling, so
that they check K6 and K8 independently of K5 and K7.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.kernels.bricks import AGG_BRICK, AGG_CHUNK, AGG_SMEM_MAX
from lt_tpu_torch.ops.volumetric import index_grid, sample_homogeneous

#: K5's brick of voxels (x, y, z), a voxel a thread: its z-runs of 32 voxels
#: are whole 128-byte rows of its output.  K6, K7 and K8 take K1's
#: AGG_BRICK, whose boxes of taps span the fewest pixels.  Each measured
#: slower on the other brick on an H100 80GB HBM3 at 700 W (PERF.md).
K5_BRICK = (2, 4, 32)
SAMPLE_BRICKS = {"sample_views_t": K5_BRICK, "sample_views_grad_t": AGG_BRICK,
                 "sample_views": AGG_BRICK, "sample_views_grad": AGG_BRICK}
#: The scatters (K6, K8), which pre-reduce a brick's taps in shared memory
#: where its box of taps fits a window budget.
SCATTERS = ("sample_views_grad_t", "sample_views_grad")
#: K6's and K8's default window budget: pixels of a brick's window of one
#: view.  Every (brick, view) of the flagship training geometry fits it
#: (at most 288 pixels, tests/test_torch_sample_plan.py).
K6_WINDOW = 384


def sample_smem_bytes(kernel: str, window: int = 0) -> int:
    """sample_brick.cuh's ``smem_bytes`` of ``kernel`` (a C entry point of
    K5-K8): the scatters' region (window + 1 int counts rounded up to 4 and
    4 sorted taps a voxel, 16-bit), the [channel][voxel] float tile (pitch
    voxels + 1; all but K7), the taps (32 bytes a voxel) and the scatters'
    per-warp boxes."""
    nt = math.prod(AGG_BRICK)
    scatter = kernel in SCATTERS
    region = (window + 4) // 4 * 4 * 4 + 4 * nt * 2 if scatter else 0
    tile = 0 if kernel == "sample_views" else AGG_CHUNK * (nt + 1) * 4
    return region + tile + nt * 32 + ((nt // 32) * 16 if scatter else 0)


class SamplePlan(NamedTuple):
    """One launch of K5-K8: the window budget (pixels; K6 and K8 only, 0:
    direct atomics), dynamic shared memory (bytes), bricks (grid x; grid y
    is the view) and channel chunks (grid z)."""
    window: int
    smem: int
    grid: int
    chunks: int


@functools.lru_cache(maxsize=None)
def sample_plan(kernel: str, channels: int, grid_size: int,
                window: int = 0) -> SamplePlan:
    """The launch plan of ``kernel`` (``sample_views_t``, K5;
    ``sample_views_grad_t``, K6; ``sample_views``, K7;
    ``sample_views_grad``, K8) for C = ``channels`` and an S^3 grid: one
    block per brick (SAMPLE_BRICKS) and chunk of AGG_CHUNK channels;
    ``window`` pixels of the scatters' pre-reduction budget (0: none; the
    samplers stage no window)."""
    if kernel not in SAMPLE_BRICKS:
        raise ValueError(f"sample_plan: no kernel {kernel!r}")
    if window and kernel not in SCATTERS:
        raise ValueError(f"sample_plan: {kernel} takes no window budget")
    smem = sample_smem_bytes(kernel, window)
    if smem > AGG_SMEM_MAX:
        raise ValueError(f"sample_views: a {window}-pixel window does not "
                         f"fit {AGG_SMEM_MAX} bytes of shared memory")
    bricks = math.prod(math.ceil(grid_size / n)
                       for n in SAMPLE_BRICKS[kernel])
    return SamplePlan(window, smem, bricks, math.ceil(channels / AGG_CHUNK))


def _sampler_plan(plan: Optional[SamplePlan], kernel: str, channels: int,
                  grid_size: int) -> SamplePlan:
    """``plan``, or :func:`sample_plan`'s for a sampler (K5, K7); a window
    budget, which a sampler does not take, raises."""
    if plan is None:
        return sample_plan(kernel, channels, grid_size)
    if plan.window:
        raise ValueError(f"{kernel}: a sampler takes no window budget, got "
                         f"{plan}")
    return plan


def _check_affine(affine: torch.Tensor, bv: int) -> None:
    if tuple(affine.shape) != (bv, 3, 4):
        raise ValueError(f"affine {tuple(affine.shape)} != {(bv, 3, 4)}")


def _project(affine: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(BV, 3, 4) -> homogeneous pixels (BV, S^3, 3) of every voxel."""
    grid = index_grid(grid_size, affine.device, affine.dtype).reshape(-1, 4)
    return (affine[:, None, :, :] * grid[None, :, None, :]).sum(-1)


def _widened(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 -> float32 (the kernels widen where they read); other
    types as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype: kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")


def sample_views_t_plain(features: torch.Tensor, affine: torch.Tensor,
                         grid_size: int, out_dtype=torch.float32
                         ) -> torch.Tensor:
    """Plain version of K5: (BV, H, W, C), (BV, 3, 4) -> (BV, C, S^3).
    bfloat16 features are widened to float32; the result is rounded once."""
    uvw = _project(affine, grid_size)
    return sample_homogeneous(_widened(features)[None], uvw[None])[0] \
        .transpose(1, 2).to(out_dtype).contiguous()


def sample_views_t(features: torch.Tensor, affine: torch.Tensor,
                   grid_size: int, plan: Optional[SamplePlan] = None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (BV, H, W, C) feature maps, float32 or bfloat16.
      affine: (BV, 3, 4) float32 composed grid-index -> heatmap-pixel
        matrices.
      plan: the launch plan (window 0); default :func:`sample_plan`'s.
      out_dtype: float32 or bfloat16.
    Returns:
      (BV, C, S^3) samples, voxel n = (gx * S + gy) * S + gz; 0 where
      w <= 0 or a tap falls outside the map.
    """
    bv, h, w, c = features.shape
    _check_affine(affine, bv)
    if not features.is_cuda:
        return sample_views_t_plain(features, affine, grid_size, out_dtype)
    _check_out_dtype(out_dtype)
    _build.check_cuda(features, "features", 4, dtypes=_build.F32_BF16)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    out = torch.empty((bv, c, grid_size ** 3), dtype=out_dtype,
                      device=features.device)
    plan = _sampler_plan(plan, "sample_views_t", c, grid_size)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_t", features.device,
                  [p, p, p, i, i, i, i, i, f, f, i, i, i, i, i],
                  features.data_ptr(), affine.data_ptr(), out.data_ptr(), bv,
                  h, w, c, grid_size, (w - 1) / w, (h - 1) / h,
                  _build.DTYPE_CODES[features.dtype],
                  _build.DTYPE_CODES[out_dtype], *plan[1:])
    return out


def sample_views_grad_t_plain(g: torch.Tensor, affine: torch.Tensor,
                              feat_shape, grid_size: int) -> torch.Tensor:
    """Plain version of K6: g (BV, C, S^3) -> float32 dF (BV, H, W, C) by
    an ``index_add_`` of every voxel's four weighted taps."""
    return _scatter_taps(_widened(g).transpose(1, 2), affine, feat_shape,
                         grid_size)


def _scatter_taps(gt: torch.Tensor, affine: torch.Tensor, feat_shape,
                  grid_size: int) -> torch.Tensor:
    """gt (BV, S^3, C) -> dF (BV, H, W, C): every voxel's gradient row added
    to its four taps with their bilinear weights, a tap off the map at its
    clamped pixel with weight 0 (NaN there where g is not finite, as in
    lt_tpu's autodiff); a voxel behind the camera, whose sample is a
    select's 0, adds nothing."""
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
        terms = torch.where(valid[..., None], gt * wt[..., None], 0.0)
        df.index_add_(0, idx.reshape(-1), terms.reshape(-1, c))
    return df.reshape(bv, h, w, c)


def sample_views_grad_t(g: torch.Tensor, affine: torch.Tensor, feat_shape,
                        grid_size: int, plan: Optional[SamplePlan] = None
                        ) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      g: (BV, C, S^3) cotangent of :func:`sample_views_t`, float32 or
        bfloat16.
      affine: (BV, 3, 4) as there.
      feat_shape: (BV, H, W, C) of the sampled features.
      plan: the launch plan; default :func:`sample_plan`'s with K6_WINDOW
        (window 0: every brick adds its taps to dF directly).
    Returns:
      dF (BV, H, W, C) float32.
    """
    bv, h, w, c = feat_shape
    _check_affine(affine, bv)
    if tuple(g.shape) != (bv, c, grid_size ** 3):
        raise ValueError(f"g {tuple(g.shape)} != {(bv, c, grid_size ** 3)}")
    if not g.is_cuda:
        return sample_views_grad_t_plain(g, affine, feat_shape, grid_size)
    _build.check_cuda(g, "g", 3, dtypes=_build.F32_BF16)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    df = torch.zeros((bv, h, w, c), dtype=torch.float32, device=g.device)
    plan = plan or sample_plan("sample_views_grad_t", c, grid_size,
                               K6_WINDOW)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_grad_t", g.device,
                  [p, p, p, i, i, i, i, i, f, f, i] + [i] * len(plan),
                  g.data_ptr(), affine.data_ptr(), df.data_ptr(), bv, h, w, c,
                  grid_size, (w - 1) / w, (h - 1) / h,
                  _build.DTYPE_CODES[g.dtype], *plan)
    return df


class _SampleViewsAffineT(torch.autograd.Function):
    """Forward K5, backward K6; ``affine`` gets no gradient."""

    @staticmethod
    def forward(ctx, features, affine, grid_size, out_dtype):
        ctx.save_for_backward(affine)
        ctx.feat_shape = tuple(features.shape)
        ctx.feat_dtype = features.dtype
        ctx.grid_size = grid_size
        return sample_views_t(features, affine, grid_size,
                              out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        (affine,) = ctx.saved_tensors
        df = sample_views_grad_t(g.contiguous(), affine, ctx.feat_shape,
                                 ctx.grid_size)
        return df.to(ctx.feat_dtype), None, None, None


def sample_views_affine_t(features: torch.Tensor, affine: torch.Tensor,
                          grid_size: int, out_dtype=torch.float32
                          ) -> torch.Tensor:
    """Differentiable :func:`sample_views_t`: (BV, H, W, C) -> (BV, C, S^3)
    in ``out_dtype``, gradients to ``features`` only (cameras and grids are
    inputs), computed in float32 and cast to the features' type, as
    ``lt_tpu``'s ``_sample_views_bwd_t`` (``unproject.py:1061-1067``)."""
    return _SampleViewsAffineT.apply(features, affine, grid_size, out_dtype)


# ---------------------------------------------------------------------------
# The voxels-major orientation: K7 / K8
# ---------------------------------------------------------------------------


def sample_views_plain(features: torch.Tensor, affine: torch.Tensor,
                       grid_size: int, out_dtype=torch.float32
                       ) -> torch.Tensor:
    """Plain version of K7: (BV, H, W, C), (BV, 3, 4) -> (BV, S^3, C).
    bfloat16 features are widened to float32; the result is rounded once."""
    uvw = _project(affine, grid_size)
    return sample_homogeneous(_widened(features)[None], uvw[None])[0].to(
        out_dtype)


def sample_views(features: torch.Tensor, affine: torch.Tensor,
                 grid_size: int, out_dtype=torch.float32,
                 plan: Optional[SamplePlan] = None) -> torch.Tensor:
    """K7 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (BV, H, W, C) feature maps, float32 or bfloat16.
      affine: (BV, 3, 4) float32 composed grid-index -> heatmap-pixel
        matrices.
      out_dtype: float32 or bfloat16.
      plan: the launch plan (window 0); default :func:`sample_plan`'s.
    Returns:
      (BV, S^3, C) samples, voxel n = (gx * S + gy) * S + gz; 0 where
      w <= 0 or a tap falls outside the map.
    """
    bv, h, w, c = features.shape
    _check_affine(affine, bv)
    if not features.is_cuda:
        return sample_views_plain(features, affine, grid_size, out_dtype)
    _check_out_dtype(out_dtype)
    _build.check_cuda(features, "features", 4, dtypes=_build.F32_BF16)
    affine = affine.contiguous()
    _build.check_cuda(affine, "affine", 3)
    out = torch.empty((bv, grid_size ** 3, c), dtype=out_dtype,
                      device=features.device)
    plan = _sampler_plan(plan, "sample_views", c, grid_size)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views", features.device,
                  [p, p, p, i, i, i, i, i, f, f, i, i, i, i, i],
                  features.data_ptr(), affine.data_ptr(), out.data_ptr(), bv,
                  h, w, c, grid_size, (w - 1) / w, (h - 1) / h,
                  _build.DTYPE_CODES[features.dtype],
                  _build.DTYPE_CODES[out_dtype], *plan[1:])
    return out


def sample_views_grad_plain(g: torch.Tensor, affine: torch.Tensor,
                            feat_shape, grid_size: int) -> torch.Tensor:
    """Plain version of K8: g (BV, S^3, C) -> float32 dF (BV, H, W, C) by an
    ``index_add_`` of every voxel's four weighted taps."""
    return _scatter_taps(_widened(g), affine, feat_shape, grid_size)


def sample_views_grad(g: torch.Tensor, affine: torch.Tensor, feat_shape,
                      grid_size: int, plan: Optional[SamplePlan] = None
                      ) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      g: (BV, S^3, C) cotangent of :func:`sample_views`, float32 or
        bfloat16.
      affine: (BV, 3, 4) as there.
      feat_shape: (BV, H, W, C) of the sampled features.
      plan: the launch plan, K6's; default :func:`sample_plan`'s with
        K6_WINDOW (window 0: every brick adds its taps to dF directly).
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
    plan = plan or sample_plan("sample_views_grad", c, grid_size, K6_WINDOW)
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("sample_views_grad", g.device,
                  [p, p, p, i, i, i, i, i, f, f, i] + [i] * len(plan),
                  g.data_ptr(), affine.data_ptr(), df.data_ptr(), bv, h, w, c,
                  grid_size, (w - 1) / w, (h - 1) / h,
                  _build.DTYPE_CODES[g.dtype], *plan)
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
