"""Fused unprojection with cross-view aggregation (kernel K1) and its
training backward.

Port of ``lt_tpu/ops/pallas/unproject.py:360-504, 710-829``
(``_sample_views_agg_impl``, ``sample_views_agg`` and
``unproject_heatmaps_affine``).  The CUDA kernel is ``csrc/unproject_agg.cu``,
launched with the plan of :func:`unproject_plan`;
:func:`unproject_agg_plain` is its plain PyTorch version and
:func:`brick_windows` computes the feature windows it stages.  As
``lt_tpu``'s sampler, the kernel reads a tap off the map at its pixel
clamped to the map, with weight 0.  The backward of
:func:`sample_views_agg` runs kernels K5 and K6 (``sample.py``).

K1 and its plain version also fill a slab of the grid, ``slab = (x0,
sx)``: the X planes [x0, x0 + sx) of the S^3 grid, (B, sx * S^2, C), each
voxel computed as in the whole grid (``parallel/spatial.py``'s volume-axis
sharding); in training the backward runs K5 and K6 on the same slab.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.kernels.bricks import AGG_BRICK, AGG_CHUNK, AGG_SMEM_MAX
from lt_tpu_torch.ops.kernels.sample import (_project, _widened,
                                             sample_views_affine_t,
                                             sample_views_grad_t,
                                             sample_views_t)
from lt_tpu_torch.ops.volumetric import (aggregate_views, index_grid,
                                        sample_homogeneous)

METHODS = {"softmax": 0, "sum": 1, "max": 2, "conf": 3, "conf_norm": 3}

#: The window budget: pixels of one view's staged feature window.  At the
#: flagship geometry a brick's taps span at most 288 pixels of a view
#: (tests/test_torch_unproject_plan.py), so 384 stages every view.
AGG_WINDOW = 384
#: Whether the default plan stages the windows, by feature element size.
#: On an H100 80GB HBM3 at 700 W, at the flagship shapes (PERF.md, kernel
#: table row 1), staging paid in bfloat16 (0.670-0.676 ms against
#: 0.705-0.707 from device memory) and not in float32 (0.773-0.777 against
#: 0.744-0.745), where L1 already catches the taps' reuse.
AGG_STAGED = {2: True, 4: False}


def agg_smem_bytes(voxels: int, window: int, elem: int) -> int:
    """unproject_agg.cu's ``agg_smem_bytes``: two window buffers of
    AGG_CHUNK channels a pixel, two tap buffers (32 bytes a voxel) and two
    slots of the per-warp bounding boxes."""
    return (2 * window * AGG_CHUNK * elem + 2 * voxels * 32
            + 2 * (voxels // 32) * 16)


class AggPlan(NamedTuple):
    """One unproject_agg launch: the window budget (pixels; 0 stages
    none), dynamic shared memory (bytes), bricks (grid x; grid y is the
    batch) and channel chunks (grid z)."""
    window: int
    smem: int
    grid: int
    chunks: int

    @property
    def args(self):
        return tuple(self)


@functools.lru_cache(maxsize=None)
def unproject_plan(channels: int, grid_size: int, elem: int,
                   window: Optional[int] = None,
                   x_extent: Optional[int] = None) -> AggPlan:
    """The launch plan of unproject_agg for C = ``channels``, an S^3 grid
    (or ``x_extent`` of its X planes, a slab) and ``elem``-byte features:
    one block per AGG_BRICK and chunk of AGG_CHUNK channels; ``window``
    pixels of staged window (0: every view's taps from device memory), by
    default AGG_WINDOW where AGG_STAGED says so for ``elem``, else 0."""
    if window is None:
        window = AGG_WINDOW if AGG_STAGED.get(elem) else 0
    smem = agg_smem_bytes(math.prod(AGG_BRICK), window, elem)
    if smem > AGG_SMEM_MAX:
        raise ValueError(f"unproject_agg: a {window}-pixel window does not "
                         f"fit {AGG_SMEM_MAX} bytes of shared memory")
    extents = (x_extent or grid_size, grid_size, grid_size)
    bricks = math.prod(math.ceil(e / n) for e, n in zip(extents, AGG_BRICK))
    return AggPlan(window, smem, bricks, math.ceil(channels / AGG_CHUNK))


def brick_windows(m: torch.Tensor, grid_size: int, h: int, w: int,
                  clamped: bool = False,
                  slab: Optional[Tuple[int, int]] = None):
    """The boxes of K1's staged windows (``clamped=True``) or of K6's and
    K8's pre-reduction (the default), on the same brick, in plain PyTorch:
    for each sample, view and brick (in the kernel's grid order: z fastest,
    then y, then x), the pixel bounding box (x0, x1, y0, y1) and its pixel
    count (0 where the brick has no tap).

    The scatters' box holds the taps of the brick's voxels that lie in the
    (h, w) map.  K1 reads every tap of a voxel in front of the camera at
    its pixel clamped to the map (weight 0 off the map): its box holds
    those clamped pixels.

    Args:
      m: (B, V, 3, 4) composed grid-index -> pixel matrices.
      slab: (x0, sx): the bricks of the X planes [x0, x0 + sx) only, as
        K1 launched on that slab takes them.
    Returns:
      boxes (B, V, bricks, 4) and pixels (B, V, bricks), int64.
    """
    b, v = m.shape[:2]
    s = grid_size
    sx = slab[1] if slab else s
    bx, by, bz = AGG_BRICK
    nby, nbz = math.ceil(s / by), math.ceil(s / bz)
    uvw = _project(m.reshape(b * v, 3, 4), s, slab)        # (BV, N, 3)
    z = uvw[..., 2]
    z_safe = torch.where(z == 0.0, torch.ones_like(z), z)
    x0 = torch.floor(uvw[..., 0] / z_safe * ((w - 1) / w))
    y0 = torch.floor(uvw[..., 1] / z_safe * ((h - 1) / h))
    g = torch.arange(s, device=m.device)
    gx, gy, gz = torch.meshgrid(g[:sx], g, g, indexing="ij")
    brick_of = ((gx // bx * nby + gy // by) * nbz + gz // bz).reshape(-1)
    nb = math.ceil(sx / bx) * nby * nbz
    big = torch.iinfo(torch.int64).max
    lo = torch.full((b * v, nb, 2), big, dtype=torch.int64, device=m.device)
    hi = torch.full_like(lo, -big)
    idx = brick_of[None, :, None].expand(b * v, -1, 2)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xk, yk = x0 + dx, y0 + dy
        if clamped:
            taken = z > 0
            xy = torch.stack([xk.clamp(0, w - 1), yk.clamp(0, h - 1)], -1)
        else:
            taken = (z > 0) & (xk >= 0) & (xk <= w - 1) & (yk >= 0) & (
                yk <= h - 1)
            xy = torch.stack([xk.clamp(-1, w), yk.clamp(-1, h)], -1)
        xy = xy.long()
        lo.scatter_reduce_(1, idx, torch.where(taken[..., None], xy, big),
                           "amin")
        hi.scatter_reduce_(1, idx, torch.where(taken[..., None], xy, -big),
                           "amax")
    boxes = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    empty = boxes[..., 0] > boxes[..., 1]
    pixels = torch.where(empty, 0, (boxes[..., 1] - boxes[..., 0] + 1)
                         * (boxes[..., 3] - boxes[..., 2] + 1))
    return boxes.reshape(b, v, nb, 4), pixels.reshape(b, v, nb)


def compose_grid_projection(proj_matrices: torch.Tensor,
                            grid_affine: torch.Tensor) -> torch.Tensor:
    """m = P @ [A; 0 0 0 1]: (B, V, 3, 4) grid-index -> homogeneous pixel,
    as an explicit multiply-sum (full float32 for float32 inputs)."""
    b = grid_affine.shape[0]
    dt = torch.promote_types(proj_matrices.dtype, grid_affine.dtype)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                          device=grid_affine.device).expand(b, 1, 4)
    affine4 = torch.cat([grid_affine.to(dt), bottom], dim=1)  # (B, 4, 4)
    return (proj_matrices.to(dt)[..., :, :, None]
            * affine4[:, None, None, :, :]).sum(-2)


def unproject_agg_plain(features: torch.Tensor, m: torch.Tensor,
                        view_mask: torch.Tensor,
                        vol_confidences: Optional[torch.Tensor],
                        method: str, grid_size: int,
                        slab: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Plain version of K1: (B, V, H, W, C), m (B, V, 3, 4) -> (B, S^3, C),
    or the slab's (B, sx * S^2, C).  bfloat16 features are widened to
    float32 and the result rounded once."""
    grid = index_grid(grid_size, features.device, m.dtype,
                      slab).reshape(-1, 4)
    uvw = (m[:, :, None, :, :] * grid[None, None, :, None, :]).sum(-1)
    wide = features.dtype == torch.bfloat16
    out = aggregate_views(
        sample_homogeneous(features.float() if wide else features, uvw),
        method, vol_confidences, view_mask)
    return out.to(features.dtype) if wide else out


def unproject_agg(features: torch.Tensor, m: torch.Tensor,
                  view_mask: torch.Tensor,
                  vol_confidences: Optional[torch.Tensor],
                  method: str, grid_size: int,
                  plan: Optional[AggPlan] = None,
                  slab: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    Args:
      features: (B, V, H, W, C) float32 or bfloat16; the output has their
        type, everything between is float32.
      m: (B, V, 3, 4) float32 composed grid-index -> pixel matrices.
      view_mask: (B, V); views with mask <= 0 are left out.
      vol_confidences: (B, V, C) for 'conf' / 'conf_norm', else None.
      plan: the launch plan; default :func:`unproject_plan`'s for these
        shapes (another window budget computes the same values).
      slab: (x0, sx): fill only the X planes [x0, x0 + sx) of the grid.
    Returns:
      (B, S^3, C) with voxel n = (gx * S + gy) * S + gz; for a slab
      (B, sx * S^2, C), gx counted from x0: the grid's rows, to the bit.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown volume_aggregation_method: {method}")
    if method.startswith("conf") and vol_confidences is None:
        raise ValueError(f"{method!r} aggregation needs vol_confidences")
    x0, sx = slab or (0, grid_size)
    if not (0 <= x0 and 1 <= sx <= grid_size - x0):
        raise ValueError(f"slab {slab} is not inside a {grid_size}^3 grid")
    if not features.is_cuda:
        return unproject_agg_plain(features, m, view_mask, vol_confidences,
                                   method, grid_size, slab)
    b, v, h, w, c = features.shape
    _build.check_cuda(features, "features", 5, dtypes=_build.F32_BF16)
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
    out = torch.empty((b, sx * grid_size ** 2, c), dtype=features.dtype,
                      device=features.device)
    plan = (plan or unproject_plan(
        c, grid_size, features.element_size(),
        x_extent=None if sx == grid_size else sx)).args
    p, i, f = _build.ptr, _build.i32, _build.f32
    _build.launch("unproject_agg", features.device,
        [p, p, p, p, p, i, i, i, i, i, i, i, f, f, i] + [i] * len(plan)
        + [i, i],
        features.data_ptr(), m.data_ptr(), view_mask.data_ptr(), conf_ptr,
        out.data_ptr(), b, v, h, w, c, grid_size, METHODS[method],
        (w - 1) / w, (h - 1) / h, _build.DTYPE_CODES[features.dtype], *plan,
        x0, sx)
    return out


class _SampleViewsAgg(torch.autograd.Function):
    """K1 forward; the backward recomputes the per-view samples with K5,
    applies the softmax or sum VJP in PyTorch ops and scatters with K6,
    all three on the grid or on the same slab (whose dF is that slab's
    voxels' part of the features' gradient).

    Only ``(features, m, view_mask)`` are saved: the (B, V, C, N) samples
    never outlive the backward (``lt_tpu``'s training-memory design).
    bfloat16 features follow ``lt_tpu``'s ``_agg_bwd``
    (``unproject.py:463-504``): K5 recomputes the samples bfloat16 ->
    bfloat16, the VJP runs in float32 on the widened samples and g (the
    softmax's masked logits are -1e9 in float32), and its cotangent is
    rounded to bfloat16 into K6; dF is cast to the features' type.  Float32
    features recompute in float32 (``lt_tpu`` recomputes in bfloat16 there
    too; the port's float32 step is held to ``lt_tpu``'s float64 one).
    """

    @staticmethod
    def forward(ctx, features, m, view_mask, method, grid_size, slab):
        ctx.save_for_backward(features, m, view_mask)
        ctx.method, ctx.grid_size, ctx.slab = method, grid_size, slab
        return unproject_agg(features, m, view_mask, None, method, grid_size,
                             slab=slab)

    @staticmethod
    def backward(ctx, g):
        features, m, view_mask = ctx.saved_tensors
        b, v, h, w, c = features.shape
        bv_shape = (b * v, h, w, c)
        s = sample_views_t(features.reshape(bv_shape), m.reshape(b * v, 3, 4),
                           ctx.grid_size, out_dtype=features.dtype,
                           slab=ctx.slab).reshape(b, v, c, -1)
        s32, g = _widened(s), _widened(g).transpose(1, 2)[:, None]
        keep = (view_mask > 0.0)[:, :, None, None]
        zero = torch.zeros((), dtype=s32.dtype, device=s.device)
        if ctx.method == "softmax":
            wgt = torch.softmax(torch.where(keep, s32, zero - 1e9), dim=1)
            contrib = torch.where(keep, s32, zero)
            out = (wgt * contrib).sum(1, keepdim=True)
            # d out / d s_k = w_k (1 + s_k - out) for kept views.
            ds = torch.where(keep, g * wgt * (1.0 + contrib - out), zero)
        else:
            ds = torch.where(keep, g, zero).expand(b, v, c, s.shape[-1])
        df = sample_views_grad_t(
            ds.to(s.dtype).reshape(b * v, c, -1).contiguous(),
            m.reshape(b * v, 3, 4), bv_shape, ctx.grid_size, slab=ctx.slab)
        return (df.reshape(features.shape).to(features.dtype), None, None,
                None, None, None)


def sample_views_agg(features: torch.Tensor, m: torch.Tensor,
                     view_mask: torch.Tensor, method: str,
                     grid_size: int,
                     slab: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Differentiable :func:`unproject_agg` for 'softmax' and 'sum' without
    confidences: (B, V, H, W, C) -> (B, S^3, C) (a ``slab``'s (B, sx * S^2,
    C)), gradients to ``features``.
    """
    if method not in ("softmax", "sum"):
        raise ValueError(f"no fused-aggregation backward for {method!r}")
    return _SampleViewsAgg.apply(features, m, view_mask, method, grid_size,
                                 slab)


def unproject_heatmaps_affine(features: torch.Tensor,
                              proj_matrices: torch.Tensor,
                              grid_affine: torch.Tensor, grid_size: int,
                              volume_aggregation_method: str = "softmax",
                              vol_confidences: Optional[torch.Tensor] = None,
                              view_mask: Optional[torch.Tensor] = None,
                              channels_last: bool = False,
                              fuse_aggregation: bool = True,
                              aggregation_dtype: Optional[torch.dtype] = None,
                              slab: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """Fused-unprojection equivalent of ``volumetric.unproject_heatmaps``,
    as ``lt_tpu``'s ``unproject_heatmaps_affine``
    (``lt_tpu/ops/pallas/unproject.py:710-829``).

    Args:
      features: (B, V, H, W, C); proj_matrices: (B, V, 3, 4) in heatmap
        pixels; grid_affine: (B, 3, 4) grid index -> world mm
        (``volumetric.coord_volume_affine``).
      channels_last: return (B, S, S, S, C) -- the kernel's own voxel
        order -- instead of (B, C, S, S, S).
      fuse_aggregation: aggregate inside K1.  'softmax' and 'sum' without
        confidences are then differentiable (:func:`sample_views_agg`);
        'conf' and 'max' are forward-only there.  False samples every view
        with K5 (differentiable through K6) and aggregates in PyTorch ops:
        the training path of 'conf' and 'max'.
      aggregation_dtype: the volume's type.  The unfused path samples
        straight into it (K5's ``out_dtype``) and aggregates those samples
        (``volumetric.aggregate_views``), as ``lt_tpu`` does.  None: K1
        writes the features' type; the unfused path samples in float32
        (float64 features: float64, on the CPU).
      slab: (x0, sx): only the X planes [x0, x0 + sx) of the grid,
        (B, sx, S, S, C) channels-last (volume-axis sharding), on every
        path above: K1 on the slab (its backward K5 and K6 on the slab), or
        K5 on the slab (its backward K6 on the slab) and the aggregation.
    """
    b, v, h, w, c = features.shape
    m = compose_grid_projection(proj_matrices, grid_affine)
    if view_mask is None:
        view_mask = torch.ones((b, v), dtype=torch.float32,
                               device=features.device)
    method = volume_aggregation_method
    if not fuse_aggregation:
        out_dtype = aggregation_dtype or (
            torch.float32 if features.dtype == torch.bfloat16
            else features.dtype)
        sampled = sample_views_affine_t(
            features.reshape(b * v, h, w, c), m.reshape(b * v, 3, 4),
            grid_size, out_dtype, slab=slab).reshape(b, v, c, -1)
        volume = aggregate_views(sampled.transpose(2, 3), method,
                                 vol_confidences, view_mask).contiguous()
    elif method in ("softmax", "sum") and vol_confidences is None:
        volume = sample_views_agg(features, m, view_mask, method, grid_size,
                                  slab=slab)
    else:
        volume = unproject_agg(features, m, view_mask, vol_confidences,
                               method, grid_size, slab=slab)
    if aggregation_dtype is not None:
        volume = volume.to(aggregation_dtype)
    s = grid_size
    sx = slab[1] if slab else s
    if channels_last:
        return volume.reshape(b, sx, s, s, c)
    return volume.transpose(1, 2).reshape(b, c, sx, s, s)
