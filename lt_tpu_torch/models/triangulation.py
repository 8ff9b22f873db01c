"""The three triangulation model families: algebraic, volumetric, RANSAC.

Port of ``lt_tpu/models/triangulation.py``.  The algebraic model
(``:111-180``): backbone heatmaps -> 2D soft-argmax -> confidence-weighted
DLT over (B, J) in one call (``ops/geometry.py``'s Jacobi eigensolver).
RANSAC (``:357-526``): a hard argmax of the heatmaps, every view pair
triangulated in one batched DLT call, the best inlier set re-triangulated,
then a fixed number of Huber-IRLS Gauss-Newton steps, all on the device
with no host round trip.  Neither has a TPU kernel in ``lt_tpu`` (XLA
only), so neither launches a kernel of the port.

The volumetric model (``:67-97, 188-349``): backbone
features -> 1x1 ``process_features`` conv -> fused unprojection with
cross-view aggregation (kernel K1) -> V2V (kernels K2-K4 in eval, the
cuDNN module graph in training) -> channels-last volumetric soft-argmax.
In training the unprojection's backward runs kernels K5 and K6.  Public
layouts as in ``lt_tpu``: images (B, V, H, W, 3), projections (B, V, 3, 4)
in image pixels.

``compute_dtype=torch.bfloat16`` is ``lt_tpu``'s ``bf16: true``
(``triangulation.py:208-231, 303-317``), in eval and in training: the
backbone and ``process_features`` convolve in bfloat16 (float32 master
weights under ``torch.autocast``), K1 reads bfloat16 features and writes
the aggregated volume in bfloat16 (the unfused training path of 'conf' and
'max' samples into bfloat16 with K5: ``aggregation_dtype``), V2V runs in
bfloat16 (in training its output leaves in float32), and the soft-argmax
widens its volume to float32.  Cameras, grids, the projection arithmetic,
heatmaps, keypoints, the DLT and the losses are float32 throughout; the
training backward of the fused aggregation runs K5 and K6 in bfloat16.

``volume_axis_sharding`` (a process group) is ``lt_tpu``'s key of that
name (``triangulation.py:210-214, 284-336``) for the volumetric model on
the fused kernel path, in eval and in training: every rank runs the
backbone on the whole batch, K1 fills the rank's slab of the volume on X
(in training its backward runs K5 and K6 on that slab; 'conf' and 'max'
sample the slab with K5), V2V runs on slabs (``models/v2v.py``) and the
soft-argmax reduces over the group, so every rank returns the whole
batch's keypoints (``parallel/spatial.py``, which also sets out how the
backward's gradients combine).  The "conv" and ``False`` paths are not
sharded: ``use_kernels=False`` is the plain reference that the kernel
path is held to, and it runs unsharded.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from lt_tpu_torch import compute_context, resolve_device
from lt_tpu_torch.models.backbone import PoseResNet
from lt_tpu_torch.models.init import init_weights
from lt_tpu_torch.models.v2v import V2VModel, kernel_path
from lt_tpu_torch.ops import geometry
from lt_tpu_torch.ops import heatmaps as hm_ops
from lt_tpu_torch.ops import volumetric as vol_ops
from lt_tpu_torch.ops.kernels.unproject import unproject_heatmaps_affine
from lt_tpu_torch.parallel.spatial import slab_group


class AlgebraicOutput(NamedTuple):
    keypoints_3d: torch.Tensor          # (B, J, 3) world mm
    keypoints_2d: torch.Tensor          # (B, V, J, 2) image px
    heatmaps: torch.Tensor              # (B, V, J, h, w) post-softmax
    confidences: torch.Tensor           # (B, V, J)


class RansacOutput(NamedTuple):
    keypoints_3d: torch.Tensor          # (B, J, 3)
    keypoints_2d: torch.Tensor          # (B, V, J, 2)
    heatmaps: torch.Tensor              # (B, V, J, h, w) raw
    confidences: torch.Tensor           # (B, V, J) zeros plug


class VolumetricOutput(NamedTuple):
    """Under volume-axis sharding ``volumes`` and ``coord_volumes`` are the
    rank's slab on X, (B, J, S / ranks, S, S) and (B, S / ranks, S, S, 3):
    ``SlabGroup.gather_x`` gives the whole volume (dim 2, dim 1)."""
    keypoints_3d: torch.Tensor          # (B, J, 3) world mm
    features: torch.Tensor              # (B, V, h, w, C) processed features
    volumes: torch.Tensor               # (B, J, S, S, S) post-softmax
    vol_confidences: Optional[torch.Tensor]  # (B, V, 32) or None
    coord_volumes: torch.Tensor         # (B, S, S, S, 3)
    base_points: torch.Tensor           # (B, 3)


def select_base_points(keypoints_3d: torch.Tensor, kind: str) -> torch.Tensor:
    """Pelvis per sample: 'coco' mean of joints 11, 12; 'mpii' joint 6;
    'cmu' joint 2."""
    if kind == "coco":
        return (keypoints_3d[:, 11, :3] + keypoints_3d[:, 12, :3]) / 2.0
    if kind == "mpii":
        return keypoints_3d[:, 6, :3]
    if kind == "cmu":
        return keypoints_3d[:, 2, :3]
    raise ValueError(f"Unknown kind: {kind}")


def rescale_proj_to_heatmap(proj_matrices: torch.Tensor, image_shape,
                            heatmap_shape) -> torch.Tensor:
    """Left-multiply by diag(hm_w / img_w, hm_h / img_h, 1)."""
    ih, iw = image_shape
    hh, hw = heatmap_shape
    scale = torch.tensor([hw / iw, hh / ih, 1.0], dtype=proj_matrices.dtype,
                         device=proj_matrices.device)
    return proj_matrices * scale[:, None]


def _upscale_keypoints(keypoints: torch.Tensor, heatmap_shape,
                       image_shape) -> torch.Tensor:
    """Heatmap-space (..., 2) (x, y) -> image space (x * iw / hw,
    y * ih / hh), with no host-to-device copy."""
    hh, hw = heatmap_shape
    ih, iw = image_shape
    return torch.stack([keypoints[..., 0] * (iw / hw),
                        keypoints[..., 1] * (ih / hh)], -1)


def _check_dtype(compute_dtype: torch.dtype) -> None:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")


def _backbone_heatmaps(backbone, images: torch.Tensor):
    """(B, V, H, W, 3) images -> raw heatmaps (B, V, J, h, w) and the
    algebraic confidences (B * V, J) or None."""
    b, v = images.shape[:2]
    flat = images.reshape((b * v,) + images.shape[2:]).permute(0, 3, 1, 2)
    raw, _, alg_conf, _ = backbone(flat)
    return raw.reshape((b, v) + raw.shape[1:]), alg_conf


class _PoseNet(nn.Module):
    """What the algebraic and RANSAC models share: a PoseResNet built in
    eval mode on ``device``, the forward under ``torch.no_grad`` in eval
    and under autograd in training (``model.train()``)."""

    def __init__(self, num_joints, num_layers, style, alg_confidences,
                 remat, device, seed, compute_dtype):
        super().__init__()
        _check_dtype(compute_dtype)
        dev = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.backbone = PoseResNet(
            num_joints, num_layers, style, alg_confidences=alg_confidences,
            vol_confidences=False, remat=remat, device=dev, seed=seed,
            compute_dtype=compute_dtype)
        self.to(dev).eval()

    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None):
        """Args:
          images: (B, V, H, W, 3) normalized images.
          proj_matrices: (B, V, 3, 4) in image pixels.
          view_mask: optional (B, V) validity of each view.
        """
        if self.training:
            return self._forward(images, proj_matrices, view_mask)
        with torch.no_grad():
            return self._forward(images, proj_matrices, view_mask)


class AlgebraicTriangulationNet(_PoseNet):
    """Backbone -> 2D soft-argmax -> confidence-weighted DLT.

    ``use_confidences`` adds the backbone's GAP confidence head
    (``alg_confidences``); without it every view weighs 1.  Confidences
    are normalized over the views plus a 1e-5 floor; with a ``view_mask``
    the floor goes to present views only, so a masked view carries exactly
    zero DLT weight and the result equals dropping the view.
    ``compute_dtype=torch.bfloat16`` is ``lt_tpu``'s ``bf16: true`` (the
    backbone convolves in bfloat16; heatmaps, confidences, keypoints and
    the DLT are float32), in eval and in training.
    """

    def __init__(self, num_joints: int = 17, num_layers: int = 152,
                 style: str = "simple", use_confidences: bool = True,
                 heatmap_softmax: bool = True,
                 heatmap_multiplier: float = 100.0, remat: bool = False,
                 device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_joints, num_layers, style, use_confidences,
                         remat, device, seed, compute_dtype)
        self.use_confidences = use_confidences
        self.heatmap_softmax = heatmap_softmax
        self.heatmap_multiplier = heatmap_multiplier

    def _forward(self, images, proj_matrices, view_mask) -> AlgebraicOutput:
        b, v = images.shape[:2]
        raw, alg_conf = _backbone_heatmaps(self.backbone, images)
        j = raw.shape[2]
        heatmap_shape = raw.shape[3:5]
        keypoints_2d, soft_heatmaps = hm_ops.integrate_tensor_2d(
            raw * self.heatmap_multiplier, self.heatmap_softmax)
        if self.use_confidences:
            conf = alg_conf.reshape(b, v, j)
        else:
            conf = torch.ones((b, v, j), dtype=keypoints_2d.dtype,
                              device=images.device)
        if view_mask is not None:
            vm = view_mask.to(conf.dtype)[:, :, None]
            conf = conf * vm
            conf = conf / conf.sum(1, keepdim=True).clamp_min(1e-12)
            conf = conf + 1e-5 * vm
        else:
            conf = conf / conf.sum(1, keepdim=True).clamp_min(1e-12)
            conf = conf + 1e-5
        keypoints_2d = _upscale_keypoints(keypoints_2d, heatmap_shape,
                                          images.shape[2:4])
        keypoints_3d = geometry.triangulate_batch_dlt(
            proj_matrices.to(keypoints_2d.dtype), keypoints_2d, conf)
        return AlgebraicOutput(keypoints_3d, keypoints_2d, soft_heatmaps,
                               conf)


def draw_rotation_thetas(n: int, generator: torch.Generator,
                         rank: int = 0, ranks: int = 1) -> torch.Tensor:
    """(n,) training cuboid rotations, U[0, 2 pi) from ``generator``.

    Under data parallelism every one of ``ranks`` ranks draws the global
    batch's ``n * ranks`` rotations and keeps rank ``rank``'s rows: the
    rotations are the one-process run's and the generator advances as
    there, so a checkpoint resumes exactly on any world size."""
    thetas = torch.rand((n * ranks,), generator=generator) * (2.0 * math.pi)
    return thetas[rank * n:(rank + 1) * n]


class KernelUnprojection(nn.Module):
    """The kernel path's unprojection step, :func:`unproject_heatmaps_affine`
    (K1, or in training K5 per view where K1 has no backward), as a module
    without state so that forward hooks can mark it
    (``lt_tpu_torch.profile_stages``)."""

    def forward(self, *args, **kwargs):
        return unproject_heatmaps_affine(*args, **kwargs)


class VolumetricTriangulationNet(nn.Module):
    """Backbone features -> unprojection -> V2V -> volumetric soft-argmax.

    Built in eval mode; ``model.train()`` switches BatchNorm to batch
    statistics and the forward to autograd.  ``use_kernels`` is ``"fused"``
    (the default, also ``True``), ``"conv"`` (V2V's per-conv kernel
    configuration, ``models/v2v.py``) or ``False``, which runs the
    plain reference path instead of the kernels:
    ``volumetric.unproject_heatmaps`` (under autograd in training) and V2V's
    unfused module graph (used to hold the kernel path to account).  The
    backbone's ``final_layer`` is frozen by the optimizer
    (``engine.factory.make_optimizer``), as in ``lt_tpu``.

    ``volume_axis_sharding``: a process group of more than one rank
    splits each sample's volume on X over it on the "fused" path, in eval
    and in training (``self.volume_axis_sharding``, a
    ``parallel.spatial.SlabGroup``; None where the group has one rank,
    which is the unsharded model).  The other paths raise
    ``NotImplementedError``: they are the references the fused path is
    held to, and run unsharded.  In training every rank draws the whole
    batch's rotations from its generator (seeded alike on every rank), so
    that every rank builds the same cuboids.
    """

    def __init__(self, num_joints: int = 17, num_layers: int = 152,
                 style: str = "simple",
                 volume_aggregation_method: str = "softmax",
                 volume_softmax: bool = True, volume_multiplier: float = 1.0,
                 volume_size: int = 64, cuboid_side: float = 2500.0,
                 kind: str = "mpii", transfer_cmu_to_human36m: bool = False,
                 use_kernels="fused", remat: bool = False,
                 device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 volume_axis_sharding=None):
        super().__init__()
        dev = resolve_device(device)
        _check_dtype(compute_dtype)
        self.compute_dtype = compute_dtype
        self.volume_aggregation_method = volume_aggregation_method
        self.volume_softmax = volume_softmax
        self.volume_multiplier = volume_multiplier
        self.volume_size = volume_size
        self.cuboid_side = cuboid_side
        self.kind = kind
        self.transfer_cmu_to_human36m = transfer_cmu_to_human36m
        self.use_kernels = kernel_path(use_kernels)
        self.volume_axis_sharding = slab_group(volume_axis_sharding,
                                               volume_size)
        if self.volume_axis_sharding and self.use_kernels != "fused":
            raise NotImplementedError(
                f"volume-axis sharding runs the fused kernel path only, not "
                f"use_kernels={self.use_kernels!r}: 'conv' and False are "
                f"the references the fused path is held to, and run "
                f"unsharded (README; ROADMAP A8)")
        self.backbone = PoseResNet(
            num_joints, num_layers, style, alg_confidences=False,
            vol_confidences=volume_aggregation_method.startswith("conf"),
            remat=remat, device=dev, seed=seed,
            compute_dtype=compute_dtype)
        self.process_features = nn.Sequential(nn.Conv2d(256, 32, 1))
        init_weights(self.process_features, seed + 1)
        self.unproject = KernelUnprojection()
        self.volume_net = V2VModel(32, num_joints, use_kernels=use_kernels,
                                   remat=remat, device=dev, seed=seed + 2,
                                   compute_dtype=compute_dtype)
        self.to(dev).eval()

    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor,
                pelvis_keypoints: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None,
                rotation_thetas: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> VolumetricOutput:
        """Args:
          images: (B, V, H, W, 3) normalized images.
          proj_matrices: (B, V, 3, 4) in image pixels.
          pelvis_keypoints: (B, J, >=3) keypoints that locate the pelvis.
          view_mask: optional (B, V) validity of each view.
          rotation_thetas: optional (B,) cuboid rotations.  Default: zeros
            in eval; in training U[0, 2 pi) drawn from ``generator`` (a CPU
            ``torch.Generator``, so a seed gives the same draw on every
            device), as ``lt_tpu`` draws from its 'aug' stream.
        """
        if not self.training:
            with torch.no_grad():
                return self._forward(images, proj_matrices, pelvis_keypoints,
                                     view_mask, rotation_thetas)
        if rotation_thetas is None:
            if generator is None:
                raise ValueError("training draws cuboid rotations: pass "
                                 "rotation_thetas or a torch.Generator")
            rotation_thetas = draw_rotation_thetas(images.shape[0], generator)
        return self._forward(images, proj_matrices, pelvis_keypoints,
                             view_mask, rotation_thetas.to(images.device))

    def _forward(self, images, proj_matrices, pelvis_keypoints, view_mask,
                 rotation_thetas) -> VolumetricOutput:
        b, v = images.shape[:2]
        image_shape = images.shape[2:4]

        flat = images.reshape((b * v,) + images.shape[2:]).permute(0, 3, 1, 2)
        _, features, _, vol_conf = self.backbone(flat)
        heatmap_shape = features.shape[2:4]

        if vol_conf is not None:
            vol_conf = vol_conf.reshape(b, v, -1)
            if self.volume_aggregation_method == "conf_norm":
                vol_conf = vol_conf / vol_conf.sum(1, keepdim=True).clamp_min(
                    1e-12)

        proj_hm = rescale_proj_to_heatmap(proj_matrices, image_shape,
                                          heatmap_shape)
        base_points = select_base_points(pelvis_keypoints, self.kind)
        if rotation_thetas is None:
            rotation_thetas = torch.zeros(b, dtype=images.dtype,
                                          device=images.device)
        axis = (0.0, 1.0, 0.0) if self.kind == "coco" else (0.0, 0.0, 1.0)
        cv_args = (base_points, self.cuboid_side, self.volume_size,
                   rotation_thetas, axis, self.transfer_cmu_to_human36m)
        slabs = self.volume_axis_sharding
        slab = None if slabs is None else slabs.slab(self.volume_size)
        coord_volumes = vol_ops.build_coord_volumes(*cv_args, slab=slab)

        with compute_context(features, self.compute_dtype):
            features = self.process_features(features)
        features = features.permute(0, 2, 3, 1)
        features = features.reshape((b, v) + features.shape[1:]).contiguous()

        if self.use_kernels:
            # As lt_tpu (triangulation.py:303-317): training keeps the fused
            # aggregation where its backward exists (softmax / sum without
            # confidences) and samples per view otherwise; the volume comes
            # in the compute dtype.
            fuse = not self.training or (
                self.volume_aggregation_method in ("softmax", "sum")
                and vol_conf is None)
            volumes = self.unproject(
                features, proj_hm, vol_ops.coord_volume_affine(*cv_args),
                self.volume_size,
                volume_aggregation_method=self.volume_aggregation_method,
                vol_confidences=vol_conf, view_mask=view_mask,
                channels_last=True, fuse_aggregation=fuse,
                aggregation_dtype=(None if self.compute_dtype == torch.float32
                                   else self.compute_dtype), slab=slab)
        else:
            volumes = vol_ops.unproject_heatmaps(
                features, proj_hm, coord_volumes,
                volume_aggregation_method=self.volume_aggregation_method,
                vol_confidences=vol_conf, view_mask=view_mask)
            volumes = volumes.permute(0, 2, 3, 4, 1).contiguous()

        volumes = (self.volume_net(volumes) if slabs is None
                   else self.volume_net(volumes, slabs=slabs))
        keypoints_3d, volumes = \
            hm_ops.integrate_tensor_3d_with_coordinates_channels_last(
                volumes * self.volume_multiplier, coord_volumes,
                softmax=self.volume_softmax, slabs=slabs)
        return VolumetricOutput(keypoints_3d, features, volumes, vol_conf,
                                coord_volumes, base_points)


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------


def _pair_indices(n_views: int):
    return [(i, k) for i in range(n_views) for k in range(i + 1, n_views)]


def _projection_jacobian(x: torch.Tensor, proj_matrices: torch.Tensor):
    """The projections (..., V, 2) of points x (..., 3) and their Jacobian
    d proj / d x (..., V, 2, 3) in closed form: (P[r, :3] - proj_r
    P[2, :3]) / w for r = 0, 1, with w the homogeneous depth."""
    uvw = (proj_matrices[..., :3] * x[..., None, None, :]).sum(-1) \
        + proj_matrices[..., 3]                           # (..., V, 3)
    w = uvw[..., 2:3]
    proj = uvw[..., :2] / w
    jac = (proj_matrices[..., :2, :3]
           - proj[..., :, None] * proj_matrices[..., 2:3, :3]) / w[..., None]
    return proj, jac


def ransac_triangulate(proj_matrices: torch.Tensor, points: torch.Tensor,
                       reprojection_error_epsilon: float = 15.0,
                       direct_optimization: bool = True,
                       n_gn_iters: int = 5, huber_delta: float = 1.0,
                       view_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """RANSAC triangulation over all view pairs, on the device.

    Every C(V, 2) pair is triangulated in one batched DLT call (0/1 view
    weights); a candidate's inliers are the views with half reprojection
    error ``0.5 |reproj - pt| < epsilon`` (NaN or inf counted as 1e9), its
    pair's two views always among them; the pair with the most inliers
    wins (``argmax``: the first on ties) and the point is re-triangulated
    with its 0/1 inlier weights.  ``direct_optimization`` then takes
    ``n_gn_iters`` Gauss-Newton steps on the inliers' reprojection
    residuals with Huber IRLS weights (delta ``huber_delta`` px), the 2 x 3
    projection Jacobian per view in closed form and each 3 x 3 system
    solved by ``torch.linalg.solve_ex``: no loop over points and no value
    read on the host.

    Args:
      proj_matrices: (..., V, 3, 4).
      points: (..., V, 2).
      view_mask: optional (..., V) view validity: a masked view forms no
        pair, is never an inlier and carries zero weight, so the result
        equals dropping the view (needs two unmasked views a point).
    Returns:
      (..., 3) points.
    """
    v = points.shape[-2]
    n_pairs = v * (v - 1) // 2
    dev, dt = points.device, points.dtype
    first, second = torch.triu_indices(v, v, 1, device=dev)
    views = torch.arange(v, device=dev)
    pair_masks = ((views == first[:, None])
                  | (views == second[:, None])).to(dt)    # (P, V)
    bpair = pair_masks.reshape((n_pairs,) + (1,) * (points.dim() - 2) + (v,))

    vm = pair_valid = None
    if view_mask is not None:
        vm = view_mask.to(dt).expand(points.shape[:-1])   # (..., V)
        pair_valid = (bpair <= vm[None]).all(-1)          # (P, ...)

    weights = bpair.expand((n_pairs,) + points.shape[:-1])
    candidates = geometry.triangulate_point_dlt(proj_matrices, points,
                                                weights)  # (P, ..., 3)
    reproj = geometry.project_points(
        proj_matrices, candidates[..., None, None, :])    # (P, ..., V, 1, 2)
    err = 0.5 * ((reproj[..., 0, :] - points) ** 2).sum(-1).sqrt()
    err = torch.nan_to_num(err, nan=1e9, posinf=1e9, neginf=1e9)

    inliers = torch.maximum((err < reprojection_error_epsilon).to(dt), bpair)
    if vm is not None:
        inliers = inliers * vm[None]
    counts = inliers.sum(-1)                              # (P, ...)
    if pair_valid is not None:
        counts = torch.where(pair_valid, counts, torch.full_like(counts, -1))
    best = counts.argmax(0)                               # (...)
    best_mask = inliers.movedim(0, -2).gather(
        -2, best[..., None, None].expand(best.shape + (1, v)))[..., 0, :]

    point = geometry.triangulate_point_dlt(proj_matrices, points, best_mask)
    if not direct_optimization:
        return point
    eye = 1e-6 * torch.eye(3, dtype=dt, device=dev)
    for _ in range(n_gn_iters):
        proj, jac = _projection_jacobian(point, proj_matrices)
        r = (proj - points) * best_mask[..., None]         # (..., V, 2)
        jac = jac * best_mask[..., None, None]
        a = (r ** 2).sum(-1).clamp_min(1e-12).sqrt()       # (..., V)
        hw = torch.where(a <= huber_delta, torch.ones_like(a),
                         huber_delta / a)
        jw = jac * hw[..., None, None]
        jtj = (jw[..., :, None] * jac[..., None, :]).sum((-4, -3)) + eye
        g = (jw * r[..., None]).sum((-3, -2))               # (..., 3)
        step, _ = torch.linalg.solve_ex(jtj, g[..., None])
        point = point - step[..., 0]
    return point


class RANSACTriangulationNet(_PoseNet):
    """Backbone -> hard argmax of the raw heatmaps ->
    :func:`ransac_triangulate` per (sample, joint).  ``confidences`` are
    the zeros plug of the reference."""

    def __init__(self, num_joints: int = 17, num_layers: int = 152,
                 style: str = "simple", direct_optimization: bool = True,
                 reprojection_error_epsilon: float = 15.0,
                 remat: bool = False, device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_joints, num_layers, style, False, remat, device,
                         seed, compute_dtype)
        self.direct_optimization = direct_optimization
        self.reprojection_error_epsilon = reprojection_error_epsilon

    def _forward(self, images, proj_matrices, view_mask) -> RansacOutput:
        b, v = images.shape[:2]
        raw, _ = _backbone_heatmaps(self.backbone, images)  # (B, V, J, h, w)
        j, hh, hw = raw.shape[2:]
        flat_idx = raw.reshape(b, v, j, -1).argmax(-1)
        keypoints_2d = torch.stack([(flat_idx % hw).to(raw.dtype),
                                    (flat_idx // hw).to(raw.dtype)], -1)
        keypoints_2d = _upscale_keypoints(keypoints_2d, (hh, hw),
                                          images.shape[2:4])
        pts = keypoints_2d.transpose(1, 2)                  # (B, J, V, 2)
        pm = proj_matrices.to(raw.dtype)[:, None].expand(b, j, v, 3, 4)
        vm = (None if view_mask is None
              else view_mask[:, None, :].expand(b, j, v))
        keypoints_3d = ransac_triangulate(
            pm, pts, self.reprojection_error_epsilon,
            self.direct_optimization, view_mask=vm)
        confidences = torch.zeros((b, v, j), dtype=raw.dtype,
                                  device=images.device)
        return RansacOutput(keypoints_3d, keypoints_2d, raw, confidences)
