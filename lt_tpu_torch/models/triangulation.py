"""The volumetric triangulation model, eval and training forward.

Port of ``lt_tpu/models/triangulation.py:67-97, 188-349``: backbone
features -> 1x1 ``process_features`` conv -> fused unprojection with
cross-view aggregation (kernel K1) -> V2V (kernels K2-K4 in eval, the
cuDNN module graph in training) -> channels-last volumetric soft-argmax.
In training the unprojection's backward runs kernels K5 and K6.  Public
layouts as in ``lt_tpu``: images (B, V, H, W, 3), projections (B, V, 3, 4)
in image pixels.

``compute_dtype=torch.bfloat16`` (eval only) is ``lt_tpu``'s ``bf16: true``
(``triangulation.py:208-231, 303-317``): the backbone and
``process_features`` convolve in bfloat16, K1 reads bfloat16 features and
writes the aggregated volume in bfloat16, V2V runs in bfloat16, and the
soft-argmax widens its volume to float32.  Cameras, grids, the projection
arithmetic and the keypoints are float32 throughout.
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
from lt_tpu_torch.ops import heatmaps as hm_ops
from lt_tpu_torch.ops import volumetric as vol_ops
from lt_tpu_torch.ops.kernels.unproject import unproject_heatmaps_affine


class VolumetricOutput(NamedTuple):
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
    """

    def __init__(self, num_joints: int = 17, num_layers: int = 152,
                 style: str = "simple",
                 volume_aggregation_method: str = "softmax",
                 volume_softmax: bool = True, volume_multiplier: float = 1.0,
                 volume_size: int = 64, cuboid_side: float = 2500.0,
                 kind: str = "mpii", transfer_cmu_to_human36m: bool = False,
                 use_kernels="fused", remat: bool = False,
                 device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.volume_aggregation_method = volume_aggregation_method
        self.volume_softmax = volume_softmax
        self.volume_multiplier = volume_multiplier
        self.volume_size = volume_size
        self.cuboid_side = cuboid_side
        self.kind = kind
        self.transfer_cmu_to_human36m = transfer_cmu_to_human36m
        self.use_kernels = kernel_path(use_kernels)
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
        if self.training and self.compute_dtype != torch.float32:
            raise NotImplementedError(
                "training runs in float32 only: compute_dtype=bfloat16 "
                "(bf16: true) is an eval configuration of the port")
        if not self.training:
            with torch.no_grad():
                return self._forward(images, proj_matrices, pelvis_keypoints,
                                     view_mask, rotation_thetas)
        if rotation_thetas is None:
            if generator is None:
                raise ValueError("training draws cuboid rotations: pass "
                                 "rotation_thetas or a torch.Generator")
            rotation_thetas = torch.rand(
                (images.shape[0],), generator=generator) * (2.0 * math.pi)
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
        coord_volumes = vol_ops.build_coord_volumes(*cv_args)

        with compute_context(features, self.compute_dtype):
            features = self.process_features(features)
        features = features.permute(0, 2, 3, 1)
        features = features.reshape((b, v) + features.shape[1:]).contiguous()

        if self.use_kernels:
            # As lt_tpu (triangulation.py:303-305): training keeps the fused
            # aggregation where its backward exists (softmax / sum without
            # confidences) and samples per view otherwise.
            fuse = not self.training or (
                self.volume_aggregation_method in ("softmax", "sum")
                and vol_conf is None)
            volumes = self.unproject(
                features, proj_hm, vol_ops.coord_volume_affine(*cv_args),
                self.volume_size,
                volume_aggregation_method=self.volume_aggregation_method,
                vol_confidences=vol_conf, view_mask=view_mask,
                channels_last=True, fuse_aggregation=fuse)
        else:
            volumes = vol_ops.unproject_heatmaps(
                features, proj_hm, coord_volumes,
                volume_aggregation_method=self.volume_aggregation_method,
                vol_confidences=vol_conf, view_mask=view_mask)
            volumes = volumes.permute(0, 2, 3, 4, 1).contiguous()

        volumes = self.volume_net(volumes)
        keypoints_3d, volumes = \
            hm_ops.integrate_tensor_3d_with_coordinates_channels_last(
                volumes * self.volume_multiplier, coord_volumes,
                softmax=self.volume_softmax)
        return VolumetricOutput(keypoints_3d, features, volumes, vol_conf,
                                coord_volumes, base_points)
