"""The volumetric triangulation model, eval forward.

Port of ``lt_tpu/models/triangulation.py:67-97, 188-349``: backbone
features -> 1x1 ``process_features`` conv -> fused unprojection with
cross-view aggregation (kernel K1) -> V2V (kernels K2-K4) -> channels-last
volumetric soft-argmax.  Public layouts as in ``lt_tpu``: images
(B, V, H, W, 3), projections (B, V, 3, 4) in image pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.backbone import PoseResNet
from lt_tpu_torch.models.init import init_weights
from lt_tpu_torch.models.v2v import V2VModel
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
    scale = torch.tensor([hw / iw, hh / ih, 1.0], dtype=torch.float32,
                         device=proj_matrices.device)
    return proj_matrices * scale[:, None]


class VolumetricTriangulationNet(nn.Module):
    """Backbone features -> unprojection -> V2V -> volumetric soft-argmax.

    Eval mode only.  ``use_kernels=False`` runs the plain reference path
    instead of the kernels: ``volumetric.unproject_heatmaps`` and V2V's
    unfused module graph (used to hold the kernel path to account).
    """

    def __init__(self, num_joints: int = 17, num_layers: int = 152,
                 style: str = "simple",
                 volume_aggregation_method: str = "softmax",
                 volume_softmax: bool = True, volume_multiplier: float = 1.0,
                 volume_size: int = 64, cuboid_side: float = 2500.0,
                 kind: str = "mpii", transfer_cmu_to_human36m: bool = False,
                 use_kernels: bool = True, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.volume_aggregation_method = volume_aggregation_method
        self.volume_softmax = volume_softmax
        self.volume_multiplier = volume_multiplier
        self.volume_size = volume_size
        self.cuboid_side = cuboid_side
        self.kind = kind
        self.transfer_cmu_to_human36m = transfer_cmu_to_human36m
        self.use_kernels = use_kernels
        self.backbone = PoseResNet(
            num_joints, num_layers, style, alg_confidences=False,
            vol_confidences=volume_aggregation_method.startswith("conf"),
            device=dev, seed=seed)
        self.process_features = nn.Sequential(nn.Conv2d(256, 32, 1))
        init_weights(self.process_features, seed + 1)
        self.volume_net = V2VModel(32, num_joints, use_kernels=use_kernels,
                                   device=dev, seed=seed + 2)
        self.to(dev).eval()

    @torch.no_grad()
    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor,
                pelvis_keypoints: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None,
                rotation_thetas: Optional[torch.Tensor] = None
                ) -> VolumetricOutput:
        """Args:
          images: (B, V, H, W, 3) normalized images.
          proj_matrices: (B, V, 3, 4) in image pixels.
          pelvis_keypoints: (B, J, >=3) keypoints that locate the pelvis.
          view_mask: optional (B, V) validity of each view.
          rotation_thetas: optional (B,) cuboid rotations (default zeros).
        """
        if self.training:
            raise NotImplementedError("the port runs the eval forward only")
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
            rotation_thetas = torch.zeros(b, dtype=torch.float32,
                                          device=images.device)
        axis = (0.0, 1.0, 0.0) if self.kind == "coco" else (0.0, 0.0, 1.0)
        cv_args = (base_points, self.cuboid_side, self.volume_size,
                   rotation_thetas, axis, self.transfer_cmu_to_human36m)
        coord_volumes = vol_ops.build_coord_volumes(*cv_args)

        features = self.process_features(features).permute(0, 2, 3, 1)
        features = features.reshape((b, v) + features.shape[1:]).contiguous()

        if self.use_kernels:
            volumes = unproject_heatmaps_affine(
                features, proj_hm, vol_ops.coord_volume_affine(*cv_args),
                self.volume_size,
                volume_aggregation_method=self.volume_aggregation_method,
                vol_confidences=vol_conf, view_mask=view_mask,
                channels_last=True)
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
