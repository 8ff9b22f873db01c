"""Synthetic multi-view dataset: Gaussian-joint renderings via known cameras.

The port's own copy of ``lt_tpu/data/synthetic.py`` (numpy only; ``lt_tpu``
imports JAX, so the port cannot import it).  Each sample is a random
skeleton of ``num_joints`` 3D points inside a cuboid around a random
pelvis; every camera view renders each joint as a coloured Gaussian blob
(one colour per joint, so a backbone can tell them apart).  Ground-truth
keypoints and exact projection matrices come in the sample schema of the
Human3.6M dataset.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lt_tpu_torch.utils import img as img_utils


def _look_at_camera(center: np.ndarray, focal: float, image_size: int,
                    target: Optional[np.ndarray] = None):
    """R, t, K for a camera at ``center`` looking at ``target`` (origin by
    default)."""
    direction = center if target is None else center - target
    z = -direction / np.linalg.norm(direction)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0).astype(np.float32)
    t = (-R @ center.reshape(3, 1)).astype(np.float32)
    K = np.array([[focal, 0, image_size / 2],
                  [0, focal, image_size / 2],
                  [0, 0, 1]], np.float32)
    return R, t, K


class SyntheticMultiViewDataset:
    """Procedurally generated multi-view pose samples."""

    def __init__(self,
                 n_samples: int = 256,
                 n_views: int = 4,
                 num_joints: int = 17,
                 image_size: int = 128,
                 blob_sigma: float = 4.0,
                 pelvis_joint: int = 6,
                 skeleton_radius: float = 400.0,
                 world_radius: float = 250.0,
                 camera_distance: float = 4000.0,
                 norm_image: bool = True,
                 seed: int = 0,
                 sample_offset: int = 0,
                 cache_images: bool = False):
        """``seed`` fixes the VISUAL DOMAIN (camera ring + joint colors) —
        train and val splits must share it or generalization is impossible
        by construction (a val split with different colors/cameras is a
        different task, not held-out data).  ``sample_offset`` disjoints
        the splits' pose streams: sample i draws its skeleton from
        ``seed*100003 + sample_offset + i``."""
        self.n_samples = n_samples
        self.sample_offset = sample_offset
        self.n_views = n_views
        self.num_joints = num_joints
        self.image_size = image_size
        self.blob_sigma = blob_sigma
        self.pelvis_joint = min(pelvis_joint, num_joints - 1)
        self.skeleton_radius = skeleton_radius
        self.world_radius = world_radius
        self.norm_image = norm_image
        self.seed = seed
        # Rendering dominates epoch time once train steps are on-device
        # (~20 ms/image on host); samples are deterministic in idx, so an
        # in-memory cache makes re-epochs free (256 samples x 4 views at
        # 128^2 uint8 = 50 MB).
        self._image_cache: Optional[dict] = {} if cache_images else None

        rng = np.random.RandomState(seed)
        # Fixed camera ring (shared across samples, like a capture studio),
        # AIMED AT THE PELVIS-DISTRIBUTION CENTER (0, 0, pelvis-z mean) and
        # zoomed so the skeleton fills the frame.  The r4 geometry looked at
        # the origin with the frame sized to ±(skeleton+world) extent: the
        # skeleton spanned only ~38 px of a 128 px frame and, under
        # winner-takes-pixel compositing, 2.5% of joints were HIDDEN (their
        # blob never won a pixel near the true projection) — a measured 3D
        # floor of 78 mm that capped volumetric training at ~380 mm
        # (ROADMAP.md round 5).  Aiming at the pelvis center with
        # margin 0.9 puts the skeleton at ~67 px span, 0.1% hidden joints,
        # 3D floor 5.1 mm (probe: 24 samples x 4 views, color-matched
        # argmax detector + DLT).
        self.look_target = np.array([0.0, 0.0, 1000.0])
        self.cameras = []
        for i in range(n_views):
            angle = 2 * np.pi * i / n_views + rng.uniform(-0.15, 0.15)
            height = rng.uniform(1000.0, 2000.0)
            center = np.array([camera_distance * np.cos(angle),
                               camera_distance * np.sin(angle), height])
            # One ±(skeleton+world) extent maps to 90% of the half-frame.
            extent = skeleton_radius + world_radius
            focal = (image_size / 2.0) * 0.9 * camera_distance / extent
            self.cameras.append(_look_at_camera(center, focal, image_size,
                                                target=self.look_target))

        # Per-joint colors (fixed): joint identity signal for the backbone.
        # Evenly spaced hues at full saturation — random RGB triples from
        # [0.3, 1]^3 gave pairs ~0.35 apart, too close for the net to
        # separate once blobs overlap (measured r4: alg training stalled
        # at pelvis-only MPJPE with the random palette).
        import colorsys

        hues = (np.arange(num_joints) / num_joints
                + rng.uniform(0, 1 / num_joints))
        self.joint_colors = np.array(
            [colorsys.hsv_to_rgb(h % 1.0, 1.0, 1.0) for h in hues],
            np.float32)

    def __len__(self):
        return self.n_samples

    def keypoints_world(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003
                                    + self.sample_offset + idx)
        pelvis = rng.uniform(-self.world_radius, self.world_radius, 3)
        pelvis[2] = rng.uniform(800.0, 1200.0)
        offsets = rng.uniform(-self.skeleton_radius, self.skeleton_radius,
                              (self.num_joints, 3))
        offsets[self.pelvis_joint] = 0.0
        return (pelvis[None] + offsets).astype(np.float32)

    def _render_view(self, keypoints: np.ndarray, view: int) -> np.ndarray:
        R, t, K = self.cameras[view]
        P = K @ np.hstack([R, t])
        homo = np.hstack([keypoints, np.ones((len(keypoints), 1))])
        uvw = homo @ P.T
        uv = uvw[:, :2] / uvw[:, 2:3]

        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        # Winner-takes-pixel compositing: each pixel shows the color of the
        # nearest (strongest) blob.  Additive blending clipped at 255
        # saturated overlapping regions to white, destroying the per-joint
        # color identity exactly where joints crowd (measured r4: with
        # additive+clip the backbone could learn only the cluster center).
        blobs = np.exp(-((xx[None] - uv[:, 0, None, None]) ** 2
                         + (yy[None] - uv[:, 1, None, None]) ** 2)
                       / (2 * self.blob_sigma ** 2))      # (J, s, s)
        winner = blobs.argmax(0)                          # (s, s)
        strength = np.take_along_axis(blobs, winner[None], 0)[0]
        image = strength[..., None] * self.joint_colors[winner]
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        return image

    def _render_views(self, idx: int, keypoints: np.ndarray):
        if self._image_cache is not None and idx in self._image_cache:
            return self._image_cache[idx]
        views = [self._render_view(keypoints, v) for v in range(self.n_views)]
        if self._image_cache is not None:
            self._image_cache[idx] = views
        return views

    def __getitem__(self, idx):
        keypoints = self.keypoints_world(idx)
        sample = {"images": [], "detections": [], "cameras_R": [],
                  "cameras_t": [], "cameras_K": [], "proj_matrices": [],
                  "view_valid": []}
        rendered = self._render_views(idx, keypoints)
        for view in range(self.n_views):
            image = rendered[view]
            if self.norm_image:
                image = img_utils.normalize_image(image)
            R, t, K = self.cameras[view]
            sample["images"].append(image)
            sample["detections"].append(
                np.array([0, 0, self.image_size, self.image_size, 1.0],
                         np.float32))
            sample["cameras_R"].append(R)
            sample["cameras_t"].append(t)
            sample["cameras_K"].append(K)
            sample["proj_matrices"].append(
                (K @ np.hstack([R, t])).astype(np.float32))
            sample["view_valid"].append(True)

        sample["keypoints_3d"] = np.concatenate(
            [keypoints, np.ones((self.num_joints, 1), np.float32)], axis=1)
        sample["indexes"] = idx
        # Pelvis prior for the volumetric model: GT pelvis + small noise.
        rng = np.random.RandomState(idx + 777)
        noise = rng.uniform(-30, 30, (self.num_joints, 3)).astype(np.float32)
        sample["pred_keypoints_3d"] = keypoints + noise
        return sample

    def evaluate(self, keypoints_3d_predicted):
        """MPJPE (absolute + pelvis-relative); same contract as Human36M."""
        gt = np.stack([self.keypoints_world(i) for i in range(len(self))])
        pred = np.asarray(keypoints_3d_predicted)
        if pred.shape != gt.shape:
            raise ValueError(f"expected {gt.shape}, got {pred.shape}")
        per_pose = np.sqrt(((gt - pred) ** 2).sum(2)).mean(1)
        r = self.pelvis_joint
        gt_rel = gt - gt[:, r:r + 1]
        pred_rel = pred - pred[:, r:r + 1]
        per_pose_rel = np.sqrt(((gt_rel - pred_rel) ** 2).sum(2)).mean(1)
        full = {
            "per_pose_error": {"Average": {"Average": float(per_pose.mean())}},
            "per_pose_error_relative": {
                "Average": {"Average": float(per_pose_rel.mean())}},
        }
        return float(per_pose_rel.mean()), full
