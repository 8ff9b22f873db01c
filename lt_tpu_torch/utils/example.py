"""Seeded example inputs for the volumetric model (smoke runs, profiling)."""

from __future__ import annotations

import numpy as np


def example_batch(batch_size, n_views, image_size, num_joints, seed=0):
    """Random images (B, V, S, S, 3), a ring of cameras 4 m out aimed at
    the origin (B, V, 3, 4) in image pixels, and keypoints (B, J, 3) within
    0.4 m of it: the construction of the JAX package's example batch."""
    rng = np.random.RandomState(seed)
    images = rng.randn(batch_size, n_views, image_size, image_size, 3)
    proj = np.zeros((batch_size, n_views, 3, 4), np.float32)
    for v in range(n_views):
        angle = 2 * np.pi * v / n_views
        center = np.array([4000 * np.cos(angle), 4000 * np.sin(angle),
                           1500.0])
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z])
        t = -rot @ center.reshape(3, 1)
        k = np.array([[image_size * 1.2, 0, image_size / 2],
                      [0, image_size * 1.2, image_size / 2], [0, 0, 1.0]])
        proj[:, v] = k @ np.hstack([rot, t])
    keypoints = rng.uniform(-400, 400, (batch_size, num_joints, 3))
    return (images.astype(np.float32), proj,
            keypoints.astype(np.float32))


def example_train_batch(batch_size, image_size, num_joints, n_views=4,
                        seed=0):
    """A training batch dict (numpy) on :func:`example_batch`'s rig: ground
    truth with full validity, a pelvis prior 30 mm off it, all views valid
    and seeded cuboid rotations, as ``engine.steps.train_step`` takes it."""
    images, proj, kp = example_batch(batch_size, n_views, image_size,
                                     num_joints, seed=seed)
    rng = np.random.RandomState(seed + 1)
    ones = np.ones_like(kp[..., :1])
    return {"images": images, "proj_matrices": proj,
            "keypoints_3d": np.concatenate([kp, ones], -1),
            "keypoints_validity": ones,
            "view_mask": np.ones((batch_size, n_views), np.float32),
            "pred_keypoints_3d": (kp + rng.uniform(-30, 30, kp.shape)).astype(
                np.float32),
            "rotation_thetas": rng.uniform(0, 2 * np.pi, batch_size).astype(
                np.float32)}
