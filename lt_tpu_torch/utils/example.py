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
