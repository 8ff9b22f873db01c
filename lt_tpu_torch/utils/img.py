"""ImageNet normalization of uint8 images (the port's own copy of
``lt_tpu/utils/img.py:normalize_image``)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> ImageNet-normalized float32."""
    return ((image / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
