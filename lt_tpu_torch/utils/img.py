"""Host-side image utilities: reading, bbox math, crop / resize and
ImageNet normalization (the port's own copy of ``lt_tpu/utils/img.py``,
numpy only).

``resize_image`` is cv2's INTER_AREA, as in ``lt_tpu``, and PIL's
bilinear resize where cv2 is absent; :func:`read_image` is ``cv2.imread``
(BGR, uint8).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - depends on the environment
    cv2 = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop_image(image: np.ndarray, bbox) -> np.ndarray:
    """Crop (left, upper, right, lower); parts outside the image are zeros
    (PIL crop semantics: the output always has the bbox's size)."""
    left, upper, right, lower = (int(v) for v in bbox)
    out = np.zeros((lower - upper, right - left) + image.shape[2:],
                   image.dtype)
    y0, y1 = max(0, upper), min(image.shape[0], lower)
    x0, x1 = max(0, left), min(image.shape[1], right)
    if y1 > y0 and x1 > x0:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = image[y0:y1, x0:x1]
    return out


def resize_image(image: np.ndarray, shape) -> np.ndarray:
    """Resize to (height, width): cv2 INTER_AREA, as ``lt_tpu``; PIL's
    bilinear where cv2 is absent."""
    if cv2 is not None:
        return cv2.resize(image, (shape[1], shape[0]),
                          interpolation=cv2.INTER_AREA)
    from PIL import Image

    return np.asarray(Image.fromarray(image).resize((shape[1], shape[0]),
                                                    Image.BILINEAR))


def get_square_bbox(bbox):
    """Stretch the shorter side about the centre to make the bbox square."""
    left, upper, right, lower = bbox
    width, height = right - left, lower - upper
    if width > height:
        y_center = (upper + lower) // 2
        upper = y_center - width // 2
        lower = upper + width
    else:
        x_center = (left + right) // 2
        left = x_center - height // 2
        right = left + height
    return left, upper, right, lower


def scale_bbox(bbox, scale: float):
    """Scale a bbox about its centre, rounding to integers as the
    reference does."""
    left, upper, right, lower = bbox
    width, height = right - left, lower - upper
    x_center, y_center = (right + left) // 2, (lower + upper) // 2
    new_width, new_height = int(scale * width), int(scale * height)
    new_left = x_center - new_width // 2
    new_upper = y_center - new_height // 2
    return new_left, new_upper, new_left + new_width, new_upper + new_height


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> ImageNet-normalized float32."""
    return ((image / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """Inverse of :func:`normalize_image`, clipped to [0, 255]."""
    return np.clip(255.0 * (image * IMAGENET_STD + IMAGENET_MEAN), 0, 255)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) BGR uint8 with ``cv2.imread``, as ``lt_tpu`` reads its
    frames; raises where the file cannot be read."""
    if cv2 is None:
        raise RuntimeError(f"cannot read {path}: cv2 is not installed")
    image = cv2.imread(path)
    if image is None:
        raise ValueError(f"cv2 could not read {path}")
    return image
