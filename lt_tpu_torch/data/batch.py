"""Batching: static-shape collate with view masks, and a batch iterator.

The port's own copy of ``lt_tpu/data/batch.py`` (numpy only).  The view
axis keeps its full length and a ``view_mask`` (B, V) marks missing views
(zero images, excluded from the aggregation).  :class:`BatchIterator`
shuffles with ``RandomState(seed + epoch)`` as ``lt_tpu``'s does, so both
packages see the same batches; it loads on the calling thread.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np


def collate(items: Sequence[dict],
            randomize_n_views: bool = False,
            min_n_views: Optional[int] = None,
            max_n_views: Optional[int] = None,
            rng: Optional[np.random.RandomState] = None) -> Optional[Dict]:
    """Stack samples into fixed (B, V, ...) arrays with a view mask."""
    items = [it for it in items if it is not None]
    if not items:
        return None
    rng = rng or np.random

    n_views = len(items[0]["view_valid"])
    image_shape = next(im.shape for it in items for im in it["images"]
                       if im is not None)

    batch: Dict[str, np.ndarray] = {}
    images = np.zeros((len(items), n_views) + image_shape, np.float32)
    view_mask = np.zeros((len(items), n_views), np.float32)
    for bi, it in enumerate(items):
        for vi in range(n_views):
            if it["view_valid"][vi] and it["images"][vi] is not None:
                images[bi, vi] = it["images"][vi]
                view_mask[bi, vi] = 1.0

    if randomize_n_views:
        lo = min_n_views or 1
        hi = min(max_n_views or n_views, n_views)
        keep = rng.randint(lo, hi + 1)
        chosen = rng.choice(np.arange(n_views), size=keep, replace=False)
        submask = np.zeros((n_views,), np.float32)
        submask[chosen] = 1.0
        view_mask = view_mask * submask[None]
        images = images * view_mask[:, :, None, None, None]

    batch["images"] = images
    batch["view_mask"] = view_mask
    batch["detections"] = np.stack(
        [np.stack(it["detections"]) for it in items])
    batch["proj_matrices"] = np.stack(
        [np.stack(it["proj_matrices"]) for it in items])
    batch["cameras_R"] = np.stack([np.stack(it["cameras_R"]) for it in items])
    batch["cameras_t"] = np.stack([np.stack(it["cameras_t"]) for it in items])
    batch["cameras_K"] = np.stack([np.stack(it["cameras_K"]) for it in items])
    batch["keypoints_3d"] = np.stack([it["keypoints_3d"] for it in items])
    batch["indexes"] = np.array([it["indexes"] for it in items])
    if "pred_keypoints_3d" in items[0]:
        batch["pred_keypoints_3d"] = np.stack(
            [it["pred_keypoints_3d"] for it in items])
    return batch


def prepare_batch(batch: Dict[str, np.ndarray]):
    """Split a collated batch into model inputs (prepare_batch parity).

    Returns (images, keypoints_3d_gt, keypoints_validity, proj_matrices,
    view_mask); all numpy, ready for jnp.asarray / device_put.
    """
    images = batch["images"]
    kp = batch["keypoints_3d"]
    return (images, kp[:, :, :3], kp[:, :, 3:], batch["proj_matrices"],
            batch["view_mask"])


class BatchIterator:
    """Shuffled (or ordered) batches of a dataset, one epoch at a time."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 randomize_n_views: bool = False,
                 min_n_views: Optional[int] = None,
                 max_n_views: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.randomize_n_views = randomize_n_views
        self.min_n_views = min_n_views
        self.max_n_views = max_n_views

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        """One epoch of batches; ``epoch`` reseeds the shuffle."""
        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        n_full = len(order) // self.batch_size
        limit = n_full * self.batch_size if self.drop_last else len(order)
        for start in range(0, limit, self.batch_size):
            items = [self.dataset[int(i)]
                     for i in order[start:start + self.batch_size]]
            out = collate(items, self.randomize_n_views, self.min_n_views,
                          self.max_n_views, rng)
            if out is not None:
                yield out
