"""Batching: static-shape collate with view masks, and a batch iterator.

The port's own copy of ``lt_tpu/data/batch.py`` (numpy only).  The view
axis keeps its full length and a ``view_mask`` (B, V) marks missing views
(zero images, excluded from the aggregation).  :class:`BatchIterator`
shuffles with ``RandomState(seed + epoch)`` and shards as ``lt_tpu``'s
does, so both packages see the same batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
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
    """Shuffled (or ordered) batches of a dataset, one epoch at a time,
    assembled ahead of the consumer.

    ``shard_id`` / ``num_shards`` take every ``num_shards``-th sample of
    the epoch's order, from ``shard_id`` (one shard a process).
    ``prefetch > 0`` assembles up to that many batches ahead on a worker
    thread, so that decoding overlaps the device's work.  A dataset whose
    ``native_batches`` is true (Human3.6M with the native pipeline) loads
    a batch in one ``get_batch(idxs)`` call; an ``io_bound`` dataset's
    samples load on a pool of ``num_workers`` threads; any other
    dataset's on the calling thread.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 randomize_n_views: bool = False,
                 min_n_views: Optional[int] = None,
                 max_n_views: Optional[int] = None,
                 prefetch: int = 2, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.randomize_n_views = randomize_n_views
        self.min_n_views = min_n_views
        self.max_n_views = max_n_views
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs, rng) -> Optional[Dict]:
        if getattr(self.dataset, "native_batches", False):
            items = self.dataset.get_batch(idxs)
        elif (self.num_workers > 1 and len(idxs) > 1
              and getattr(self.dataset, "io_bound", False)):
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="lt_tpu_torch_loader")
            items = list(self._pool.map(lambda i: self.dataset[int(i)],
                                        idxs))
        else:
            items = [self.dataset[int(i)] for i in idxs]
        return collate(items, self.randomize_n_views, self.min_n_views,
                       self.max_n_views, rng)

    def _epoch_sync(self, epoch: int) -> Iterator[Dict]:
        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_id::self.num_shards]
        n_full = len(order) // self.batch_size
        limit = n_full * self.batch_size if self.drop_last else len(order)
        for start in range(0, limit, self.batch_size):
            out = self._make_batch(order[start:start + self.batch_size], rng)
            if out is not None:
                yield out

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        """One epoch of batches; ``epoch`` reseeds the shuffle."""
        if self.prefetch <= 0:
            yield from self._epoch_sync(epoch)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self._epoch_sync(epoch):
                    if stop.is_set():
                        return
                    q.put(batch)
                q.put(end)
            except BaseException as e:  # raised again on the consumer side
                q.put(e)

        worker = threading.Thread(target=producer, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # A consumer that stops early (n_iters_per_epoch) stops the
            # producer, which may be blocked on a full queue: drain it.
            stop.set()
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
