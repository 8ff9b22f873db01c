"""Training and evaluation driver: experiment directory, epoch loops,
metrics, checkpoints and resume.

Port of ``lt_tpu/engine/train.py``'s ``run`` for the Human3.6M, CMU
Panoptic and synthetic datasets and the three model families of
``config.model.name`` ('alg', 'vol', 'ransac'; each trains, as in
``lt_tpu``): per-step ``train``, per-batch ``val_batch`` and per-epoch
``val_epoch`` records in ``metrics.jsonl``, the dataset's evaluation in
``metric.json``, a full train-state checkpoint per epoch under
``checkpoints/{epoch:04d}`` and ``--resume``.  Weights start from a
reference ``.pth`` (whole-model or backbone), an ``lt_tpu`` ``.npz``
fixture or one of the port's checkpoint directories
(:func:`init_model_state`).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from collections import defaultdict
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from lt_tpu_torch import resolve_device
from lt_tpu_torch.data.batch import BatchIterator, prepare_batch
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory
from lt_tpu_torch.engine.steps import eval_step, train_step
from lt_tpu_torch.utils import cfg as cfg_lib
from lt_tpu_torch.utils import weights


def setup_experiment(config_path: str, logdir: str, title: str,
                     model_name: str, is_train: bool = True) -> str:
    """Create ``logdir/[eval_]<title>_<model_name>@<time>`` (the model's
    class name) with a ``checkpoints/`` directory and a copy of the
    config."""
    name = "{}{}{}@{}".format(
        "" if is_train else "eval_", f"{title}_" if title else "",
        model_name, datetime.now().strftime("%d.%m.%Y-%H.%M.%S"))
    experiment_dir = os.path.join(logdir, name)
    os.makedirs(os.path.join(experiment_dir, "checkpoints"), exist_ok=True)
    if config_path and os.path.isfile(config_path):
        shutil.copy(config_path, os.path.join(experiment_dir, "config.yaml"))
    return experiment_dir


class MetricLogger:
    """JSON-lines scalar log: one ``{"tag", "step", ...}`` record a line."""

    def __init__(self, experiment_dir: str):
        self.file = open(os.path.join(experiment_dir, "metrics.jsonl"), "a")

    def log(self, tag: str, scalars: dict, step: int) -> None:
        record = {"tag": tag, "step": step,
                  **{k: float(v) for k, v in scalars.items()}}
        self.file.write(json.dumps(record) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


def make_datasets(config, is_train: bool = True):
    """(train, val) datasets of ``dataset.kind``: 'human36m', 'cmu' /
    'cmu_panoptic' or 'synthetic', with ``lt_tpu``'s config keys and
    defaults.  The synthetic splits share the visual domain (seed 0) and
    draw disjoint poses (``sample_offset``)."""
    kind = config.dataset.kind
    image_shape = config.get("image_shape", (256, 256))
    if kind == "human36m":
        from lt_tpu_torch.data.human36m import Human36MMultiViewDataset

        def build(split_cfg, train):
            return Human36MMultiViewDataset(
                h36m_root=split_cfg.h36m_root,
                labels_path=split_cfg.labels_path,
                pred_results_path=split_cfg.get("pred_results_path"),
                image_shape=image_shape, train=train, test=not train,
                retain_every_n_frames_in_test=split_cfg.get(
                    "retain_every_n_frames_in_test", 1),
                with_damaged_actions=split_cfg.get("with_damaged_actions",
                                                   False),
                scale_bbox=split_cfg.get("scale_bbox", 1.5),
                kind=config.kind,
                undistort_images=split_cfg.get("undistort_images", False),
                ignore_cameras=split_cfg.get("ignore_cameras", ()),
                crop=split_cfg.get("crop", True))
    elif kind in ("cmu", "cmu_panoptic"):
        from lt_tpu_torch.data.cmu_panoptic import CMUPanopticMultiViewDataset

        def build(split_cfg, train):
            return CMUPanopticMultiViewDataset(
                panoptic_root=split_cfg.panoptic_root,
                sequences=split_cfg.sequences,
                camera_names=split_cfg.get("camera_names"),
                n_views=config.dataset.get("n_views", 4),
                train=train, test=not train,
                retain_every_n_frames=split_cfg.get("retain_every_n_frames",
                                                    1),
                image_shape=image_shape,
                scale_bbox=split_cfg.get("scale_bbox", 1.2),
                crop=split_cfg.get("crop", True))
    elif kind == "synthetic":
        from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset

        def build(split_cfg, train):
            return SyntheticMultiViewDataset(
                n_samples=split_cfg.get("n_samples", 128),
                n_views=config.dataset.get("n_views", 4),
                num_joints=config.model.backbone.num_joints,
                image_size=config.get("image_shape", (128, 128))[0],
                seed=0, sample_offset=0 if train else 1_000_000,
                cache_images=split_cfg.get("cache_images", True))
    else:
        raise NotImplementedError(f"Unknown dataset kind: {kind}")
    train_ds = build(config.dataset.train, True) if is_train else None
    return train_ds, build(config.dataset.val, False)


def make_iterator(dataset, split_cfg, batch_size: int, seed: int,
                  train: bool) -> BatchIterator:
    """The split's iterator: training shuffles (``shuffle``, default on),
    drops the ragged tail and masks views (``randomize_n_views``,
    ``min_n_views``, ``max_n_views``); evaluation keeps the order and the
    tail.  ``num_workers`` sizes the loading pool of a dataset that reads
    files (default 8)."""
    workers = split_cfg.get("num_workers") or 8
    if not train:
        return BatchIterator(dataset, batch_size, shuffle=False,
                             drop_last=False, seed=seed, num_workers=workers)
    return BatchIterator(
        dataset, batch_size, shuffle=split_cfg.get("shuffle", True),
        seed=seed, randomize_n_views=split_cfg.get("randomize_n_views",
                                                   False),
        min_n_views=split_cfg.get("min_n_views"),
        max_n_views=split_cfg.get("max_n_views"), num_workers=workers)


def _load_matching(model: torch.nn.Module, src: dict) -> int:
    """Copy the entries of ``src`` whose name and shape match the model's
    state_dict; the rest keeps its fresh init.  Returns the count."""
    state = model.state_dict()
    matching = {k: v for k, v in src.items()
                if k in state and state[k].shape == v.shape}
    state.update(matching)
    model.load_state_dict(state)
    return len(matching)


_WHOLE_MODEL = {"alg": weights.algebraic_state_dict,
                "ransac": weights.ransac_state_dict,
                "vol": weights.volumetric_state_dict}


def init_model_state(config, model: torch.nn.Module) -> dict:
    """Load the configured weights into ``model``, each where its
    ``init_weights`` is set, and report what was loaded.

    ``model.backbone.checkpoint``: a reference ``.pth`` of the pose
    network, with or without ``backbone.`` in its names (every entry but
    the confidence heads required, the final layer adapted to the joint
    count); or an ``lt_tpu`` ``.npz`` fixture or one of the port's
    experiment or checkpoint directories, merged where names and shapes
    match.  Then ``model.checkpoint``: a reference whole-model ``.pth``
    (every entry of the model required with its shape) or an ``lt_tpu``
    ``.npz`` of the configured family, merged where names and shapes
    match.  A directory there is a train state, which :func:`run`
    restores with its optimizer and step.

    Returns ``{"backbone": ..., "model": ...}``: for each source loaded,
    its path, the tensors loaded and the names it had that the model has
    not (``unused``)."""
    report = {}
    bb = config.model.backbone
    if bb.get("init_weights") and bb.get("checkpoint"):
        path = bb.checkpoint
        if path.endswith(".pth"):
            unused = weights.load_backbone_pth(model, weights.load_pth(path),
                                               bb.num_joints)
            n = len(model.backbone.state_dict())
        else:
            if path.endswith(".npz"):
                src = weights.backbone_state_dict(
                    weights.load_npz_variables(path), bb.num_layers)
            else:
                state = ckpt.load_model_state(ckpt.resolve_checkpoint_dir(
                    path))
                src = {k: v for k, v in state.items()
                       if k.startswith("backbone.")}
            n = _load_matching(model, src)
            unused = []
        report["backbone"] = {"path": path, "loaded": n, "unused": unused}
    path = config.model.get("checkpoint")
    if config.model.get("init_weights") and path:
        if path.endswith(".pth"):
            unused = weights.load_strict(model, weights.load_pth(path),
                                         f"model weights {path}")
            report["model"] = {"path": path, "unused": unused,
                               "loaded": len(model.state_dict())}
        elif path.endswith(".npz"):
            n = _load_matching(model, _WHOLE_MODEL[config.model.name](
                weights.load_npz_variables(path), bb.num_layers))
            report["model"] = {"path": path, "loaded": n, "unused": []}
    return report


def device_batch(batch: dict, device, pad_to: Optional[int] = None):
    """A collated numpy batch -> the step's dict of tensors on ``device``,
    and the count of real samples.  ``pad_to`` repeats the last sample up
    to that size with zero keypoint validity, so that the padding counts
    for nothing in any loss or metric."""
    images, kp_gt, validity, proj, view_mask = prepare_batch(batch)
    out = {"images": images,
           "keypoints_3d": np.concatenate([kp_gt, validity], -1),
           "keypoints_validity": validity, "proj_matrices": proj,
           "view_mask": view_mask}
    if "pred_keypoints_3d" in batch:
        out["pred_keypoints_3d"] = np.asarray(batch["pred_keypoints_3d"])
    n_real = int(images.shape[0])
    if pad_to is not None and n_real < pad_to:
        pad = pad_to - n_real
        out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
               for k, v in out.items()}
        out["keypoints_validity"][n_real:] = 0.0
        out["keypoints_3d"][n_real:, :, 3:] = 0.0
    return ({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device) for k, v in out.items()}, n_real)


def train_epoch(model, optimizer, criterion, config, iterator, epoch: int,
                generator: torch.Generator, logger: MetricLogger,
                n_iters_total: int, device) -> int:
    """One training epoch; returns the updated step count."""
    n_iters = config.opt.get("n_iters_per_epoch")
    end = time.time()
    for i, batch in enumerate(iterator.epoch(epoch)):
        if n_iters is not None and i >= n_iters:
            break
        data_time = time.time() - end
        tensors, _ = device_batch(batch, device)
        metrics = train_step(model, optimizer, criterion, config, tensors,
                             generator)
        logger.log("train", {**metrics, "batch_time": time.time() - end,
                             "data_time": data_time,
                             "batch_size": batch["images"].shape[0],
                             "n_views": batch["images"].shape[1]},
                   n_iters_total)
        end = time.time()
        n_iters_total += 1
    _print_fallbacks(iterator.dataset)
    return n_iters_total


def eval_epoch(model, criterion, config, iterator, dataset, epoch: int,
               experiment_dir: str, logger: MetricLogger, device):
    """One eval pass over ``iterator``: the dataset's evaluation of the
    predictions in the dataset's order (``_partial_evaluate`` where the
    pass covers a subset), the per-batch metrics weighted by real samples,
    and ``results.pkl`` / ``metric.json`` under ``checkpoints/{epoch:04d}``.
    Each batch's ``data_time`` (waiting on the loader) and ``batch_time``
    go to ``metrics.jsonl`` as a ``val_batch`` record.  Where the
    evaluation fails it prints why and carries on with a metric of 0 and
    an empty ``metric.json``, as the reference does."""
    results = defaultdict(list)
    metric_means = defaultdict(list)
    end = time.time()
    for batch in iterator.epoch(0):
        data_time = time.time() - end
        tensors, n_real = device_batch(batch, device,
                                       pad_to=iterator.batch_size)
        keypoints, metrics = eval_step(model, criterion, config, tensors)
        results["keypoints_3d"].append(keypoints.cpu().numpy()[:n_real])
        results["indexes"].append(np.asarray(batch["indexes"]))
        for k, v in metrics.items():
            metric_means[k].append((v, n_real))
        logger.log("val_batch", {"data_time": data_time,
                                 "batch_time": time.time() - end,
                                 "batch_size": n_real}, epoch)
        end = time.time()
    results = {k: np.concatenate(v) for k, v in results.items()}
    _print_fallbacks(dataset)

    scalar, full = 0.0, {}
    try:
        order = np.argsort(results["indexes"])
        preds = results["keypoints_3d"][order]
        if len(preds) == len(dataset):
            scalar, full = dataset.evaluate(preds)
        else:
            scalar, full = _partial_evaluate(
                dataset, preds, results["indexes"][order],
                kind=config.get("kind", "human36m"))
    except Exception as e:  # the reference's behaviour (train.py:342-346)
        print("Failed to evaluate. Reason:", e)

    checkpoint_dir = os.path.join(experiment_dir, "checkpoints",
                                  f"{epoch:04}")
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "results.pkl"), "wb") as f:
        pickle.dump(results, f)
    with open(os.path.join(checkpoint_dir, "metric.json"), "w") as f:
        json.dump(full, f, indent=4, sort_keys=True, default=float)
    epoch_metrics = {k: float(np.average([x for x, _ in v],
                                         weights=[w for _, w in v]))
                     for k, v in metric_means.items()}
    epoch_metrics["dataset_metric"] = scalar
    logger.log("val_epoch", epoch_metrics, epoch)
    return scalar, full


def _partial_evaluate(dataset, preds, indexes, kind: str = "human36m"):
    """MPJPE over a subset of the dataset's samples, absolute and relative
    to the root joint of ``kind`` ('coco': the hips' midpoint; 'cmu': joint
    2; else joint 6).  The ground truth comes from
    ``dataset.keypoints_world``, so that no image is decoded again."""
    gt = np.stack([dataset.keypoints_world(int(i)) for i in indexes])
    per_pose = np.sqrt(((gt - preds) ** 2).sum(2)).mean(1)
    if kind == "coco":
        gt_root = (gt[:, 11:12] + gt[:, 12:13]) / 2.0
        pr_root = (preds[:, 11:12] + preds[:, 12:13]) / 2.0
    elif kind == "cmu":
        gt_root, pr_root = gt[:, 2:3], preds[:, 2:3]
    else:
        gt_root, pr_root = gt[:, 6:7], preds[:, 6:7]
    per_pose_rel = np.sqrt((((gt - gt_root) - (preds - pr_root)) ** 2)
                           .sum(2)).mean(1)
    scalar = float(per_pose_rel.mean())
    return scalar, {"per_pose_error": {"Average": {
        "Average": float(per_pose.mean())}},
        "per_pose_error_relative": {"Average": {"Average": scalar}}}


def _print_fallbacks(dataset) -> None:
    if getattr(dataset, "native_batches", False):
        print(f"loader: {dataset.fallbacks} JPEGs the native batch call "
              f"could not decode were read with cv2")


def run(config_path: str, logdir: str, eval_only: bool = False,
        eval_dataset: str = "val", seed: int = 42,
        max_epochs: Optional[int] = None, resume_dir: Optional[str] = None,
        overrides: Optional[dict] = None, device="cuda") -> float:
    """Train (or, with ``eval_only``, evaluate) the configured model on
    ``device``; returns the last validation metric (rel MPJPE, mm)."""
    dev = resolve_device(device)
    config = cfg_lib.load_config(config_path, overrides)
    if config.opt.get("n_objects_per_epoch") is not None:
        config.opt.n_iters_per_epoch = (config.opt.n_objects_per_epoch
                                        // config.opt.batch_size)

    model = factory.make_model(config, device=dev, seed=seed)
    for part, r in init_model_state(config, model).items():
        print(f"Loaded {part} weights from {r['path']}: {r['loaded']} "
              f"tensors, {len(r['unused'])} of its entries unused")
    criterion = factory.make_criterion(config)
    optimizer = factory.make_optimizer(config, model)
    generator = torch.Generator().manual_seed(seed + 1)

    need_train = (not eval_only) or eval_dataset == "train"
    train_ds, val_ds = make_datasets(config, is_train=need_train)
    decoder = getattr(val_ds, "decoder", None)
    if decoder:
        print(f"Image decoder: {decoder}")
    train_it = None
    if train_ds is not None:
        train_it = make_iterator(train_ds, config.dataset.train,
                                 config.opt.batch_size, seed, train=True)
    val_it = make_iterator(val_ds, config.dataset.val,
                           config.opt.get("val_batch_size",
                                          config.opt.batch_size),
                           seed, train=False)

    step, start_epoch = 0, 0
    path = config.model.get("checkpoint")
    if (config.model.get("init_weights") and path
            and not path.endswith((".pth", ".npz"))):
        latest = ckpt.resolve_checkpoint_dir(path)
        step = ckpt.restore_checkpoint(latest, model, optimizer, generator)
        print(f"Restored the train state of {latest} (step {step})")
    if resume_dir:
        latest = ckpt.resolve_checkpoint_dir(resume_dir)
        step = ckpt.restore_checkpoint(latest, model, optimizer, generator)
        start_epoch = int(os.path.basename(latest)) + 1
        print(f"Resumed from {latest} (epoch {start_epoch}, step {step})")

    experiment_dir = setup_experiment(config_path, logdir,
                                      config.get("title", ""),
                                      type(model).__name__,
                                      is_train=not eval_only)
    logger = MetricLogger(experiment_dir)
    try:
        if eval_only:
            it, ds = ((train_it, train_ds) if eval_dataset == "train"
                      else (val_it, val_ds))
            scalar, _ = eval_epoch(model, criterion, config, it, ds, 0,
                                   experiment_dir, logger, dev)
            print(f"Eval metric (MPJPE rel, mm): {scalar:.3f}")
            return scalar
        n_epochs = config.opt.n_epochs if max_epochs is None else min(
            config.opt.n_epochs, max_epochs)
        scalar = None
        for epoch in range(start_epoch, n_epochs):
            step = train_epoch(model, optimizer, criterion, config, train_it,
                               epoch, generator, logger, step, dev)
            scalar, _ = eval_epoch(model, criterion, config, val_it, val_ds,
                                   epoch, experiment_dir, logger, dev)
            ckpt.save_checkpoint(os.path.join(
                experiment_dir, "checkpoints", f"{epoch:04}"), model,
                optimizer, step, generator)
            print(f"epoch {epoch}: val MPJPE rel = {scalar:.3f} mm")
        return scalar
    finally:
        logger.close()
