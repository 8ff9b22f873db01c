"""Training and evaluation driver: experiment directory, epoch loops,
metrics, checkpoints and resume.

Port of ``lt_tpu/engine/train.py``'s ``run`` for the synthetic dataset
(Human3.6M and CMU data are not in the repository) and the three model
families of ``config.model.name`` ('alg', 'vol', 'ransac'; each trains, as
in ``lt_tpu``): per-step ``train`` and per-epoch ``val_epoch`` records in
``metrics.jsonl``, a full train-state checkpoint per epoch under
``checkpoints/{epoch:04d}`` and ``--resume``.  Weights can start from an
``lt_tpu`` ``.npz`` fixture, whole-model or backbone-only, merged where
names and shapes match.
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
    """(train, val) synthetic datasets; both share the visual domain
    (seed 0) and draw disjoint poses (``sample_offset``)."""
    if config.dataset.kind != "synthetic":
        raise NotImplementedError(
            f"the port reads the synthetic dataset only, not "
            f"{config.dataset.kind!r}")
    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset

    def build(split_cfg, sample_offset):
        return SyntheticMultiViewDataset(
            n_samples=split_cfg.get("n_samples", 128),
            n_views=config.dataset.get("n_views", 4),
            num_joints=config.model.backbone.num_joints,
            image_size=config.get("image_shape", (128, 128))[0],
            seed=0, sample_offset=sample_offset,
            cache_images=split_cfg.get("cache_images", True))

    train_ds = build(config.dataset.train, 0) if is_train else None
    return train_ds, build(config.dataset.val, 1_000_000)


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


def init_model_state(config, model: torch.nn.Module) -> None:
    """Load the configured ``.npz`` weights into ``model``: the backbone
    fixture of ``model.backbone.checkpoint``, then the whole-model fixture
    of ``model.checkpoint`` (an ``lt_tpu`` model of the configured
    family), each where its ``init_weights`` is set."""
    bb = config.model.backbone
    layers = bb.num_layers
    if bb.get("init_weights") and bb.get("checkpoint"):
        if not bb.checkpoint.endswith(".npz"):
            raise NotImplementedError(f"backbone weights from .npz only: "
                                      f"{bb.checkpoint}")
        _load_matching(model, weights.backbone_state_dict(
            weights.load_npz_variables(bb.checkpoint), layers))
    path = config.model.get("checkpoint")
    if config.model.get("init_weights") and path:
        if not path.endswith(".npz"):
            raise NotImplementedError(f"model weights from .npz only: {path}")
        _load_matching(model, _WHOLE_MODEL[config.model.name](
            weights.load_npz_variables(path), layers))


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
    return n_iters_total


def eval_epoch(model, criterion, config, iterator, dataset, epoch: int,
               experiment_dir: str, logger: MetricLogger, device):
    """One eval pass over ``iterator``: the dataset's MPJPE, the per-batch
    metrics weighted by real samples, and ``results.pkl`` /
    ``metric.json`` under ``checkpoints/{epoch:04d}``."""
    results = defaultdict(list)
    metric_means = defaultdict(list)
    for batch in iterator.epoch(0):
        tensors, n_real = device_batch(batch, device,
                                       pad_to=iterator.batch_size)
        keypoints, metrics = eval_step(model, criterion, config, tensors)
        results["keypoints_3d"].append(keypoints.cpu().numpy()[:n_real])
        results["indexes"].append(np.asarray(batch["indexes"]))
        for k, v in metrics.items():
            metric_means[k].append((v, n_real))
    results = {k: np.concatenate(v) for k, v in results.items()}
    order = np.argsort(results["indexes"])
    scalar, full = dataset.evaluate(results["keypoints_3d"][order])

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
    init_model_state(config, model)
    criterion = factory.make_criterion(config)
    optimizer = factory.make_optimizer(config, model)
    generator = torch.Generator().manual_seed(seed + 1)

    need_train = (not eval_only) or eval_dataset == "train"
    train_ds, val_ds = make_datasets(config, is_train=need_train)
    train_it = None
    if train_ds is not None:
        tcfg = config.dataset.train
        train_it = BatchIterator(
            train_ds, config.opt.batch_size, shuffle=tcfg.get("shuffle", True),
            seed=seed, randomize_n_views=tcfg.get("randomize_n_views", False),
            min_n_views=tcfg.get("min_n_views"),
            max_n_views=tcfg.get("max_n_views"))
    val_it = BatchIterator(val_ds,
                           config.opt.get("val_batch_size",
                                          config.opt.batch_size),
                           shuffle=False, drop_last=False, seed=seed)

    step, start_epoch = 0, 0
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
