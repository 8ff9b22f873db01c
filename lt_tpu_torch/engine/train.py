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

Under ``torchrun`` (``lt_tpu_torch.parallel``) the run is data parallel
as ``lt_tpu``'s mesh is: ``opt.batch_size`` is the global batch, each rank
loads, trains on and evaluates its rows of it, and the master writes.
Besides ``metrics.jsonl`` the master's scalars go to a tensorboard writer
under ``tb/`` (where tensorboardX imports), with the config's text and,
every ``vis_freq`` training steps, the keypoint, heatmap and volume panels
and the parameters' histograms.  ``debug_nans: true`` runs under autograd's
anomaly mode and refuses a step with a non-finite loss or gradient norm;
``profile_dir`` holds a ``torch.profiler`` trace of the first epoch's
training steps.
"""

from __future__ import annotations

import contextlib
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
from lt_tpu_torch.engine.steps import eval_step, train_step, vis_step
from lt_tpu_torch.parallel import mesh
from lt_tpu_torch.utils import cfg as cfg_lib
from lt_tpu_torch.utils import weights


def setup_experiment(config, config_path: str, logdir: str,
                     model_name: str, is_train: bool = True):
    """Create ``logdir/[eval_]<title>_<model_name>@<time>`` (the model's
    class name) with a ``checkpoints/`` directory and a copy of the
    config; returns it and a tensorboardX writer under its ``tb/`` that
    holds the config's text, or None where tensorboardX does not
    import."""
    title = config.get("title", "")
    name = "{}{}{}@{}".format(
        "" if is_train else "eval_", f"{title}_" if title else "",
        model_name, datetime.now().strftime("%d.%m.%Y-%H.%M.%S"))
    experiment_dir = os.path.join(logdir, name)
    os.makedirs(os.path.join(experiment_dir, "checkpoints"), exist_ok=True)
    if config_path and os.path.isfile(config_path):
        shutil.copy(config_path, os.path.join(experiment_dir, "config.yaml"))
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        print(f"No tensorboard writer: {e}")
        return experiment_dir, None
    writer = SummaryWriter(os.path.join(experiment_dir, "tb"))
    writer.add_text("config", cfg_lib.config_to_str(config), 0)
    return experiment_dir, writer


class MetricLogger:
    """Scalars to ``metrics.jsonl`` (one ``{"tag", "step", ...}`` record a
    line) and, as ``<tag>/<name>``, to a tensorboard ``writer``."""

    def __init__(self, experiment_dir: str, writer=None):
        self.writer = writer
        self.file = open(os.path.join(experiment_dir, "metrics.jsonl"), "a")

    def log(self, tag: str, scalars: dict, step: int) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        if self.writer is not None:
            for name, value in scalars.items():
                self.writer.add_scalar(f"{tag}/{name}", value, step)
        self.file.write(json.dumps({"tag": tag, "step": step, **scalars})
                        + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()
        if self.writer is not None:
            self.writer.close()


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
                  train: bool, rank: int = 0,
                  world_size: int = 1) -> BatchIterator:
    """The split's iterator of global batches of ``batch_size``, of which
    it loads rank ``rank``'s rows: training shuffles (``shuffle``, default
    on), drops the ragged tail and masks views (``randomize_n_views``,
    ``min_n_views``, ``max_n_views``); evaluation keeps the order and pads
    the tail to ``batch_size`` (rows whose ``indexes`` are -1).
    ``num_workers`` sizes the loading pool of a dataset that reads files
    (default 8)."""
    common = dict(seed=seed, num_workers=split_cfg.get("num_workers") or 8,
                  rank=rank, world_size=world_size)
    if not train:
        return BatchIterator(dataset, batch_size, shuffle=False,
                             drop_last=False, pad_last=True, **common)
    return BatchIterator(
        dataset, batch_size, shuffle=split_cfg.get("shuffle", True),
        randomize_n_views=split_cfg.get("randomize_n_views", False),
        min_n_views=split_cfg.get("min_n_views"),
        max_n_views=split_cfg.get("max_n_views"), **common)


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


def device_batch(batch: dict, device):
    """A collated numpy batch -> the step's dict of tensors on ``device``,
    and the count of real samples.  The padding rows of an eval batch
    (``indexes`` -1, copies of its last sample) get zero keypoint
    validity, so that they count for nothing in any loss or metric."""
    images, kp_gt, validity, proj, view_mask = prepare_batch(batch)
    out = {"images": images,
           "keypoints_3d": np.concatenate([kp_gt, validity], -1),
           "keypoints_validity": validity, "proj_matrices": proj,
           "view_mask": view_mask}
    if "pred_keypoints_3d" in batch:
        out["pred_keypoints_3d"] = np.asarray(batch["pred_keypoints_3d"])
    pad = np.asarray(batch["indexes"]) < 0
    if pad.any():
        out["keypoints_validity"] = np.where(pad[:, None, None], 0.0,
                                             validity)
        out["keypoints_3d"] = out["keypoints_3d"].copy()
        out["keypoints_3d"][pad, :, 3:] = 0.0
    return ({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device) for k, v in out.items()}, int((~pad).sum()))


def train_epoch(model, optimizer, criterion, config, iterator, epoch: int,
                generator: torch.Generator, logger: Optional[MetricLogger],
                n_iters_total: int, device, vis_all: bool = False) -> int:
    """One training epoch on this rank's rows; returns the updated step
    count.  The master logs each step's global metrics and, every
    ``vis_freq`` steps where it has a writer, the panels of
    :func:`log_vis_panels`; with ``vis_all`` (volume-axis sharding, whose
    eval forward exchanges between the ranks) the other ranks run that
    forward with it."""
    n_iters = config.opt.get("n_iters_per_epoch")
    vis_freq = config.get("vis_freq")
    end = time.time()
    for i, batch in enumerate(iterator.epoch(epoch)):
        if n_iters is not None and i >= n_iters:
            break
        data_time = time.time() - end
        tensors, _ = device_batch(batch, device)
        metrics = train_step(model, optimizer, criterion, config, tensors,
                             generator)
        vis_now = bool(vis_freq) and n_iters_total % vis_freq == 0
        if logger is not None:
            logger.log("train", {**metrics, "batch_time": time.time() - end,
                                 "data_time": data_time,
                                 "batch_size": iterator.batch_size,
                                 "n_views": batch["images"].shape[1]},
                       n_iters_total)
            if vis_now and logger.writer is not None:
                log_vis_panels(logger.writer, model, batch, tensors, config,
                               n_iters_total)
        elif vis_now and vis_all:
            vis_step(model, config, tensors)
        end = time.time()
        n_iters_total += 1
    if logger is not None:
        _print_fallbacks(iterator.dataset)
    return n_iters_total


def log_vis_panels(writer, model, batch, tensors, config, step: int) -> None:
    """``lt_tpu``'s training panels (``lt_tpu/engine/train.py:363-411``)
    for the first ``vis_n_elements`` samples of ``batch`` (default 2):
    ``train/keypoints_vis/<i>`` (with the volumetric model's cuboid),
    ``train/heatmaps_vis/<i>`` and ``train/volumes_vis/<i>`` where the
    model outputs them, and a ``model/<name>`` histogram of each
    parameter.  The eval-mode forward runs outside any handler; where
    the panels cannot be drawn (no matplotlib) it prints why and goes
    on."""
    out = vis_step(model, config, tensors)
    kp_pred = out.keypoints_3d.float().cpu().numpy()
    cuboids = None
    if config.model.name == "vol":
        side = config.model.get("cuboid_side", 2500.0)
        sides = np.array([side] * 3, np.float32)
        cuboids = (out.base_points.float().cpu().numpy() - sides / 2.0,
                   sides)
    maps = {name: getattr(out, name, None)
            for name in ("keypoints_2d", "confidences", "heatmaps",
                         "volumes")}
    maps = {k: None if v is None else v.float().cpu().numpy()
            for k, v in maps.items()}
    params = {name.replace(".", "/"): p.detach().float().cpu().numpy()
              for name, p in mesh.unwrap(model).named_parameters()}
    kind = config.get("kind", "human36m")
    n = min(batch["images"].shape[0], config.get("vis_n_elements", 2))
    try:
        from lt_tpu_torch.utils import vis

        for bi in range(n):
            panels = {"keypoints": vis.visualize_batch(
                batch["images"], None, maps["keypoints_2d"],
                batch["proj_matrices"], batch["keypoints_3d"][:, :, :3],
                kp_pred, kind=kind, confidences=maps["confidences"],
                cuboids=cuboids, batch_index=bi)}
            if maps["heatmaps"] is not None:
                panels["heatmaps"] = vis.visualize_heatmaps(
                    batch["images"], maps["heatmaps"], kind=kind,
                    batch_index=bi)
            if maps["volumes"] is not None:
                panels["volumes"] = vis.visualize_volumes(
                    batch["images"], maps["volumes"],
                    batch["proj_matrices"], kind=kind, batch_index=bi)
            for name, panel in panels.items():
                writer.add_image(f"train/{name}_vis/{bi}",
                                 panel.transpose(2, 0, 1), global_step=step)
    except Exception as e:  # the panels never stop training (lt_tpu :410)
        print("vis logging failed:", repr(e))
    for name, value in params.items():
        writer.add_histogram(f"model/{name}", value, step)


def eval_epoch(model, criterion, config, iterator, dataset, epoch: int,
               experiment_dir: str, logger: Optional[MetricLogger], device):
    """One eval pass over ``iterator``: the dataset's evaluation of the
    predictions in the dataset's order (``_partial_evaluate`` where the
    pass covers a subset), the per-batch metrics weighted by real samples,
    and ``results.pkl`` / ``metric.json`` under ``checkpoints/{epoch:04d}``.
    Each batch's ``data_time`` (waiting on the loader) and ``batch_time``
    go to ``metrics.jsonl`` as a ``val_batch`` record.  Where the
    evaluation fails it prints why and carries on with a metric of 0 and
    an empty ``metric.json``, as the reference does.

    Under data parallelism each rank runs its rows of each (padded) batch
    and every rank gathers the keypoints and evaluates; the master writes
    (``logger`` None elsewhere)."""
    group = mesh.data_group(model)
    results = defaultdict(list)
    metric_means = defaultdict(list)
    end = time.time()
    for batch in iterator.epoch(0):
        data_time = time.time() - end
        tensors, _ = device_batch(batch, device)
        keypoints, metrics = eval_step(model, criterion, config, tensors)
        keypoints = mesh.gather_rows(keypoints, group)
        indexes = mesh.gather_rows(torch.as_tensor(
            np.asarray(batch["indexes"], np.int64), device=keypoints.device),
            group)
        real = indexes >= 0
        results["keypoints_3d"].append(keypoints[real].cpu().numpy())
        results["indexes"].append(indexes[real].cpu().numpy())
        n_real = int(real.sum())
        for k, v in metrics.items():
            metric_means[k].append((v, n_real))
        if logger is not None:
            logger.log("val_batch", {"data_time": data_time,
                                     "batch_time": time.time() - end,
                                     "batch_size": n_real}, epoch)
        end = time.time()
    results = {k: np.concatenate(v) for k, v in results.items()}

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
    if logger is None:
        return scalar, full

    _print_fallbacks(dataset)
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
    ``device``; returns the last validation metric (rel MPJPE, mm).

    In a process group of several ranks (``lt_tpu_torch.train`` under
    ``torchrun``) the run is data parallel unless ``data_parallel: false``
    (then every rank runs the whole batch and only the master writes):
    ``opt.batch_per_device: true`` scales both batch sizes by the world
    size, which must divide them (``ValueError`` otherwise: a rank cannot
    idle, as ``lt_tpu``'s spare devices do).  ``model.volume_axis_sharding:
    true`` takes precedence, as in ``lt_tpu``: every rank loads the whole
    batch, the volumetric model splits each sample's volume on X over the
    ranks (``engine.factory.spatial_sharding``), every rank gets the
    whole batch's keypoints and takes the same training step
    (``engine.steps.train_step`` averages the gradients over the ranks),
    and the master writes the logs and checkpoints."""
    dev = resolve_device(device)
    config = cfg_lib.load_config(config_path, overrides)
    spatial = factory.spatial_sharding(config)
    ranks = (mesh.world_size() if config.get("data_parallel", True)
             and not spatial else 1)
    if config.opt.get("batch_per_device") and ranks > 1:
        config.opt.batch_size *= ranks
        if config.opt.get("val_batch_size") is not None:
            config.opt.val_batch_size *= ranks
    val_batch = config.opt.get("val_batch_size", config.opt.batch_size)
    if config.opt.batch_size % ranks or val_batch % ranks:
        raise ValueError(
            f"{ranks} ranks do not divide the batch sizes (opt.batch_size "
            f"{config.opt.batch_size}, opt.val_batch_size {val_batch}): each "
            f"rank holds as many rows of a global batch; pick sizes "
            f"divisible by {ranks} or set opt.batch_per_device: true")
    if config.opt.get("n_objects_per_epoch") is not None:
        config.opt.n_iters_per_epoch = (config.opt.n_objects_per_epoch
                                        // config.opt.batch_size)
    master = mesh.is_master()

    model = factory.make_model(config, device=dev, seed=seed)
    if spatial and master:
        print(f"Spatial (volume-X) sharding over {mesh.world_size()} ranks")
    for part, r in init_model_state(config, model).items():
        if master:
            print(f"Loaded {part} weights from {r['path']}: {r['loaded']} "
                  f"tensors, {len(r['unused'])} of its entries unused")
    criterion = factory.make_criterion(config)
    optimizer = factory.make_optimizer(config, model)
    generator = torch.Generator().manual_seed(seed + 1)

    need_train = (not eval_only) or eval_dataset == "train"
    train_ds, val_ds = make_datasets(config, is_train=need_train)
    decoder = getattr(val_ds, "decoder", None)
    if decoder and master:
        print(f"Image decoder: {decoder}")
    shard = dict(rank=mesh.rank() if ranks > 1 else 0, world_size=ranks)
    train_it = None
    if train_ds is not None:
        train_it = make_iterator(train_ds, config.dataset.train,
                                 config.opt.batch_size, seed, train=True,
                                 **shard)
    val_it = make_iterator(val_ds, config.dataset.val, val_batch, seed,
                           train=False, **shard)

    step, start_epoch = 0, 0
    path = config.model.get("checkpoint")
    if (config.model.get("init_weights") and path
            and not path.endswith((".pth", ".npz"))):
        latest = ckpt.resolve_checkpoint_dir(path)
        step = ckpt.restore_checkpoint(latest, model, optimizer, generator)
        if master:
            print(f"Restored the train state of {latest} (step {step})")
    if resume_dir:
        latest = ckpt.resolve_checkpoint_dir(resume_dir)
        step = ckpt.restore_checkpoint(latest, model, optimizer, generator)
        start_epoch = int(os.path.basename(latest)) + 1
        if master:
            print(f"Resumed from {latest} (epoch {start_epoch}, step "
                  f"{step})")
    net = model
    if ranks > 1:
        net = mesh.data_parallel(model, dev)
        if master:
            print(f"Data parallel over {ranks} ranks "
                  f"({config.opt.batch_size // ranks} samples a rank)")

    experiment_dir, logger = None, None
    if master:
        experiment_dir, writer = setup_experiment(
            config, config_path, logdir, type(model).__name__,
            is_train=not eval_only)
        logger = MetricLogger(experiment_dir, writer)
    experiment_dir = mesh.broadcast_object(experiment_dir)
    # Under the key the training panels' eval forward exchanges between the
    # ranks: every rank runs it where the master draws them.
    vis_all = spatial and mesh.broadcast_object(
        logger is not None and logger.writer is not None)
    profile_dir = config.get("profile_dir")
    try:
        with torch.autograd.set_detect_anomaly(
                bool(config.get("debug_nans", False))):
            if eval_only:
                it, ds = ((train_it, train_ds) if eval_dataset == "train"
                          else (val_it, val_ds))
                scalar, _ = eval_epoch(net, criterion, config, it, ds, 0,
                                       experiment_dir, logger, dev)
                if master:
                    print(f"Eval metric (MPJPE rel, mm): {scalar:.3f}")
                return scalar
            n_epochs = config.opt.n_epochs if max_epochs is None else min(
                config.opt.n_epochs, max_epochs)
            scalar = None
            for epoch in range(start_epoch, n_epochs):
                with _profiled(profile_dir if epoch == start_epoch else None,
                               dev):
                    step = train_epoch(net, optimizer, criterion, config,
                                       train_it, epoch, generator, logger,
                                       step, dev, vis_all)
                scalar, _ = eval_epoch(net, criterion, config, val_it,
                                       val_ds, epoch, experiment_dir, logger,
                                       dev)
                ckpt.save_checkpoint(os.path.join(
                    experiment_dir, "checkpoints", f"{epoch:04}"), net,
                    optimizer, step, generator)
                if master:
                    print(f"epoch {epoch}: val MPJPE rel = {scalar:.3f} mm")
            return scalar
    finally:
        if logger is not None:
            logger.close()


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device):
    """A ``torch.profiler`` trace (CPU, and CUDA on a GPU) of the block,
    written under ``profile_dir`` for tensorboard's profiler (one
    ``*.pt.trace.json`` a rank); nothing where ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
