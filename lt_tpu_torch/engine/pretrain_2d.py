"""Stage 1 of the two-stage volumetric recipe: the PoseResNet backbone
alone, trained on 2D Gaussian heatmaps of the synthetic set.

The port's counterpart of ``benchmarks/pretrain_backbone_2d.py``, with its
constants and steps.  The reference's volumetric workflow never starts
from a random backbone (its configs chain from a pretrained 2D pose
network); with no such weights at hand, the synthetic-domain equivalent
supervises the heatmap head directly with Gaussians rendered at the
ground-truth 2D projections.  The loss is the mean of (1 + POS_WEIGHT t)
(h - t)^2: plain MSE on sparse Gaussians barely beats the all-zero
prediction, and weighting the positive pixels ~30x balances the gradient
(the JAX script's own comment: argmax error 7.3 -> below 1.5 heatmap px at
the same step count).  Adam
follows optax's ``warmup_cosine_decay_schedule``, evaluated as optax
evaluates it: at the count of updates made before this one, so the first
update's learning rate is 0 (:func:`learning_rate`).  Its entry point is
``lt_tpu_torch/two_stage.py``.

:func:`main` prints the mean 2D argmax error (heatmap px) every LOG_EVERY
steps and at the last, writes them to ``out_dir/metrics.jsonl``, and saves
one of the port's checkpoint directories at ``out_dir/checkpoints/0000``
whose model entries are the backbone's under ``backbone.``, so that
``engine.train.init_model_state`` loads it as ``model.backbone.checkpoint``.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch
from torch import nn

from lt_tpu_torch import resolve_device
from lt_tpu_torch.data.batch import BatchIterator
from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.models.backbone import PoseResNet
from lt_tpu_torch.ops.heatmaps import render_points_as_2d_gaussians

IMAGE_SIZE = 128
HEATMAP_STRIDE = 4  # PoseResNet: /32 trunk, x8 deconv head
SIGMA = 1.5         # target Gaussian sigma, heatmap px
POS_WEIGHT = 30.0   # extra weight on positive target pixels
NUM_JOINTS = 17
NUM_LAYERS = 18     # ResNet-18
BATCH_SIZE = 8
LOG_EVERY = 50
PEAK_LR = 2e-3
END_LR = 1e-5
N_SAMPLES = 256


def gt_2d_heatmap_px(batch, stride: int = HEATMAP_STRIDE) -> np.ndarray:
    """(B, V, J, 2) ground-truth joint positions in heatmap pixels."""
    kp = batch["keypoints_3d"][:, :, :3]                     # (B, J, 3)
    proj = batch["proj_matrices"]                            # (B, V, 3, 4)
    homo = np.concatenate([kp, np.ones_like(kp[..., :1])], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, homo)            # (B, V, J, 3)
    uv = uvw[..., :2] / uvw[..., 2:3]
    return uv / stride


def make_targets(uv_hm: torch.Tensor, hm_size: int) -> torch.Tensor:
    """Unnormalised Gaussian target maps (N, J, h, w) of sigma SIGMA at
    (N, J, 2) positions."""
    sigmas = torch.full_like(uv_hm, SIGMA)
    return render_points_as_2d_gaussians(uv_hm, sigmas, (hm_size, hm_size),
                                         normalize=False)


def heatmap_loss(heat: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """mean((1 + POS_WEIGHT t) (h - t)^2)."""
    return torch.mean((1.0 + POS_WEIGHT * targets) * (heat - targets) ** 2)


def learning_rate(count: int, n_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, PEAK_LR, warmup_steps=
    min(100, n_steps // 10), decay_steps=n_steps, end_value=END_LR) at
    ``count``, in float64 and in optax's order of operations: a linear
    warmup from 0 (a polynomial schedule of power 1), then a cosine decay
    to END_LR over the remaining steps.  optax.adam applies it at the count
    of updates already made, so update i (from 0) takes
    ``learning_rate(i, n)``."""
    warmup = min(100, n_steps // 10)
    if count < warmup:
        frac = 1 - min(max(count, 0), warmup) / warmup
        return (0.0 - PEAK_LR) * frac + PEAK_LR
    decay = n_steps - warmup
    t = min(count - warmup, decay)
    cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
    alpha = END_LR / PEAK_LR
    return PEAK_LR * ((1 - alpha) * cosine + alpha)


def batch_images(batch, device) -> torch.Tensor:
    """A collated batch's (B, V, H, W, 3) images -> (B V, 3, H, W)."""
    images = batch["images"]
    size = images.shape[-2]
    return torch.from_numpy(np.ascontiguousarray(
        images.reshape(-1, size, size, 3).transpose(0, 3, 1, 2))).to(device)


def batch_targets(batch, hm_size: int, device):
    """(uv (B V, J, 2) in heatmap px, targets (B V, J, h, w))."""
    uv = torch.from_numpy(np.ascontiguousarray(
        gt_2d_heatmap_px(batch).reshape(-1, NUM_JOINTS, 2),
        np.float32)).to(device)
    return uv, make_targets(uv, hm_size)


def train_step(net: PoseResNet, optimizer: torch.optim.Adam,
               images: torch.Tensor, targets: torch.Tensor,
               lr: float) -> torch.Tensor:
    """One Adam update at ``lr`` of ``net`` in train mode (BatchNorm on the
    batch's statistics, running statistics updated); returns the loss."""
    net.train()
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    heat = net(images)[0]
    loss = heatmap_loss(heat, targets)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def argmax_err(net: PoseResNet, images: torch.Tensor,
               uv: torch.Tensor) -> float:
    """Mean distance (heatmap px) between each heatmap's argmax, in eval
    mode, and the ground truth."""
    net.eval()
    heat = net(images)[0]
    hm = heat.shape[-1]
    idx = heat.reshape(heat.shape[0], heat.shape[1], -1).argmax(-1)
    pred = torch.stack([idx % hm, idx // hm], -1).to(torch.float32)
    return float(torch.linalg.norm(pred - uv, dim=-1).mean())


def make_optimizer(net: nn.Module) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8, which
    are torch's); :func:`train_step` sets each update's learning rate."""
    return torch.optim.Adam(net.parameters(), lr=0.0)


def main(n_steps: int = 600, out_dir: str = "logs/backbone2d",
         device="cuda") -> str:
    """Train the backbone for ``n_steps`` from a seeded random init and
    save it under ``out_dir``; returns ``out_dir``."""
    dev = resolve_device(device)
    ds = SyntheticMultiViewDataset(n_samples=N_SAMPLES, n_views=4,
                                   num_joints=NUM_JOINTS,
                                   image_size=IMAGE_SIZE, cache_images=True)
    it = BatchIterator(ds, BATCH_SIZE, shuffle=True, seed=0)
    net = PoseResNet(NUM_JOINTS, num_layers=NUM_LAYERS, device=dev)
    holder = nn.ModuleDict({"backbone": net})
    hm = IMAGE_SIZE // HEATMAP_STRIDE
    optimizer = make_optimizer(net)

    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()
    with open(os.path.join(out_dir, "metrics.jsonl"), "w") as log:
        i, epoch = 0, 0
        while i < n_steps:
            for batch in it.epoch(epoch):
                if i >= n_steps:
                    break
                images = batch_images(batch, dev)
                uv, targets = batch_targets(batch, hm, dev)
                loss = train_step(net, optimizer, images, targets,
                                  learning_rate(i, n_steps))
                if i % LOG_EVERY == 0 or i == n_steps - 1:
                    err = argmax_err(net, images, uv)
                    print(f"step {i}: loss {float(loss):.5f} "
                          f"argmax_err {err:.2f} hm px", flush=True)
                    log.write(json.dumps({
                        "tag": "stage1", "step": i, "loss": float(loss),
                        "argmax_err": err, "lr": learning_rate(i, n_steps),
                        "seconds": time.time() - t_start}) + "\n")
                    log.flush()
                i += 1
            epoch += 1

    cdir = os.path.join(out_dir, "checkpoints", "0000")
    ckpt.save_checkpoint(cdir, holder, optimizer, n_steps, torch.Generator())
    print("SAVED", cdir, flush=True)
    return out_dir

