"""BatchNorm with ``lt_tpu``'s (flax's) running-statistics update, and the
per-block activation checkpointing (``remat``) that keeps it exact.

Port of ``lt_tpu/models/backbone.py:42-60``.  In training, flax's
``nn.BatchNorm`` normalizes with the batch mean and *biased* variance and
moves the running variance towards that same biased variance.
``torch.nn.BatchNorm*d`` moves it towards the *unbiased* one, n / (n - 1)
larger: 2.5 % at V2V's 2^3 level at batch 5.  :class:`BatchNorm` keeps
flax's update; backbone and V2V both use it.

Under bfloat16 compute (``torch.autocast``, which leaves BatchNorm alone)
the input is bfloat16 and the weights and running statistics float32:
``F.batch_norm`` reduces and normalizes in float32 and rounds its output
to bfloat16 once, and the running statistics stay float32, as
``lt_tpu/models/backbone.py:42-60`` keeps them.
"""

from __future__ import annotations

import contextvars

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1        # flax momentum 0.9 is an EMA decay: 1 - 0.1

# Set while a checkpointed block recomputes its forward in the backward,
# so that its running statistics are not updated a second time.
_RECOMPUTING = contextvars.ContextVar("lt_tpu_torch_bn_recomputing",
                                      default=False)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of an (N, C, ...) input, any spatial rank.

    Eval: the running statistics.  Training: the batch mean and biased
    variance normalize, and the running statistics move towards them by
    ``momentum``.  Parameter and buffer names are ``nn.BatchNorm2d``'s.
    """

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"BatchNorm needs (N, C, ...), got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # One reduction.  F.batch_norm moves a copy of the running variance
        # to (1 - m) r + m var n / (n - 1); then
        # r <- r (1 - m) / n + copy (n - 1) / n  =  (1 - m) r + m var,
        # flax's update.  (The copy: autograd keeps the tensor it was given.)
        # A checkpointed block's recompute moves copies only, so that the
        # statistics move once per step and the recompute saves the same
        # tensors as the forward did.
        recompute = _RECOMPUTING.get()
        mean = self.running_mean.clone() if recompute else self.running_mean
        moved = self.running_var.clone()
        y = F.batch_norm(x, mean, moved, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if not recompute:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_var.mul_((1.0 - self.momentum) / n).add_(
                    moved, alpha=(n - 1) / n)
                self.num_batches_tracked.add_(1)
        return y


def bn_fed_biases(model: nn.Module) -> set:
    """Names of the biases of convolutions that feed a :class:`BatchNorm`.
    In training the batch mean removes them, so their gradient is zero in
    exact arithmetic: only rounding remains, and no relative error is
    defined."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            kids = list(mod.named_children())
            for (name, conv), (_, bn) in zip(kids, kids[1:]):
                if (isinstance(conv, nn.modules.conv._ConvNd)
                        and isinstance(bn, BatchNorm)
                        and conv.bias is not None):
                    names.add(f"{prefix}.{name}.bias")
    return names


def run_block(module: nn.Module, x: torch.Tensor, remat: bool):
    """``module(x)``; with ``remat`` in training, under
    ``torch.utils.checkpoint``: the block's activations are recomputed in
    the backward instead of kept.  The recompute leaves BatchNorm running
    statistics alone: they move once per step, as ``lt_tpu``'s ``nn.remat``
    blocks move them."""
    if not (remat and module.training):
        return module(x)
    calls = []

    def run(*a):
        token = _RECOMPUTING.set(bool(calls))
        calls.append(True)
        try:
            return module(*a)
        finally:
            _RECOMPUTING.reset(token)

    return checkpoint(run, x, use_reentrant=False)
