"""Seeded random initialisation from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """Draw every parameter and BatchNorm statistic from one generator.

    Convolutions and linear layers: normal with std sqrt(1 / fan_in)
    (LeCun, as ``lt_tpu``'s flax default), where a transposed conv's
    fan-in counts the taps that reach one output.  Biases: normal(0, 0.05).
    BatchNorm: scale 1 + 0.1 N, bias 0.1 N, running mean 0.1 N, running
    variance 1 + 0.3 U, so that folding BN into a conv is exercised.
    """
    gen = torch.Generator().manual_seed(seed)

    def normal(t: torch.Tensor, std: float, mean: float = 0.0) -> None:
        t.copy_(torch.randn(t.shape, generator=gen) * std + mean)

    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            normal(mod.weight, math.sqrt(1.0 / mod.weight[0].numel()))
        elif isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            taps = math.prod(k // s for k, s in zip(mod.kernel_size,
                                                    mod.stride))
            normal(mod.weight, math.sqrt(1.0 / (mod.in_channels * taps)))
        elif isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d)):
            normal(mod.weight, 0.1, 1.0)
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            mod.running_var.copy_(
                1.0 + 0.3 * torch.rand(mod.running_var.shape, generator=gen))
            continue
        else:
            continue
        if mod.bias is not None:
            normal(mod.bias, 0.05)
