"""Small metric helpers: the port's own copy of ``lt_tpu/utils/misc.py``
(the reference's ``mvn/utils/misc.py``)."""

from __future__ import annotations

from typing import Iterable

import torch


class AverageMeter:
    """Running average of a value, weighted by ``n``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def calc_gradient_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of gradient tensors (or a dict of them), summed
    in float32."""
    if isinstance(grads, dict):
        grads = grads.values()
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
