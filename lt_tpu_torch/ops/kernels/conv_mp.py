"""The k=7 front conv of V2V.

Port of ``lt_tpu/ops/pallas/conv_mp.py:178-255``.

The TPU kernel packs s planes per grid step to fill its matrix unit; that
schedule stays behind.  On the card the same function is one K2 launch.
"""

from __future__ import annotations

import torch

from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused


def conv3d_mp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              relu: bool = False) -> torch.Tensor:
    """'same' conv3d (+bias [+ReLU]), odd k, BN pre-folded into (w, b).

    Args:
      x: (B, X, Y, Z, Cin); w: (k, k, k, Cin, Cout); b: (Cout,).
    """
    return conv3d_fused(x, w, b, relu=relu)
