"""The k=7 front conv of V2V and the multi-plane Res3D block.

Port of ``lt_tpu/ops/pallas/conv_mp.py:178-255`` (``conv3d_mp``) and
``:352-462`` (``res3d_block_mp``).

The TPU kernels pack s planes per grid step to fill the matrix unit; that
schedule stays behind (and with it ``pack_weights_mp``, a TPU weight
layout).  On the card ``conv3d_mp`` is one K2 launch, and
``res3d_block_mp`` the Res3D composition of ``res3d.res3d_block_fused``
(K2 launches), which states the same contract.  ``res3d_block_mp`` keeps
its own shape rule, X % s == 0, so that a caller written against ``lt_tpu``
fails in the same place.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused
from lt_tpu_torch.ops.kernels.res3d import res3d_block_fused


def conv3d_mp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              relu: bool = False, out_dtype=None) -> torch.Tensor:
    """'same' conv3d (+bias [+ReLU]), odd k, BN pre-folded into (w, b).

    Args:
      x: (B, X, Y, Z, Cin); w: (k, k, k, Cin, Cout) in x's type; b: (Cout,)
      float32; out_dtype: default x's type.
    """
    return conv3d_fused(x, w, b, relu=relu, out_dtype=out_dtype)


def res3d_block_mp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, skip_proj=None,
                   tail: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        bool]] = (),
                   s: int = 4, out_dtype=None) -> torch.Tensor:
    """Res3D block with ``res3d_block_fused``'s contract (folded weights,
    optional (ws, bs) projection skip, optional per-voxel tail); X must be
    divisible by ``s``, the TPU schedule's planes per step, which is only
    checked here."""
    if s < 1 or x.shape[1] % s:
        raise ValueError(f"res3d_block_mp needs X % s == 0, got X = "
                         f"{x.shape[1]}, s = {s}")
    return res3d_block_fused(x, w1, b1, w2, b2, skip_proj=skip_proj,
                             tail=tail, out_dtype=out_dtype)
