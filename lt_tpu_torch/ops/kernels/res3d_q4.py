"""The quad-plane Res3D block.

Port of ``lt_tpu/ops/pallas/res3d_q4.py:172-264`` (``res3d_block_q4``).
The TPU kernel takes four output planes per grid step; that schedule and
``pack_weights_q4`` (a TPU weight layout) stay behind.  On the card it is
the Res3D composition of ``res3d.res3d_block_fused`` (K2 launches), whose
contract it states; it keeps its own shape rule, X % 4 == 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lt_tpu_torch.ops.kernels.res3d import res3d_block_fused

PLANES = 4      # output planes per grid step of the TPU schedule


def res3d_block_q4(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, skip_proj=None,
                   tail: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        bool]] = (),
                   out_dtype=None) -> torch.Tensor:
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + skip) [+ tail], BN pre-folded,
    optional (ws, bs) projection skip; X must be divisible by 4."""
    if x.shape[1] % PLANES:
        raise ValueError(f"res3d_block_q4 needs X % {PLANES} == 0, got X = "
                         f"{x.shape[1]}")
    return res3d_block_fused(x, w1, b1, w2, b2, skip_proj=skip_proj,
                             tail=tail, out_dtype=out_dtype)
