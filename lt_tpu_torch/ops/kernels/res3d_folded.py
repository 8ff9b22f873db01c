"""The z-folded Res3D block (identity skip).

Port of ``lt_tpu/ops/pallas/res3d_folded.py:216-322``
(``res3d_block_folded``).  The TPU kernel folds four z positions into the
lane dimension; that layout, ``pack_weights_folded`` and
``pack_tail_folded`` stay behind.  On the card it is the Res3D composition
of ``res3d.res3d_block_fused`` (K2 launches); it keeps its own shape rules:
identity skip only (Cin == C), even X, Z % 4 == 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lt_tpu_torch.ops.kernels.res3d import res3d_block_fused

FOLD_Z = 4      # z positions per lane group of the TPU layout


def res3d_block_folded(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       tail: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                            bool]] = (),
                       out_dtype=None) -> torch.Tensor:
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + x) [+ tail], BN pre-folded.

    Args:
      x: (B, X, Y, Z, C) with X even and Z % 4 == 0.
      w1, w2: (3, 3, 3, C, C); b1, b2: (C,).
      tail: ((w (C_i, C_o), b (C_o,), relu), ...).
    """
    _, size_x, _, size_z, c = x.shape
    if size_x % 2:
        raise ValueError(f"res3d_block_folded needs even X, got {size_x}")
    if size_z % FOLD_Z:
        raise ValueError(f"res3d_block_folded needs Z % {FOLD_Z} == 0, got "
                         f"Z = {size_z}")
    if not (w1.shape[3] == c == w1.shape[4] == w2.shape[3] == w2.shape[4]):
        raise ValueError("res3d_block_folded requires Cin == Cout (identity "
                         "skip)")
    return res3d_block_fused(x, w1, b1, w2, b2, tail=tail,
                             out_dtype=out_dtype)
