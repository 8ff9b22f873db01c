"""Res3D blocks, chains and the upsample-headed chain, composed of K2-K4.

Port of ``lt_tpu/ops/pallas/res3d.py:623-1199`` (``res3d_chain_fused``,
``res3d_block_fused``, ``upsample_res3d_fused``).  On the TPU each is one
Pallas kernel that keeps its volumes in VMEM; that fusion is a schedule,
not a different function.  Here each is a short sequence of launches of the
port's kernels (or their plain versions on CPU tensors).

``lt_tpu`` has three more schedules of the single Res3D block, each with
``res3d_block_fused``'s contract and shape rules of its own; their
counterparts call :func:`res3d_block_fused` after checking those rules:

  ``conv_mp.py:res3d_block_mp``          -> ``conv_mp.res3d_block_mp``
  ``res3d_q4.py:res3d_block_q4``         -> ``res3d_q4.res3d_block_q4``
  ``res3d_folded.py:res3d_block_folded`` -> ``res3d_folded.res3d_block_folded``

and ``conv3d.py:conv3d_same``, the single k=3 conv of the per-conv V2V
configuration, is ``conv3d.conv3d_same`` (one K2 launch).  The compositions:

  Res3D block  = K2(x; w1, b1, relu) -> K2(.; w2, b2, + skip, relu)
                 skip = x, or K2(x; 1x1x1 ws, bs) for a projection skip
  tail         = K2 k=1 per (w, b, relu)
  emit_pooled  = K4 on the input of the (last) block
  upsample     = K3 (+ skip after its ReLU)

The TPU machinery (``fold``, ``pairs_per_step``, VMEM estimators,
``LT_TPU_*`` switches) is left behind, and with it the TPU schedules' shape
rules (even X, X % 4 == 0): these compositions take any volume size, and
a pool only needs even dims.  NDHWC activations; folded DHWIO weights
(``conv3d.fold_bn``).  Activations and weights are float32 or bfloat16 (one
type throughout a call; float32 weights may also come as their bfloat16
parts, ``conv3d.conv3d_fused``), biases float32; every launch accumulates in
float32 and rounds its output once, so a block's intermediate is rounded
where ``lt_tpu`` keeps it in the compute dtype in VMEM.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused, pointwise
from lt_tpu_torch.ops.kernels.updown import max_pool3d_2x, upsample3d_2x


def _pointwise(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               relu: bool = False, out_dtype=None) -> torch.Tensor:
    """A 1x1x1 conv: w (Cin, Cout), or its (parts, Cin, Cout) bfloat16
    parts."""
    return conv3d_fused(x, pointwise(w), b, relu=relu, out_dtype=out_dtype)


def _res_block(x, w1, b1, w2, b2, skip_proj=None,
               out_dtype=None) -> torch.Tensor:
    y = conv3d_fused(x, w1, b1, relu=True)
    skip = x if skip_proj is None else _pointwise(x, *skip_proj)
    return conv3d_fused(y, w2, b2, residual=skip, relu=True,
                        out_dtype=out_dtype)


def _apply_tail(x: torch.Tensor, tail, out_dtype=None) -> torch.Tensor:
    """The per-voxel matmuls; only the last one writes ``out_dtype``."""
    for i, (wt, bt, relu) in enumerate(tail):
        x = _pointwise(x, wt, bt, relu=bool(relu),
                       out_dtype=out_dtype if i == len(tail) - 1 else None)
    return x


def res3d_block_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, skip_proj=None,
                      tail: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                           bool]] = (),
                      emit_pooled: bool = False, out_dtype=None):
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + skip) [+ tail].

    Args:
      x: (B, X, Y, Z, Cin).
      w1: (3, 3, 3, Cin, C); w2: (3, 3, 3, C, C); b1, b2: (C,) -- folded.
      skip_proj: None (identity, Cin == C) or (ws (Cin, C), bs (C,)).
      tail: ((w (C_i, C_o), b (C_o,), relu), ...) per-voxel matmuls.
      emit_pooled: also return MaxPool3d(2)(x).  (``lt_tpu``'s kernel
        pools only when X % 4 == 0; this one pools whenever asked.)
      out_dtype: type of the block's (or its tail's) output; default x's.

    Returns:
      (B, X, Y, Z, C_out); with ``emit_pooled``, ``(out, pooled)``.
    """
    cin, c = x.shape[-1], w1.shape[-1]
    if skip_proj is None and cin != c:
        raise ValueError(f"identity skip needs Cin == C, got {cin} != {c}")
    out = _res_block(x, w1, b1, w2, b2, skip_proj,
                     out_dtype=None if tail else out_dtype)
    out = _apply_tail(out, tail, out_dtype)
    if emit_pooled:
        return out, max_pool3d_2x(x)
    return out


def res3d_chain_fused(x: torch.Tensor, blocks, emit_pooled: bool = False):
    """K consecutive Res3D blocks.

    Args:
      x: (B, X, Y, Z, C).
      blocks: (w1, b1, w2, b2) folded params per identity-skip block; the
        FIRST may be (w1, b1, w2, b2, (ws, bs)) with a projection skip, in
        which case x has Cin == w1.shape[-2].
      emit_pooled: also return MaxPool3d(2) of the LAST block's input
        (needs >= 2 blocks).

    Returns:
      (B, X, Y, Z, C); with ``emit_pooled``, ``(out, pooled)``.
    """
    if not blocks:
        raise ValueError("res3d_chain_fused needs at least one block")
    if emit_pooled and len(blocks) < 2:
        raise ValueError("emit_pooled needs >= 2 blocks")
    pooled = None
    for i, blk in enumerate(blocks):
        if len(blk) == 5 and i > 0:
            raise ValueError("only the first block may carry a projection")
        if emit_pooled and i == len(blocks) - 1:
            pooled = max_pool3d_2x(x)
        x = _res_block(x, *blk[:4], skip_proj=blk[4] if len(blk) == 5
                       else None)
    return (x, pooled) if emit_pooled else x


def upsample_res3d_fused(x: torch.Tensor, w8: torch.Tensor,
                         b8: torch.Tensor, skip: torch.Tensor, blocks,
                         tail: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                              bool]] = ()) -> torch.Tensor:
    """ConvTranspose3d(2, 2) + folded BN + ReLU, + skip, K identity Res3D
    blocks, then the per-voxel tail.

    Args:
      x: (B, Xs, Ys, Zs, Cin).
      w8, b8: packed upsample taps (``updown.pack_upsample_weights``).
      skip: (B, 2Xs, 2Ys, 2Zs, C), added after the upsample's ReLU.
      blocks: folded (w1, b1, w2, b2) per identity-skip block (C -> C).
      tail: ((w (C_i, C_o), b (C_o,), relu), ...).

    Returns:
      (B, 2Xs, 2Ys, 2Zs, C_out).
    """
    if not blocks:
        raise ValueError("upsample_res3d_fused needs at least one block")
    c = w8.shape[1] // 8
    y = upsample3d_2x(x, w8, b8, skip=skip)
    for w1, b1, w2, b2 in blocks:
        if not w1.shape[-2] == w1.shape[-1] == c:
            raise ValueError("upsample_res3d_fused takes identity-skip blocks")
        y = _res_block(y, w1, b1, w2, b2)
    return _apply_tail(y, tail)
