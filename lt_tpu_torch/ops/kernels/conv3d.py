"""BN folding and the fused 'same' 3D convolution (kernel K2).

Port of ``lt_tpu/ops/pallas/conv3d.py``: ``fold_bn`` (:233-244),
``conv3d_same`` (:126-230), and the convolution inside every V2V Pallas
kernel.  K2 has two CUDA bodies: ``csrc/conv3d_fused.cu`` on the CUDA
cores for float32 inputs, ``csrc/conv3d_mma.cu`` on the tensor cores for
bfloat16 inputs, launched with the plan of :func:`conv3d_mma_plan`;
:func:`conv3d_fused_plain` is their plain version.  Layouts follow
``lt_tpu``: NDHWC activations, DHWIO weights.

Types, as in the Pallas bodies: activations and weights are float32 or
bfloat16 (one type for x, w and the residual), the bias is float32, the sum
is float32, and the output is rounded once into ``out_dtype`` (default: the
activation type).  ``lt_tpu``'s ``conv3d_same`` also carries its partial
sums between planes in the activation type; K2 does not, a difference of
bfloat16 rounding order and not of function.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lt_tpu_torch.ops.kernels import _build

BN_EPS = 1e-5


def fold_bn(weights: torch.Tensor, conv_bias: Optional[torch.Tensor],
            scale: torch.Tensor, bn_bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS):
    """Fold inference BatchNorm into conv weights (output channels last)
    and bias: W * g, (b - mean) * g + bn_bias, g = scale / sqrt(var + eps).
    """
    g = scale / torch.sqrt(var + eps)
    b = conv_bias if conv_bias is not None else torch.zeros_like(mean)
    return weights * g, (b - mean) * g + bn_bias


def conv3d_fused_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False, out_dtype=None) -> torch.Tensor:
    """Plain version of K2 via ``F.conv3d`` on permuted views.  bfloat16
    inputs are widened (exactly) to float32, so that the sum, the bias, the
    residual and the ReLU are float32 and only the result is rounded."""
    k = w.shape[0]
    wide = x.dtype == torch.bfloat16
    y = F.conv3d((x.float() if wide else x).permute(0, 4, 1, 2, 3),
                 (w.float() if wide else w).permute(4, 3, 0, 1, 2),
                 bias, padding=(k - 1) // 2)
    y = y.permute(0, 2, 3, 4, 1)
    if residual is not None:
        y = y + (residual.float() if wide else residual)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or x.dtype).contiguous()


# conv3d_mma.cu's launch constants: weight ring slots, and the shared
# memory one block may hold on the H100.
MMA_STAGES = 3
MMA_SMEM_MAX = 232448
# Bricks (x, y, z) in order of preference, Z (contiguous) longest; a
# smaller one only where a large k leaves no room for the first.
MMA_BRICKS = ((4, 8, 8), (4, 4, 8), (2, 4, 8), (2, 2, 8), (1, 2, 8),
              (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1))


def mma_block_voxels(nt: int) -> int:
    """Output voxels per block (conv3d_mma.cu's ``block_voxels``): 256 for
    N tiles of up to 32 channels, 128 for the 64-channel tile."""
    return 256 if nt <= 32 else 128


class MmaPlan(NamedTuple):
    """One conv3d_mma launch: output-channel tile, Cin chunk, brick, halo
    buffers, dynamic shared memory (bytes) and blocks (a 1-D grid)."""
    nt: int
    ck: int
    brick: Tuple[int, int, int]
    nh: int
    smem: int
    grid: int

    @property
    def args(self):
        return (self.nt, self.ck, *self.brick, self.nh, self.smem, self.grid)


def _odd_pitch(elems: int) -> int:
    """Bytes of a shared-memory row of ``elems`` bfloat16 values padded to
    an odd number of 16-byte units (conv3d_mma.cu's ``odd_pitch``)."""
    units = elems // 8 + 1
    return (units if units % 2 else units + 1) * 16


def mma_smem_bytes(nt: int, ck: int, k: int, brick, nh: int) -> int:
    """conv3d_mma.cu's ``smem_bytes``: nh haloed input bricks and the
    weight ring, or the epilogue's float32 tile and row offsets if
    larger."""
    bx, by, bz = brick
    halo = (bx + k - 1) * (by + k - 1) * (bz + k - 1) * _odd_pitch(ck)
    main = nh * halo + MMA_STAGES * k * ck * _odd_pitch(nt)
    return max(main, mma_block_voxels(nt) * ((nt + 4) * 4 + 8))


@functools.lru_cache(maxsize=None)
def conv3d_mma_plan(b: int, sx: int, sy: int, sz: int, cin: int, cout: int,
                    k: int) -> MmaPlan:
    """The launch plan of conv3d_mma for one K2 call.

    N tile: the least of 16 / 24 / 32 / 64 that holds Cout, else 64 (Cout
    = 17 pads to 24 and the store masks it).  Cin chunk: 16 channels where
    Cin <= 16, else 32.  Halo buffers: enough that chunk c + 1's copy,
    issued MMA_STAGES - 1 steps of k * k before it is read, lands in a
    buffer no step still reads, at most one per chunk; else one, reloaded
    at each chunk's first step.  The first of these that fits the shared
    memory, in this order: the N tile, the brick (MMA_BRICKS, at most the
    block's voxels), CK = 32 before 16, the halo buffers.  Blocks: batch x
    bricks x N tiles.
    """
    nt0 = next((t for t in (16, 24, 32, 64) if cout <= t), 64)
    ksq = k * k
    for nt in (t for t in (64, 32, 24, 16) if t <= nt0):
        for brick in MMA_BRICKS:
            if math.prod(brick) > mma_block_voxels(nt):
                continue
            for ck in ((16,) if cin <= 16 else (32, 16)):
                need = min(math.ceil(cin / ck),
                           1 + math.ceil((MMA_STAGES - 1) / ksq))
                for nh in sorted({need, 1}, reverse=True):
                    smem = mma_smem_bytes(nt, ck, k, brick, nh)
                    if smem > MMA_SMEM_MAX:
                        continue
                    tiles = [math.ceil(s / e) for s, e in zip((sx, sy, sz),
                                                              brick)]
                    grid = b * math.prod(tiles) * math.ceil(cout / nt)
                    return MmaPlan(nt, ck, brick, nh, smem, grid)
    raise ValueError(f"conv3d_mma: no brick fits k={k}, Cin={cin}, "
                     f"Cout={cout} in {MMA_SMEM_MAX} bytes of shared memory")


def conv3d_fused(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """'same' conv3d + bias [+ residual] [+ ReLU]: K2 on CUDA (float32
    inputs: conv3d_fused.cu; bfloat16: conv3d_mma.cu), plain on CPU.

    Args:
      x: (B, X, Y, Z, Cin), float32 or bfloat16; w: (k, k, k, Cin, Cout), k
      odd, in x's type; bias: (Cout,) float32; residual: optional
      (B, X, Y, Z, Cout) in x's type, added before the ReLU; out_dtype:
      float32 or bfloat16 (default: x's type).
    """
    b, sx, sy, sz, cin = x.shape
    k = w.shape[0]
    cout = w.shape[-1]
    out_dtype = out_dtype or x.dtype
    if tuple(w.shape) != (k, k, k, cin, cout) or k % 2 == 0:
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (want odd (k, k, k, Cin, Cout))")
    if residual is not None and tuple(residual.shape) != (b, sx, sy, sz, cout):
        raise ValueError(f"residual {tuple(residual.shape)} != output shape")
    for name, t in (("w", w), ("residual", residual)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}: K2 "
                            f"takes one type for x, w and the residual")
    if not x.is_cuda:
        return conv3d_fused_plain(x, w, bias, residual, relu, out_dtype)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype: kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t is not None:
            _build.check_cuda(t, name, dtypes=_build.F32_BF16)
    _build.check_cuda(bias, "bias")
    out = torch.empty((b, sx, sy, sz, cout), dtype=out_dtype, device=x.device)
    p, i = _build.ptr, _build.i32
    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, sx, sy, sz, cin, cout, k, int(relu),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype])
    if x.dtype == torch.bfloat16:
        plan = conv3d_mma_plan(b, sx, sy, sz, cin, cout, k).args
        _build.launch("conv3d_mma", "conv3d_mma", x.device,
                      [p] * 5 + [i] * (10 + len(plan)), *args, *plan)
    else:
        _build.launch("conv3d_fused", "conv3d_fused", x.device,
                      [p] * 5 + [i] * 10, *args)
    return out


def conv3d_same(x: torch.Tensor, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None, relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                out_dtype=None) -> torch.Tensor:
    """3x3x3 stride-1 zero-pad-1 conv over NDHWC input, ``lt_tpu``'s
    ``conv3d_same``: one K2 launch (K2 computes this function for any odd
    k; the TPU's slab schedule stays behind).

    Args:
      x: (B, X, Y, Z, Cin), float32 or bfloat16.
      weights: (3, 3, 3, Cin, Cout); cast to x's type, as ``lt_tpu`` casts.
      bias: optional (Cout,), added in float32 before ``residual`` / ``relu``
        (fold BN in with :func:`fold_bn`).
      residual: optional (B, X, Y, Z, Cout) skip added before the ReLU; cast
        to x's type.
      out_dtype: output type (default: x's).
    """
    if weights.dim() != 5 or tuple(weights.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d_same takes (3, 3, 3, Cin, Cout) weights, "
                         f"got {tuple(weights.shape)}")
    cout = weights.shape[-1]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    if residual is not None:
        residual = residual.to(x.dtype)
    if x.dtype == torch.bfloat16:
        bias = bias.float()
    return conv3d_fused(x, weights.to(x.dtype), bias, residual, relu,
                        out_dtype)
