"""BN folding and the fused 'same' 3D convolution (kernel K2).

Port of ``lt_tpu/ops/pallas/conv3d.py``: ``fold_bn`` (:233-244),
``conv3d_same`` (:126-230), and the convolution inside every V2V Pallas
kernel.  The CUDA kernel is ``csrc/conv3d_fused.cu``;
:func:`conv3d_fused_plain` is its plain version.  Layouts follow ``lt_tpu``:
NDHWC activations, DHWIO weights.

Types, as in the Pallas bodies: activations and weights are float32 or
bfloat16 (one type for x, w and the residual), the bias is float32, the sum
is float32, and the output is rounded once into ``out_dtype`` (default: the
activation type).  ``lt_tpu``'s ``conv3d_same`` also carries its partial
sums between planes in the activation type; K2 does not, a difference of
bfloat16 rounding order and not of function.
"""

from __future__ import annotations

from typing import Optional

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


def conv3d_fused(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """'same' conv3d + bias [+ residual] [+ ReLU]: K2 on CUDA, plain on CPU.

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
    _build.launch(
        "conv3d_fused", "conv3d_fused", x.device, [p, p, p, p, p] + [i] * 10,
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        b, sx, sy, sz, cin, cout, k, int(relu), _build.DTYPE_CODES[x.dtype],
        _build.DTYPE_CODES[out_dtype])
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
