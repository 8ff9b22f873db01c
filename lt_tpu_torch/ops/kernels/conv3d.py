"""BN folding and the fused 'same' 3D convolution (kernel K2).

Port of ``lt_tpu/ops/pallas/conv3d.py:233-244`` (``fold_bn``) and of the
convolution inside every V2V Pallas kernel.  The CUDA kernel is
``csrc/conv3d_fused.cu``; :func:`conv3d_fused_plain` is its plain version.
Layouts follow ``lt_tpu``: NDHWC activations, DHWIO weights.
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
                       relu: bool = False) -> torch.Tensor:
    """Plain version of K2 via ``F.conv3d`` on permuted views."""
    k = w.shape[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 bias, padding=(k - 1) // 2)
    y = y.permute(0, 2, 3, 4, 1)
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    return y.contiguous()


def conv3d_fused(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """'same' conv3d + bias [+ residual] [+ ReLU]: K2 on CUDA, plain on CPU.

    Args:
      x: (B, X, Y, Z, Cin); w: (k, k, k, Cin, Cout), k odd; bias: (Cout,);
      residual: optional (B, X, Y, Z, Cout), added before the ReLU.
    """
    b, sx, sy, sz, cin = x.shape
    k = w.shape[0]
    cout = w.shape[-1]
    if tuple(w.shape) != (k, k, k, cin, cout) or k % 2 == 0:
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (want odd (k, k, k, Cin, Cout))")
    if residual is not None and tuple(residual.shape) != (b, sx, sy, sz, cout):
        raise ValueError(f"residual {tuple(residual.shape)} != output shape")
    if not x.is_cuda:
        return conv3d_fused_plain(x, w, bias, residual, relu)
    for name, t in (("x", x), ("w", w), ("bias", bias)) + (
            (("residual", residual),) if residual is not None else ()):
        _build.check_cuda(t, name)
    out = torch.empty((b, sx, sy, sz, cout), dtype=torch.float32,
                      device=x.device)
    p, i = _build.ptr, _build.i32
    _build.launch(
        "conv3d_fused", "conv3d_fused", x.device, [p, p, p, p, p] + [i] * 8,
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        b, sx, sy, sz, cin, cout, k, int(relu))
    return out
