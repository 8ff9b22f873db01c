"""MaxPool3d(2) (kernel K4) and the fused 2x transposed conv (kernel K3).

Port of ``lt_tpu/ops/pallas/updown.py:98-416``.  CUDA kernels:
``csrc/max_pool3d_2x.cu`` and ``csrc/upsample3d_2x.cu``; the ``*_plain``
functions are their plain versions.  NDHWC layout.  Volumes (and K3's
packed weights and skip) are float32 or bfloat16, one type per call; K3's
bias is float32, its sum, ReLU and skip add float32, rounded once.
"""

from __future__ import annotations

from typing import Optional

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.kernels.conv3d import BN_EPS


def max_pool3d_2x_plain(x: torch.Tensor) -> torch.Tensor:
    b, sx, sy, sz, c = x.shape
    return x.reshape(b, sx // 2, 2, sy // 2, 2, sz // 2, 2, c).amax(
        dim=(2, 4, 6))


def max_pool3d_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(kernel=2, stride=2) over (B, X, Y, Z, C), all dims even."""
    b, sx, sy, sz, c = x.shape
    if sx % 2 or sy % 2 or sz % 2:
        raise ValueError(f"max_pool3d_2x needs even dims, got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return max_pool3d_2x_plain(x)
    _build.check_cuda(x, "x", dtypes=_build.F32_BF16)
    out = torch.empty((b, sx // 2, sy // 2, sz // 2, c), dtype=x.dtype,
                      device=x.device)
    p, i = _build.ptr, _build.i32
    _build.launch("max_pool3d_2x", "max_pool3d_2x", x.device, [p, p] + [i] * 6,
                  x.data_ptr(), out.data_ptr(), b, sx, sy, sz, c,
                  _build.DTYPE_CODES[x.dtype])
    return out


def upsample3d_2x_plain(x: torch.Tensor, w8: torch.Tensor,
                        bias: torch.Tensor,
                        skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, sx, sy, sz, cin = x.shape
    cout = w8.shape[1] // 8
    wide = x.dtype == torch.bfloat16     # then float32 until the result
    xf, wf = (x.float(), w8.float()) if wide else (x, w8)
    q = torch.relu(xf.reshape(-1, cin) @ wf + bias)  # (voxels, 8 * Cout)
    q = q.reshape(b, sx, sy, sz, 2, 2, 2, cout)      # (.., dx, dy, dz, co)
    out = q.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
        b, 2 * sx, 2 * sy, 2 * sz, cout)
    if skip is not None:
        out = out + (skip.float() if wide else skip)
    return out.to(x.dtype)


def upsample3d_2x(x: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                  skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused ConvTranspose3d(2, 2) + folded BN + ReLU [+ skip added after
    the ReLU]: K3 on CUDA, plain on CPU.

    Args:
      x: (B, X, Y, Z, Cin), float32 or bfloat16.
      w8: (Cin, 8*Cout) packed taps in x's type, column block
        (dx*4 + dy*2 + dz)*Cout.
      bias: (8*Cout,) float32.
      skip: optional (B, 2X, 2Y, 2Z, Cout) in x's type.
    """
    b, sx, sy, sz, cin = x.shape
    cout = w8.shape[1] // 8
    if tuple(w8.shape) != (cin, 8 * cout) or tuple(bias.shape) != (8 * cout,):
        raise ValueError(f"w8 {tuple(w8.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit Cin={cin}")
    out_shape = (b, 2 * sx, 2 * sy, 2 * sz, cout)
    if skip is not None and tuple(skip.shape) != out_shape:
        raise ValueError(f"skip {tuple(skip.shape)} != {out_shape}")
    for name, t in (("w8", w8), ("skip", skip)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}: K3 "
                            f"takes one type for x, w8 and the skip")
    if not x.is_cuda:
        return upsample3d_2x_plain(x, w8, bias, skip)
    for name, t in (("x", x), ("w8", w8), ("skip", skip)):
        if t is not None:
            _build.check_cuda(t, name, dtypes=_build.F32_BF16)
    _build.check_cuda(bias, "bias")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    p, i = _build.ptr, _build.i32
    _build.launch("upsample3d_2x", "upsample3d_2x", x.device,
                  [p] * 5 + [i] * 7,
                  x.data_ptr(), w8.data_ptr(), bias.data_ptr(),
                  None if skip is None else skip.data_ptr(), out.data_ptr(),
                  b, sx, sy, sz, cin, cout, _build.DTYPE_CODES[x.dtype])
    return out


def pack_upsample_weights(kernel: torch.Tensor, conv_bias, scale, bn_bias,
                          mean, var, eps: float = BN_EPS):
    """Fold BN into Upsample3DBlock params and pack them for K3.

    ``kernel``: (2, 2, 2, Cout, Cin), ``lt_tpu``'s layout (the PyTorch
    ConvTranspose3d weight (Cin, Cout, 2, 2, 2) permuted (2, 3, 4, 1, 0)).
    Output voxel (2x+dx, 2y+dy, 2z+dz) receives in[x, y, z] @
    kernel[dx, dy, dz].T, so column block t = dx*4 + dy*2 + dz of the packed
    (Cin, 8*Cout) matrix is ``kernel[dx, dy, dz].T`` scaled by the BN fold.
    """
    cout, cin = kernel.shape[3:]
    g = scale / torch.sqrt(var + eps)
    base = conv_bias if conv_bias is not None else torch.zeros_like(mean)
    w8 = (kernel.reshape(8, cout, cin) * g[:, None]).permute(2, 0, 1)
    b8 = ((base - mean) * g + bn_bias).repeat(8)
    return w8.reshape(cin, 8 * cout).contiguous(), b8.contiguous()
