"""BN folding and the fused 'same' 3D convolution (kernel K2).

Port of ``lt_tpu/ops/pallas/conv3d.py``: ``fold_bn`` (:233-244),
``conv3d_same`` (:126-230), and the convolution inside every V2V Pallas
kernel.  K2 runs on the tensor cores, one body (``csrc/conv3d_mma.cuh``)
in two instances, launched with the plan of :func:`conv3d_mma_plan`:
``csrc/conv3d_mma.cu`` for bfloat16 inputs, and ``csrc/conv3d_mma_f32.cu``
for float32 inputs, each given as its bfloat16 parts (:func:`split_bf16`:
v1 = bf16(v), v2 = bf16(v - v1), ...) and summed over the products of
parts i + j < parts (:func:`conv3d_split`): three parts and six products
for k <= 3, two parts and three products for the k = 7 front conv
(:func:`split_parts`).  ``V2VModel`` packs its float32 weights as their
parts, once per weight version; :func:`conv3d_fused` splits whole float32
weights on each call.  :func:`conv3d_fused_plain` is K2's plain version,
in true float32.  Layouts follow ``lt_tpu``: NDHWC
activations, DHWIO weights.

Types, as in the Pallas bodies: activations and weights are float32 or
bfloat16 (one type for x, w and the residual), the bias is float32, the sum
is float32, and the output is rounded once into ``out_dtype`` (default: the
activation type).  ``lt_tpu``'s ``conv3d_same`` also carries its partial
sums between planes in the activation type; K2 does not, a difference of
bfloat16 rounding order and not of function.  In float32 the two-part
split drops the v2*w2 term and the rounding of the v2 parts, about 2^-16
relative per product (``lt_tpu``'s float32 Pallas unprojection computes its
products the same way), the three-part one about 2^-24: K2 holds relative
1e-4 of max |output|.
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


# conv3d_mma.cuh's launch constants: weight ring slots, and the shared
# memory one block may hold on the H100.
MMA_STAGES = 3
MMA_SMEM_MAX = 232448
# Bricks (x, y, z) in order of preference, Z (contiguous) longest; a
# smaller one only where a large k leaves no room for the first.
MMA_BRICKS = ((4, 8, 8), (4, 4, 8), (2, 4, 8), (2, 2, 8), (1, 2, 8),
              (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1))


def mma_block_voxels(nt: int) -> int:
    """Output voxels per block (conv3d_mma.cuh's ``block_voxels``): 256 for
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
    an odd number of 16-byte units (mma.cuh's ``odd_pitch``)."""
    units = elems // 8 + 1
    return (units if units % 2 else units + 1) * 16


def mma_smem_bytes(nt: int, ck: int, k: int, brick, nh: int,
                   parts: int = 1) -> int:
    """conv3d_mma.cuh's ``smem_bytes``: nh haloed input bricks and the
    weight ring, or the epilogue's float32 tile and row offsets if larger.
    ``parts``: 1, or 2 / 3 for the float32 body, whose halo rows and
    weight slots hold every part."""
    bx, by, bz = brick
    halo = (bx + k - 1) * (by + k - 1) * (bz + k - 1) * _odd_pitch(parts * ck)
    main = nh * halo + MMA_STAGES * parts * k * ck * _odd_pitch(nt)
    return max(main, mma_block_voxels(nt) * ((nt + 4) * 4 + 8))


@functools.lru_cache(maxsize=None)
def conv3d_mma_plan(b: int, sx: int, sy: int, sz: int, cin: int, cout: int,
                    k: int, parts: int = 1) -> MmaPlan:
    """The launch plan of conv3d_mma (``parts`` = 1, bfloat16) or
    conv3d_mma_f32 (``parts`` = :func:`split_parts`, the bfloat16 parts of
    float32) for one K2 call.

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
                    smem = mma_smem_bytes(nt, ck, k, brick, nh, parts)
                    if smem > MMA_SMEM_MAX:
                        continue
                    tiles = [math.ceil(s / e) for s, e in zip((sx, sy, sz),
                                                              brick)]
                    grid = b * math.prod(tiles) * math.ceil(cout / nt)
                    return MmaPlan(nt, ck, brick, nh, smem, grid)
    raise ValueError(f"conv3d_mma: no brick fits k={k}, Cin={cin}, "
                     f"Cout={cout} in {MMA_SMEM_MAX} bytes of shared memory")


def split_parts(k: int) -> int:
    """The bfloat16 parts of each float32 operand of a K2 call with kernel
    size k: 3 (six products, about 2^-24 relative) for k <= 3; 2 (three
    products, about 2^-16) for larger k, whose three-part haloed brick
    would not fit the shared memory with the large brick.  Three products
    hold each launch to 1e-5 of its output, but through V2V's chain of
    them the flagship's float32 volumes came to 9.3e-5 of the plain path's
    on an H100, against a limit of 1e-4; 4.8e-5 with six for k <= 3."""
    return 3 if k <= 3 else 2


def split_bf16_plain(v: torch.Tensor, parts: int = 2) -> torch.Tensor:
    """Plain version of split_bf16: (parts, *v.shape) bfloat16, v1 =
    bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2), each rounded to
    nearest even (the differences are exact in float32); an infinity's
    parts are (0, ..., 0, +-inf), so that in :func:`conv3d_split_plain`
    and the kernel an infinite x meets only w's first part (true
    float32's inf * w); NaN's are all NaN."""
    big = v.isinf()
    out, r = [], v.masked_fill(big, 0.0)
    for p in range(parts):
        if p == parts - 1:
            r = torch.where(big, v, r)
        out.append(r.to(torch.bfloat16))
        r = r - out[-1].float()
    return torch.stack(out)


def split_bf16(v: torch.Tensor, parts: int = 2) -> torch.Tensor:
    """A float32 tensor's bfloat16 parts, (parts, *v.shape), parts 2 or 3:
    their sum is within 2^-16 (2 parts) or 2^-24 (3) relative of v.  The
    kernel split_bf16 (csrc/conv3d_mma_f32.cu) on CUDA, plain on CPU."""
    if v.dtype != torch.float32:
        raise TypeError(f"split_bf16 takes float32, got {v.dtype}")
    if parts not in (2, 3):
        raise ValueError(f"split_bf16 makes 2 or 3 parts, not {parts}")
    if not v.is_cuda:
        return split_bf16_plain(v, parts)
    _build.check_cuda(v, "v")
    out = torch.empty((parts, *v.shape), dtype=torch.bfloat16,
                      device=v.device)
    p = _build.ptr
    _build.launch("split_bf16", v.device, [p, p, _build.i64, _build.i32],
                  v.data_ptr(), out.data_ptr(), v.numel(), parts)
    return out


def pointwise(w: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 convolution's (Cin, Cout) weights, or their (parts, Cin,
    Cout) bfloat16 parts, as K2's (1, 1, 1, Cin, Cout) kernel (its parts)."""
    return w.reshape(*w.shape[:-2], 1, 1, 1, *w.shape[-2:])


def conv3d_split_plain(xs: torch.Tensor, ws: torch.Tensor,
                       bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False, out_dtype=None) -> torch.Tensor:
    """Plain version of conv3d_mma_f32: the products of the parts x_i *
    w_j with i + j < parts as float32 ``F.conv3d`` over the bfloat16 parts
    (each product exact in float32), then bias, residual and ReLU in
    float32, rounded once."""
    parts, k = xs.shape[0], ws.shape[1]
    xf, wf = xs.float(), ws.float()
    y = sum(F.conv3d(xf[i].permute(0, 4, 1, 2, 3),
                     wf[j].permute(4, 3, 0, 1, 2), padding=(k - 1) // 2)
            for i in range(parts) for j in range(parts - i))
    y = y.permute(0, 2, 3, 4, 1) + bias
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or torch.float32).contiguous()


def _check_conv(x, w, residual):
    b, sx, sy, sz, cin = x.shape
    k = w.shape[0]
    cout = w.shape[-1]
    if tuple(w.shape) != (k, k, k, cin, cout) or k % 2 == 0:
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (want odd (k, k, k, Cin, Cout))")
    if residual is not None and tuple(residual.shape) != (b, sx, sy, sz, cout):
        raise ValueError(f"residual {tuple(residual.shape)} != output shape")


def _launch_mma(kernel, x, w, bias, residual, relu, out_dtype, in_dtype,
                parts):
    """One conv3d_mma / conv3d_mma_f32 launch; x and w are the bfloat16
    operands ((parts, ...) for conv3d_mma_f32, which also takes parts)."""
    b, sx, sy, sz, cin = x.shape[-5:]
    k, cout = w.shape[-5], w.shape[-1]
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype: kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, t in (("x", x), ("w", w)):
        _build.check_cuda(t, name, dtypes=(torch.bfloat16,))
    if residual is not None:
        _build.check_cuda(residual, "residual", dtypes=(in_dtype,))
    _build.check_cuda(bias, "bias")
    out = torch.empty((b, sx, sy, sz, cout), dtype=out_dtype, device=x.device)
    plan = conv3d_mma_plan(b, sx, sy, sz, cin, cout, k, parts).args
    if parts > 1:
        plan += (parts,)
    p, i = _build.ptr, _build.i32
    _build.launch(kernel, x.device, [p] * 5 + [i] * (10 + len(plan)),
                  x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  out.data_ptr(), b, sx, sy, sz, cin, cout, k, int(relu),
                  _build.DTYPE_CODES[in_dtype], _build.DTYPE_CODES[out_dtype],
                  *plan)
    return out


def conv3d_split(xs: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None, relu: bool = False,
                 out_dtype=None) -> torch.Tensor:
    """K2 for float32 inputs given as their bfloat16 parts: conv3d_mma_f32
    on CUDA, :func:`conv3d_split_plain` on CPU.

    Args:
      xs: (parts, B, X, Y, Z, Cin), the parts of x (:func:`split_bf16`);
      ws: (parts, k, k, k, Cin, Cout), those of w, parts =
      :func:`split_parts` (k); bias: (Cout,) float32; residual:
      optional float32 (B, X, Y, Z, Cout), added before the ReLU;
      out_dtype: float32 (default) or bfloat16.
    """
    out_dtype = out_dtype or torch.float32
    if xs.dim() != 6 or ws.dim() != 6 or xs.shape[0] != ws.shape[0] or (
            xs.shape[0] != split_parts(ws.shape[1])):
        raise ValueError(f"conv3d_split takes split_parts(k) parts of x and "
                         f"w, got {tuple(xs.shape)} and {tuple(ws.shape)}")
    _check_conv(xs[0], ws[0], residual)
    if xs.dtype != torch.bfloat16 or ws.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_split takes bfloat16 parts, got {xs.dtype} "
                        f"and {ws.dtype}")
    if residual is not None and residual.dtype != torch.float32:
        raise TypeError(f"residual is {residual.dtype}: K2 in float32 takes "
                        f"a float32 residual")
    if not xs.is_cuda:
        return conv3d_split_plain(xs, ws, bias, residual, relu, out_dtype)
    return _launch_mma("conv3d_mma_f32", xs, ws, bias, residual, relu,
                       out_dtype, torch.float32, xs.shape[0])


def conv3d_fused(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """'same' conv3d + bias [+ residual] [+ ReLU]: K2 on CUDA (bfloat16
    inputs: conv3d_mma; float32: split_bf16 of x and, if they come whole,
    of w, then conv3d_mma_f32), plain on CPU.

    Args:
      x: (B, X, Y, Z, Cin), float32 or bfloat16; w: (k, k, k, Cin, Cout), k
      odd, in x's type, or for float32 x the bfloat16 parts of float32
      weights, (:func:`split_parts` (k), k, k, k, Cin, Cout) from
      :func:`split_bf16` (``V2VModel`` packs them so, once per weight
      version); bias: (Cout,) float32; residual: optional (B, X, Y, Z,
      Cout) in x's type, added before the ReLU; out_dtype: float32 or
      bfloat16 (default: x's type).  On the card the plan raises where k
      leaves no brick that fits the shared memory (float32: k > 11;
      bfloat16: k > 15).
    """
    out_dtype = out_dtype or x.dtype
    if w.dim() == 6:                # the parts of float32 weights
        if x.dtype != torch.float32:
            raise TypeError(f"x is {x.dtype}: the bfloat16 parts of "
                            f"weights go with float32 x")
        return conv3d_split(split_bf16(x, w.shape[0]), w, bias, residual,
                            relu, out_dtype)
    _check_conv(x, w, residual)
    for name, t in (("w", w), ("residual", residual)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}: K2 "
                            f"takes one type for x, w and the residual")
    if not x.is_cuda:
        return conv3d_fused_plain(x, w, bias, residual, relu, out_dtype)
    _build.check_cuda(x, "x", dtypes=_build.F32_BF16)
    if x.dtype == torch.float32:
        _build.check_cuda(w, "w")
        return conv3d_fused(x, split_bf16(w, split_parts(w.shape[0])), bias,
                            residual, relu, out_dtype)
    return _launch_mma("conv3d_mma", x, w, bias, residual, relu, out_dtype,
                       torch.bfloat16, 1)


def conv3d_same(x: torch.Tensor, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None, relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                out_dtype=None) -> torch.Tensor:
    """3x3x3 stride-1 zero-pad-1 conv over NDHWC input, ``lt_tpu``'s
    ``conv3d_same``: one K2 launch (K2 computes this function for any odd
    k; the TPU's slab schedule stays behind).

    Args:
      x: (B, X, Y, Z, Cin), float32 or bfloat16.
      weights: (3, 3, 3, Cin, Cout); cast to x's type, as ``lt_tpu`` casts;
        or, for float32 x, their bfloat16 parts (:func:`conv3d_fused`).
      bias: optional (Cout,), added in float32 before ``residual`` / ``relu``
        (fold BN in with :func:`fold_bn`).
      residual: optional (B, X, Y, Z, Cout) skip added before the ReLU; cast
        to x's type.
      out_dtype: output type (default: x's).
    """
    if weights.dim() not in (5, 6) or tuple(weights.shape[-5:-2]) != (3, 3,
                                                                      3):
        raise ValueError(f"conv3d_same takes (3, 3, 3, Cin, Cout) weights, "
                         f"got {tuple(weights.shape)}")
    cout = weights.shape[-1]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    if residual is not None:
        residual = residual.to(x.dtype)
    if x.dtype == torch.bfloat16:
        bias = bias.float()
    if weights.dim() == 5:
        weights = weights.to(x.dtype)
    return conv3d_fused(x, weights, bias, residual, relu, out_dtype)
