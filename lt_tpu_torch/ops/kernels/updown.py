"""MaxPool3d(2) (kernel K4) and the fused 2x transposed conv (kernel K3).

Port of ``lt_tpu/ops/pallas/updown.py:98-416``.  CUDA kernels:
``csrc/max_pool3d_2x.cu`` (a 16-byte streaming pass, launched with the plan
of :func:`pool_plan`); K3 ``csrc/upsample3d_2x.cu`` (float32, a
register-tiled GEMM on the CUDA cores, launched with the plan of
:func:`upsample_f32_plan`) and ``csrc/upsample3d_2x_mma.cu`` (bfloat16,
tensor cores, the plan of :func:`upsample_mma_plan`); the ``*_plain``
functions are their plain versions.  NDHWC layout.  Volumes (and K3's
packed weights and skip) are float32 or bfloat16, one type per call; K3's
bias is float32, its sum, ReLU and skip add float32, rounded once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from lt_tpu_torch.ops.kernels import _build
from lt_tpu_torch.ops.kernels.conv3d import BN_EPS, _odd_pitch


def max_pool3d_2x_plain(x: torch.Tensor) -> torch.Tensor:
    b, sx, sy, sz, c = x.shape
    return x.reshape(b, sx // 2, 2, sy // 2, 2, sz // 2, 2, c).amax(
        dim=(2, 4, 6))


# max_pool3d_2x.cu's launch constants: threads a block aims at, and the
# largest grid y / z extent.
POOL_THREADS = 256
GRID_YZ_MAX = 65535


class PoolPlan(NamedTuple):
    """One max_pool3d_2x launch: elements per thread (16 bytes' worth, or
    1 for the scalar instance), the block (channel vectors x output z) and
    the grid (output z blocks, Y/2, B * X/2)."""
    vec: int
    bx: int
    by: int
    gx: int
    gy: int
    gz: int

    @property
    def args(self):
        return tuple(self)


@functools.lru_cache(maxsize=None)
def pool_plan(b: int, sx: int, sy: int, sz: int, c: int, dtype: torch.dtype,
              aligned: bool) -> PoolPlan:
    """The launch plan of max_pool3d_2x over a (b, sx, sy, sz, c) input of
    ``dtype`` whose base pointer is 16-byte aligned or not.

    The vector instance takes 16 bytes of channels a thread where C fills
    them and the pointer is aligned, else the scalar instance one channel.
    The block's x runs over a voxel's channel vectors (at most
    POOL_THREADS, looping over the rest), its y over output z, up to
    POOL_THREADS threads.  Raises where the input holds 2^31 elements or
    more (the kernel's offsets are 32-bit) or the grid exceeds its limits.
    """
    numel = b * sx * sy * sz * c
    if numel >= 2 ** 31:
        raise ValueError(f"max_pool3d_2x: {numel} elements, the kernel "
                         f"takes fewer than 2^31")
    wide = 16 // dtype.itemsize
    vec = wide if aligned and c % wide == 0 else 1
    bx = min(c // vec, POOL_THREADS)
    by = max(1, min(POOL_THREADS // bx, sz // 2))
    gy, gz = sy // 2, b * (sx // 2)
    if max(gy, gz) > GRID_YZ_MAX:
        raise ValueError(f"max_pool3d_2x: grid ({gy}, {gz}) over "
                         f"{GRID_YZ_MAX} in y or z")
    return PoolPlan(vec, bx, by, math.ceil(sz // 2 / by), gy, gz)


def max_pool3d_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(kernel=2, stride=2) over (B, X, Y, Z, C), all dims even;
    NaN where a window holds one.  K4 on CUDA, plain on CPU."""
    b, sx, sy, sz, c = x.shape
    if sx % 2 or sy % 2 or sz % 2:
        raise ValueError(f"max_pool3d_2x needs even dims, got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return max_pool3d_2x_plain(x)
    _build.check_cuda(x, "x", dtypes=_build.F32_BF16)
    out = torch.empty((b, sx // 2, sy // 2, sz // 2, c), dtype=x.dtype,
                      device=x.device)
    plan = pool_plan(b, sx, sy, sz, c, x.dtype, x.data_ptr() % 16 == 0)
    p, i = _build.ptr, _build.i32
    _build.launch("max_pool3d_2x", x.device, [p, p] + [i] * 12,
                  x.data_ptr(), out.data_ptr(), b, sx, sy, sz, c,
                  _build.DTYPE_CODES[x.dtype], *plan.args)
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


# upsample3d_2x_mma.cu's launch constants: input voxels per block, and the
# shared memory one block may hold on the H100.
UP_MMA_VOXELS = 128
UP_SMEM_MAX = 232448
# Blocks a launch should reach before its N tiles are split across blocks:
# two for each of the H100's 132 SMs.
UP_TARGET_BLOCKS = 264


def up_smem_bytes(nt: int, kp: int) -> int:
    """upsample3d_2x_mma.cu's ``up_smem_bytes``: the A tile, the two-slot
    B ring, the epilogue's float32 tile and the row offsets."""
    m = UP_MMA_VOXELS
    return (m * _odd_pitch(kp) + 2 * kp * _odd_pitch(nt) + m * (nt + 4) * 4
            + m * 8)


class UpPlan(NamedTuple):
    """One upsample3d_2x_mma launch: N tile, Cin padded to 16, steps (N
    tiles) per block, blocks per M tile, dynamic shared memory (bytes),
    blocks (a 1-D grid)."""
    nt: int
    kp: int
    per: int
    nsplit: int
    smem: int
    grid: int

    @property
    def args(self):
        return tuple(self)


@functools.lru_cache(maxsize=None)
def upsample_mma_plan(b: int, sx: int, sy: int, sz: int, cin: int,
                      cout: int) -> UpPlan:
    """The launch plan of upsample3d_2x_mma.

    N tile: the least of 16 / 32 / 64 that holds a (dx, dy) pair's 2 Cout
    columns, else 64.  Steps: 4 pairs x N tiles per pair.  M tiles of
    UP_MMA_VOXELS input voxels; where they number fewer than
    UP_TARGET_BLOCKS the steps are split across blocks (each block then
    takes ``per`` consecutive steps).
    """
    nt = next((t for t in (16, 32, 64) if 2 * cout <= t), 64)
    kp = math.ceil(cin / 16) * 16
    smem = up_smem_bytes(nt, kp)
    if smem > UP_SMEM_MAX:
        raise ValueError(f"upsample3d_2x_mma: Cin={cin} does not fit "
                         f"{UP_SMEM_MAX} bytes of shared memory")
    mtiles = math.ceil(b * sx * sy * sz / UP_MMA_VOXELS)
    per, nsplit = _split_steps(4 * math.ceil(2 * cout / nt), mtiles)
    return UpPlan(nt, kp, per, nsplit, smem, mtiles * nsplit)


def _split_steps(steps: int, mtiles: int):
    """(steps per block, blocks per M tile): the steps (pairs x N tiles)
    split across blocks where the M tiles number fewer than
    UP_TARGET_BLOCKS, each block taking ``per`` consecutive steps."""
    want = min(steps, max(1, math.ceil(UP_TARGET_BLOCKS / mtiles)))
    per = math.ceil(steps / want)
    return per, math.ceil(steps / per)


# upsample3d_2x.cu's (float32) launch constants: input voxels per block,
# columns per N tile, and the padded row of the transposed A tile.
UP_F32_VOXELS = 128
UP_F32_NT = 64
UP_F32_APITCH = UP_F32_VOXELS + 4


def up_f32_smem_bytes(kp: int) -> int:
    """upsample3d_2x.cu's ``up_f32_smem_bytes``: the transposed A tile, the
    two-slot B ring and the row offsets."""
    return (kp * UP_F32_APITCH * 4 + 2 * kp * UP_F32_NT * 4
            + UP_F32_VOXELS * 8)


class UpF32Plan(NamedTuple):
    """One float32 upsample3d_2x launch: Cin padded to 8, steps (N tiles)
    per block, blocks per M tile, dynamic shared memory (bytes), blocks."""
    kp: int
    per: int
    nsplit: int
    smem: int
    grid: int

    @property
    def args(self):
        return tuple(self)


@functools.lru_cache(maxsize=None)
def upsample_f32_plan(b: int, sx: int, sy: int, sz: int, cin: int,
                      cout: int) -> UpF32Plan:
    """The launch plan of the float32 upsample3d_2x: M tiles of
    UP_F32_VOXELS input voxels, N tiles of UP_F32_NT columns of one (dx,
    dy) pair, Cin whole in shared memory; steps split across blocks as in
    :func:`upsample_mma_plan`."""
    kp = math.ceil(cin / 8) * 8
    smem = up_f32_smem_bytes(kp)
    if smem > UP_SMEM_MAX:
        raise ValueError(f"upsample3d_2x: Cin={cin} does not fit "
                         f"{UP_SMEM_MAX} bytes of shared memory")
    mtiles = math.ceil(b * sx * sy * sz / UP_F32_VOXELS)
    per, nsplit = _split_steps(4 * math.ceil(2 * cout / UP_F32_NT), mtiles)
    return UpF32Plan(kp, per, nsplit, smem, mtiles * nsplit)


def upsample3d_2x(x: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                  skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused ConvTranspose3d(2, 2) + folded BN + ReLU [+ skip added after
    the ReLU]: K3 on CUDA (float32: upsample3d_2x; bfloat16:
    upsample3d_2x_mma), plain on CPU.

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
    args = (x.data_ptr(), w8.data_ptr(), bias.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(),
            b, sx, sy, sz, cin, cout, _build.DTYPE_CODES[x.dtype])
    bf16 = x.dtype == torch.bfloat16
    plan = (upsample_mma_plan if bf16 else upsample_f32_plan)(
        b, sx, sy, sz, cin, cout).args
    _build.launch("upsample3d_2x_mma" if bf16 else "upsample3d_2x", x.device,
                  [p] * 5 + [i] * (7 + len(plan)), *args, *plan)
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
