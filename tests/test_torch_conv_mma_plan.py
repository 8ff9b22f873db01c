"""The launch plans of the tensor-core kernels, on the CPU.

``ops/kernels/conv3d.conv3d_mma_plan`` picks the N tile, the Cin chunk,
the brick, the halo buffers, the dynamic shared memory and the grid of
every K2 launch: of ``csrc/conv3d_mma.cu`` (bfloat16, ``parts=1``) and of
``csrc/conv3d_mma_f32.cu`` (float32 as three bfloat16 parts, two for
k = 7, whose halo bricks and weight slots are that many times as wide;
both instances of ``csrc/conv3d_mma.cuh``).  ``ops/kernels/updown.upsample_mma_plan`` picks
the N tile, the padded Cin, the N split, the shared memory and the grid of
K3's bfloat16 body (``csrc/upsample3d_2x_mma.cu``).  A launch refused for
too much shared memory never runs, so the guard is here, where no card is
needed:

- the bfloat16 flagship V2V forward (64^3, fused and ``use_kernels="conv"``)
  makes exactly the 47 K2 launches and the 5 K3 launches of the tables
  below, recorded on the CPU through the wrappers with the plain versions
  stubbed to empty outputs (the float32 forward makes the same calls);
- for each of them at batch 8, and for the ragged shapes of the GPU tests
  (``tests/test_torch_cuda.py::test_conv3d_mma``, ``test_conv3d_mma_f32``,
  ``test_upsample3d_2x_bf16``), the plan fits the H100 (shared memory <=
  232,448 bytes, grid x < 2^31) and its blocks, decoded from the block
  index as the kernel decodes them, cover every output once;
- the kernels' constants and shared-memory formulas are the plans', and
  the flagship's k = 3 / 7 launches plan onto the (N tile, Cin chunk)
  pairs for which the K2 body has an unrolled instance, in both types.
"""

import collections
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lt_tpu_torch.ops.kernels import conv3d, updown
from lt_tpu_torch.ops.kernels.conv3d import (MMA_SMEM_MAX, conv3d_mma_plan,
                                             mma_block_voxels, mma_smem_bytes,
                                             split_parts)
from lt_tpu_torch.ops.kernels.updown import (UP_MMA_VOXELS, UP_SMEM_MAX,
                                             up_smem_bytes, upsample_mma_plan)

CSRC_DIR = (Path(__file__).resolve().parents[1] / "lt_tpu_torch" / "ops"
            / "kernels" / "csrc")
CSRC = CSRC_DIR / "conv3d_mma.cuh"
UP_CSRC = CSRC_DIR / "upsample3d_2x_mma.cu"
BATCH = 8
# (volume side, Cin, Cout, k): launches per bfloat16 flagship forward.
FLAGSHIP_K2 = {
    (64, 32, 16, 7): 1,                        # front Basic3D
    (64, 16, 32, 3): 1, (64, 16, 32, 1): 1,    # front_res1 conv1, projection
    (64, 32, 32, 3): 9,
    (64, 32, 32, 1): 2, (64, 32, 17, 1): 1,    # back tail, output layer
    (32, 32, 64, 3): 1, (32, 32, 64, 1): 1, (32, 64, 64, 3): 5,
    (16, 64, 128, 3): 1, (16, 64, 128, 1): 1, (16, 128, 128, 3): 5,
    (8, 128, 128, 3): 6, (4, 128, 128, 3): 6, (2, 128, 128, 3): 6,
}
# (input side, Cin, Cout): K3 launches per flagship forward (decoder_upsample
# 5 .. 1), one each.
FLAGSHIP_K3 = {(2, 128, 128): 1, (4, 128, 128): 1, (8, 128, 128): 1,
               (16, 128, 64): 1, (32, 64, 32): 1}
# The GPU tests' K3 shapes: (B, X, Y, Z, Cin), Cout.
RAGGED_K3 = [((2, 3, 2, 5, 64), 32), ((1, 2, 2, 2, 128), 17),
             ((2, 32, 32, 32, 64), 32), ((1, 4, 4, 4, 8), 8),
             ((1, 3, 5, 7, 24), 12), ((3, 1, 1, 1, 40), 100)]
# The GPU test's ragged cases: every (k, Cin, Cout) over these volumes and
# batches.
RAGGED_K = (1, 3, 7)
RAGGED_CH = ((32, 16), (16, 32), (32, 32), (32, 64), (64, 128), (128, 128),
             (32, 17), (24, 40))
RAGGED_VOL = ((2, 2, 2), (5, 6, 7), (1, 3, 5))
RAGGED_BATCH = (1, 3)


def _record_k2_shapes(use_kernels, k3_calls=None):
    """(side, Cin, Cout, k) of every K2 call of one bfloat16 V2V forward at
    64^3, batch 1, on the CPU (outputs stubbed: only shapes matter); the
    K3 calls' (side, Cin, Cout) go to ``k3_calls``."""
    from lt_tpu_torch.models.v2v import V2VModel

    calls = []
    k3_calls = [] if k3_calls is None else k3_calls

    def conv(x, w, bias, residual=None, relu=False, out_dtype=None):
        assert x.dtype == w.dtype == torch.bfloat16
        calls.append((x.shape[1], x.shape[-1], w.shape[-1], w.shape[0]))
        return torch.zeros(*x.shape[:-1], w.shape[-1],
                           dtype=out_dtype or x.dtype)

    def pool(x):
        b, sx, sy, sz, c = x.shape
        return torch.zeros(b, sx // 2, sy // 2, sz // 2, c, dtype=x.dtype)

    def upsample(x, w8, b8, skip=None):
        b, sx, sy, sz, _ = x.shape
        assert x.dtype == w8.dtype == torch.bfloat16
        k3_calls.append((sx, x.shape[-1], w8.shape[1] // 8))
        return torch.zeros(b, 2 * sx, 2 * sy, 2 * sz, w8.shape[1] // 8,
                           dtype=x.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv3d, "conv3d_fused_plain", conv)
        mp.setattr(updown, "max_pool3d_2x_plain", pool)
        mp.setattr(updown, "upsample3d_2x_plain", upsample)
        model = V2VModel(32, 17, use_kernels=use_kernels, device="cpu",
                         compute_dtype=torch.bfloat16)
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 64, 32, dtype=torch.bfloat16))
    return collections.Counter(calls)


@pytest.mark.parametrize("use_kernels", ["fused", "conv"])
def test_flagship_k2_launches_are_the_table(use_kernels):
    got = _record_k2_shapes(use_kernels)
    assert sum(got.values()) == 47
    assert dict(got) == FLAGSHIP_K2


@pytest.mark.parametrize("use_kernels", ["fused", "conv"])
def test_flagship_k3_launches_are_the_table(use_kernels):
    k3 = []
    _record_k2_shapes(use_kernels, k3)
    assert collections.Counter(k3) == FLAGSHIP_K3


def _blocks(plan, shape, k):
    """Each block's (batch, x0, y0, z0, co0), decoded from blockIdx.x as
    conv3d_mma.cuh decodes it (channel tile fastest, then z, y, x, batch)."""
    b, sx, sy, sz, _, cout = shape
    bx, by, bz = plan.brick
    tx, ty, tz = (math.ceil(s / e) for s, e in zip((sx, sy, sz), plan.brick))
    ntiles = math.ceil(cout / plan.nt)
    idx = np.arange(plan.grid, dtype=np.int64)
    nt = idx % ntiles
    idx //= ntiles
    z0 = (idx % tz) * bz
    idx //= tz
    y0 = (idx % ty) * by
    idx //= ty
    x0 = (idx % tx) * bx
    return idx // tx, x0, y0, z0, nt * plan.nt


def _check_plan(b, sx, sy, sz, cin, cout, k, full_cover, parts=1):
    plan = conv3d_mma_plan(b, sx, sy, sz, cin, cout, k, parts)
    assert plan.smem <= MMA_SMEM_MAX
    assert plan.smem == mma_smem_bytes(plan.nt, plan.ck, k, plan.brick,
                                       plan.nh, parts)
    grid = (plan.grid, 1, 1)          # the kernel's grid: one dimension
    assert grid[0] < 2 ** 31 and grid[1] <= 65535 and grid[2] <= 65535
    assert math.prod(plan.brick) <= mma_block_voxels(plan.nt)
    assert plan.nt in (16, 24, 32, 64) and plan.ck in (16, 32)
    nchunks = math.ceil(cin / plan.ck)
    assert 1 <= plan.nh <= nchunks
    bi, x0, y0, z0, co0 = _blocks(plan, (b, sx, sy, sz, cin, cout), k)
    # Every block starts inside the output: no brick is empty.
    assert (bi < b).all() and (x0 < sx).all() and (y0 < sy).all()
    assert (z0 < sz).all() and (co0 < cout).all()
    # Bricks tile each axis with no gap and no overlap, and every
    # combination of tiles appears exactly once.
    bx, by, bz = plan.brick
    for starts, step, side in ((x0, bx, sx), (y0, by, sy), (z0, bz, sz),
                               (co0, plan.nt, cout)):
        u = np.unique(starts)
        assert (u == np.arange(0, side, step)).all()
        assert u[-1] + step >= side
    keys = np.stack([bi, x0, y0, z0, co0], 1)
    assert len(np.unique(keys, axis=0)) == plan.grid
    if full_cover:
        hits = np.zeros((b, sx, sy, sz, cout), np.int32)
        for n, x, y, z, c in keys:
            hits[n, x:x + bx, y:y + by, z:z + bz, c:c + plan.nt] += 1
        assert (hits == 1).all()
    return plan


@pytest.mark.parametrize("side, cin, cout, k", sorted(FLAGSHIP_K2))
def test_plan_of_each_flagship_launch(side, cin, cout, k):
    plan = _check_plan(BATCH, side, side, side, cin, cout, k,
                       full_cover=side <= 8)
    # The flagship's shapes all take the large brick, one N tile where
    # Cout <= 64 and the prefetched halo (two buffers where Cin has two or
    # more chunks).
    assert plan.brick == ((4, 8, 8) if cout <= 32 else (4, 4, 8))
    assert plan.nt == (16 if cout <= 16 else 24 if cout <= 24 else
                       32 if cout <= 32 else 64)
    assert plan.nh == min(math.ceil(cin / plan.ck), 2 if k > 1 else 3)


@pytest.mark.parametrize("side, cin, cout, k", sorted(FLAGSHIP_K2))
def test_split_plan_of_each_flagship_launch(side, cin, cout, k):
    """The float32 body's plans: three times the halo row and weight slot
    (twice for k = 7), so the k = 7 front conv takes CK = 16 and one halo
    buffer, reloaded for its second chunk, and the k = 3 64-channel tiles
    one buffer reloaded per chunk; every flagship launch keeps its brick,
    its N tile and its Cin chunk of bfloat16."""
    plan = _check_plan(BATCH, side, side, side, cin, cout, k,
                       full_cover=side <= 8, parts=split_parts(k))
    bf16 = conv3d_mma_plan(BATCH, side, side, side, cin, cout, k)
    assert (plan.brick, plan.nt) == (bf16.brick, bf16.nt)
    if k == 7:
        assert (plan.ck, plan.nh) == (16, 1)
    else:
        assert plan.ck == bf16.ck
        assert plan.nh == (1 if k == 3 and cout >= 64 else bf16.nh)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cin, cout", RAGGED_CH)
@pytest.mark.parametrize("k", RAGGED_K)
def test_plan_of_ragged_shapes(k, cin, cout, dtype):
    parts = 1 if dtype == "bfloat16" else split_parts(k)
    for b, vol in itertools.product(RAGGED_BATCH, RAGGED_VOL):
        _check_plan(b, *vol, cin, cout, k, full_cover=True, parts=parts)


@pytest.mark.parametrize("b, vol, k, cin, cout", [
    (1, (5, 6, 7), 3, 17, 20), (1, (5, 6, 7), 1, 5, 3),
    (2, (5, 6, 7), 7, 12, 8), (1, (6, 5, 7), 9, 128, 64),
    (2, (9, 10, 11), 11, 128, 128), (2, (9, 10, 11), 15, 128, 128),
    (2, (9, 10, 11), 13, 32, 17)])
def test_plan_of_odd_channels_and_large_kernels(b, vol, k, cin, cout):
    """The GPU test's element-path and large-k shapes (and two larger k),
    in both types: one halo buffer reloaded per chunk, CK = 16 or a smaller
    brick where the large plan does not fit.  The float32 body's doubled
    halo leaves no brick for k = 13 and 15 (it takes k <= 11)."""
    for parts in (1, split_parts(k)):
        if parts == 2 and k > 11:
            with pytest.raises(ValueError, match="no brick fits"):
                conv3d_mma_plan(b, *vol, cin, cout, k, parts)
            continue
        plan = _check_plan(b, *vol, cin, cout, k, full_cover=True,
                           parts=parts)
        if k >= 9:
            assert plan.nh == 1 and math.ceil(cin / plan.ck) > 1


def test_plan_refuses_what_cannot_fit():
    for parts in (1, 2, 3):
        with pytest.raises(ValueError, match="no brick fits"):
            conv3d_mma_plan(1, 8, 8, 8, 512, 512, 25, parts)
    with pytest.raises(ValueError, match="does not fit"):
        upsample_mma_plan(1, 2, 2, 2, 1024, 64)


def test_kernel_constants_are_the_plans():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1))

    assert "return nt <= 32 ? 256 : 128;" in src       # block_voxels
    assert [mma_block_voxels(n) for n in (16, 24, 32, 64)] == [256, 256,
                                                               256, 128]
    assert "block_voxels(nt) * ((nt + 4) * 4 + 8)" in src   # smem_bytes
    assert ("(bx + k - 1) * (by + k - 1) * (bz + k - 1) * "
            "odd_pitch(parts * ck)") in src
    assert "nh * halo + kStages * parts * k * ck * odd_pitch(nt)" in src
    assert const("kStages") == conv3d.MMA_STAGES
    assert const("kSmemMax") == MMA_SMEM_MAX
    # The kernel's smem_bytes and odd_pitch are the formula of
    # mma_smem_bytes: spot-check the pitches it pads rows to.
    assert [conv3d._odd_pitch(n) for n in (16, 24, 32, 64)] == [48, 80, 80,
                                                                144]


@pytest.mark.parametrize("k, parts, pairs", [
    (3, 1, {(32, 16), (32, 32), (64, 32)}), (7, 1, {(16, 32)}),
    (3, 3, {(32, 16), (32, 32), (64, 32)}), (7, 2, {(16, 16)})])
def test_flagship_plans_take_the_unrolled_instances(k, parts, pairs):
    """conv3d_mma.cuh makes k = 3 and 7 template constants only for the
    (N tile, Cin chunk) pairs of its unrolled(); the flagship's k = 3 / 7
    launches must plan onto exactly those pairs, in bfloat16 (parts = 1)
    and in float32 (the parts split_parts gives k)."""
    assert parts in (1, split_parts(k))
    src = CSRC.read_text()
    assert ("return k == 3 ? PARTS != 2 && (NT == 32 || (NT == 64 && CK == 32))"
            "\n                : k == 7 && PARTS != 3 && NT == 16 &&\n"
            "                      CK == (PARTS == 2 ? 16 : 32);") in src

    def unrolled(nt, ck, kk):
        return (parts != 2 and (nt == 32 or (nt == 64 and ck == 32))
                if kk == 3 else
                kk == 7 and parts != 3 and nt == 16
                and ck == (16 if parts == 2 else 32))

    got = {(p.nt, p.ck) for p in (
        conv3d_mma_plan(BATCH, side, side, side, cin, cout, kk, parts)
        for side, cin, cout, kk in FLAGSHIP_K2 if kk == k)}
    assert got == pairs
    assert all(unrolled(nt, ck, k) for nt, ck in got)


def _check_up_plan(b, sx, sy, sz, cin, cout):
    """upsample_mma_plan fits and its blocks, decoded as
    upsample3d_2x_mma.cu decodes them (N split fastest, then the M tile),
    cover every (input voxel, packed column) exactly once."""
    plan = upsample_mma_plan(b, sx, sy, sz, cin, cout)
    assert plan.smem == up_smem_bytes(plan.nt, plan.kp) <= UP_SMEM_MAX
    assert plan.nt in (16, 32, 64) and plan.kp % 16 == 0
    assert cin <= plan.kp < cin + 16
    assert plan.grid < 2 ** 31
    ntn = math.ceil(2 * cout / plan.nt)
    steps = 4 * ntn
    nvox = b * sx * sy * sz
    mtiles = math.ceil(nvox / UP_MMA_VOXELS)
    assert plan.nsplit == math.ceil(steps / plan.per)
    assert plan.grid == mtiles * plan.nsplit
    hits = np.zeros((mtiles * UP_MMA_VOXELS, 8 * cout), np.int32)
    for bid in range(plan.grid):
        split, mt = bid % plan.nsplit, bid // plan.nsplit
        s0 = split * plan.per
        assert s0 < steps                    # no block without work
        for s in range(s0, min(s0 + plan.per, steps)):
            pair, n0 = s // ntn, (s % ntn) * plan.nt
            c0 = pair * 2 * cout + n0
            c1 = min(c0 + plan.nt, (pair + 1) * 2 * cout)
            hits[mt * UP_MMA_VOXELS:(mt + 1) * UP_MMA_VOXELS, c0:c1] += 1
    assert (hits == 1).all()
    return plan


@pytest.mark.parametrize("side, cin, cout", sorted(FLAGSHIP_K3))
def test_upsample_plan_of_each_flagship_launch(side, cin, cout):
    """At batch 8: one 64-column N tile and Cin whole in shared memory;
    the levels with few M tiles split their N tiles across blocks (2^3:
    one M tile, 16 blocks), the 32^3 level (2048 M tiles) does not."""
    plan = _check_up_plan(BATCH, side, side, side, cin, cout)
    assert plan.nt == 64 and plan.kp == cin
    assert (plan.nsplit, plan.grid) == {2: (16, 16), 4: (16, 64),
                                        8: (8, 256), 16: (2, 512),
                                        32: (1, 2048)}[side]


@pytest.mark.parametrize("shape, cout", RAGGED_K3)
def test_upsample_plan_of_ragged_shapes(shape, cout):
    _check_up_plan(*shape, cout)


def test_upsample_kernel_constants_are_the_plans():
    src = UP_CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1))

    assert const("kM") == UP_MMA_VOXELS
    assert const("kSmemMax") == UP_SMEM_MAX
    assert ("return kM * odd_pitch(kp) + 2 * kp * odd_pitch(nt) + "
            "kM * (nt + 4) * 4 +\n         kM * 8;") in src
