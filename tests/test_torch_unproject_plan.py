"""The launch plans of K1 (``csrc/unproject_agg.cu``) and of the float32 K3
(``csrc/upsample3d_2x.cu``), and K1's staged windows, on the CPU.

``ops/kernels/unproject.unproject_plan`` picks K1's window budget,
channel chunk, dynamic shared memory and grid of 4 x 8 x 8 bricks;
``brick_windows`` computes, in plain PyTorch, the pixel box of each
(brick, view) that the kernel
stages.  ``ops/kernels/updown.upsample_f32_plan`` picks the float32 K3's
padded Cin, N split, shared memory and grid.  A launch refused for too
much shared memory never runs, so the guard is here, where no card is
needed:

- every plan fits the H100 (shared memory <= 232,448 bytes; with staged
  windows K1 leaves room for two blocks on an SM in float32), and the
  kernels' constants and shared-memory formulas are the plans';
- at the flagship geometry (``utils/example.py``'s rig, all 8 samples, a
  2500 mm cuboid, 96^2 maps, 64^3) every 4 x 8 x 8 (brick, view) window
  fits the budget, so where windows are staged no brick reads its taps
  from device memory;
- a brute-force walk over the voxels of small grids puts every voxel's
  taps that lie in the map inside its brick's scatter box, and every tap
  of a voxel in front of the camera, clamped to the map, inside its
  brick's K1 window, each side of a box on one of them;
- K1 modelled brick by brick (taps at their clamped pixels with weight 0
  off the map, read from the staged window or the map, the online softmax
  whose +inf logit gives NaN) equals the plain version, NaN, infinities
  and finite values, with NaN and infinities on the maps' edges;
- the float32 K3's blocks, decoded as the kernel decodes them, cover
  every (input voxel, packed column) once.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lt_tpu_torch.models.triangulation import (rescale_proj_to_heatmap,
                                               select_base_points)
from lt_tpu_torch.ops import volumetric as vol_ops
from lt_tpu_torch.ops.kernels import sample, unproject, updown
from lt_tpu_torch.ops.kernels.sample import _project
from lt_tpu_torch.ops.kernels.unproject import (AGG_BRICK, AGG_CHUNK,
                                                AGG_SMEM_MAX, AGG_WINDOW,
                                                agg_smem_bytes,
                                                brick_windows,
                                                compose_grid_projection,
                                                unproject_plan)
from lt_tpu_torch.ops.kernels.updown import (UP_F32_APITCH, UP_F32_NT,
                                             UP_F32_VOXELS, UP_SMEM_MAX,
                                             up_f32_smem_bytes,
                                             upsample_f32_plan)
from lt_tpu_torch.utils.example import example_batch

CSRC = (Path(__file__).resolve().parents[1] / "lt_tpu_torch" / "ops"
        / "kernels" / "csrc")
# An H100 SM's shared memory, and what each resident block reserves.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
FLAG_S, FLAG_HM, FLAG_C = 64, 96, 32
# The float32 K3 launches of a flagship forward: (input side, Cin, Cout).
FLAGSHIP_K3 = ((2, 128, 128), (4, 128, 128), (8, 128, 128), (16, 128, 64),
               (32, 64, 32))
# The GPU tests' float32 K3 shapes: (B, X, Y, Z, Cin), Cout.
RAGGED_K3 = [((3, 5, 3, 7, 24), 12), ((2, 3, 3, 3, 40), 17),
             ((1, 2, 3, 2, 8), 6), ((2, 3, 2, 5, 64), 32),
             ((1, 2, 2, 2, 128), 17), ((2, 3, 4, 5, 64), 32)]


def _flagship_m(batch=8):
    """The flagship's composed (batch, 4, 3, 4) grid -> pixel matrices, as
    chip_smoke.py builds them."""
    _, proj, pelvis = (torch.from_numpy(a) for a in
                       example_batch(batch, 4, 384, 17))
    aff = vol_ops.coord_volume_affine(select_base_points(pelvis, "mpii"),
                                      2500.0, FLAG_S)
    return compose_grid_projection(
        rescale_proj_to_heatmap(proj, (384, 384), (FLAG_HM, FLAG_HM)), aff)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("c, s", [(FLAG_C, FLAG_S), (40, 10), (16, 6),
                                  (17, 7), (32, 1), (100, 9), (1, 3),
                                  (64, 33), (48, 5), (8, 2), (24, 4),
                                  (33, 12), (64, 16), (128, 8), (96, 17),
                                  (2, 64), (40, 31), (FLAG_C, 32),
                                  (65, 20), (256, 11)])
def test_unproject_plan_fits(c, s, elem):
    for window in (None, 0, 24):
        plan = unproject_plan(c, s, elem, window)
        if window is None:      # windows staged by default in bfloat16
            window = AGG_WINDOW if elem == 2 else 0
        assert plan.window == window
        assert plan.smem == agg_smem_bytes(math.prod(AGG_BRICK), plan.window,
                                           elem) <= AGG_SMEM_MAX
        assert plan.grid == math.prod(math.ceil(s / n) for n in AGG_BRICK)
        assert plan.chunks == math.ceil(c / AGG_CHUNK) <= 65535


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("s, parts", [(FLAG_S, 2), (FLAG_S, 4), (32, 2),
                                      (32, 4), (16, 4)])
def test_unproject_plan_of_a_slab(s, parts, elem):
    """A slab of SX = S / parts X planes (volume-axis sharding) launches
    the cube's plan with its bricks of those rows: the same window and
    shared memory, the cube's grid over ``parts``; SX = S is the cube's
    plan itself."""
    cube = unproject_plan(FLAG_C, s, elem)
    slab = unproject_plan(FLAG_C, s, elem, x_extent=s // parts)
    assert slab._replace(grid=cube.grid) == cube
    assert slab.grid * parts == cube.grid
    assert unproject_plan(FLAG_C, s, elem, x_extent=s) == cube


@pytest.mark.parametrize("parts", [2, 4])
def test_flagship_slab_windows_are_the_cubes(parts):
    """At the flagship geometry (sample 0 of 8), each slab's K1 windows
    and scatter boxes, brick by brick in its own grid order, are the
    cube's bricks over the slab's rows."""
    m = _flagship_m()[:1]
    sx = FLAG_S // parts
    per_x = (FLAG_S // AGG_BRICK[1]) * (FLAG_S // AGG_BRICK[2])
    for clamped in (True, False):
        cube = brick_windows(m, FLAG_S, FLAG_HM, FLAG_HM, clamped=clamped)
        for x0 in range(0, FLAG_S, sx):
            got = brick_windows(m, FLAG_S, FLAG_HM, FLAG_HM,
                                clamped=clamped, slab=(x0, sx))
            rows = slice(x0 // AGG_BRICK[0] * per_x,
                         (x0 + sx) // AGG_BRICK[0] * per_x)
            assert got[0].shape[2] == unproject_plan(
                FLAG_C, FLAG_S, 4, x_extent=sx).grid
            assert torch.equal(got[0], cube[0][:, :, rows])
            assert torch.equal(got[1], cube[1][:, :, rows])


@pytest.mark.parametrize("s, slab", [(10, (4, 5)), (13, (0, 7)),
                                     (16, (8, 4)), (9, (3, 6))])
def test_k1_slab_is_the_cubes_rows(s, slab):
    """The plain K1 on a slab, also one whose planes do not start on a
    brick, equals the cube's rows, NaN and infinities on the maps' edges
    included: bit for bit in 'sum' and 'max' (the projection and the
    sampling are per voxel); in 'softmax' within 1e-7 of the largest, as
    ``torch.softmax`` on the CPU rounds the exponential of a vector's
    tail otherwise than its body (the kernel is per voxel there too)."""
    m, h, w = _scene(s, seed=s)
    feats = _edge_features(2, 3, h, w, 9, seed=s)
    mask = torch.ones(2, 3)
    x0, sx = slab
    for method in ("softmax", "sum", "max"):
        cube = unproject.unproject_agg(feats, m, mask, None, method, s)
        got = unproject.unproject_agg(feats, m, mask, None, method, s,
                                      slab=slab)
        rows = cube.reshape(2, s, s * s, 9)[:, x0:x0 + sx]
        got = got.reshape(rows.shape)
        assert torch.equal(got.isnan(), rows.isnan())
        fin = ~rows.isnan()
        if method == "softmax":
            torch.testing.assert_close(
                got[fin], rows[fin], rtol=0,
                atol=1e-7 * rows[rows.isfinite()].abs().max().item())
        else:
            assert torch.equal(got[fin], rows[fin])
    with pytest.raises(ValueError, match="not inside"):
        unproject.unproject_agg(feats, m, mask, None, "sum", s,
                                slab=(s - 1, 2))


def test_unproject_plan_default_holds_two_blocks_an_sm():
    """The plans with staged windows (4 x 8 x 8, 384 pixels, 32 channels)
    leave room for two blocks on an SM in float32 and three in bfloat16;
    the default stages them in bfloat16 only (AGG_STAGED: in float32 the
    device-memory reads measured faster on the H100)."""
    for elem, blocks in ((4, 2), (2, 3)):
        plan = unproject_plan(FLAG_C, FLAG_S, elem, window=384)
        assert plan.chunks == 1
        assert blocks * (plan.smem + BLOCK_RESERVED) <= SM_SMEM
        assert unproject_plan(FLAG_C, FLAG_S, elem).window == (
            384 if unproject.AGG_STAGED[elem] else 0)
    assert unproject.AGG_STAGED == {2: True, 4: False}


def test_unproject_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="does not fit"):
        unproject_plan(32, 64, 4, window=1000)


def test_unproject_kernel_constants_are_the_plans():
    src = (CSRC / "unproject_agg.cu").read_text()
    assert ("return 2 * window * kChunk * elem + 2 * voxels * 32 + "
            "2 * (voxels / 32) * 16;") in src

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kSmemMax") == AGG_SMEM_MAX
    assert const("kChunk") == AGG_CHUNK
    assert ("constexpr int kBx = {}, kBy = {}, kBz = {}, kNT = kBx * kBy * "
            "kBz;".format(*AGG_BRICK)) in src
    # A slab's bricks: its own X extent nx, the grid's along y and z.
    assert ("const int64_t nb = static_cast<int64_t>((nx + kBx - 1) / kBx) *"
            in src)
    assert "return gx < p.nx && gy < p.S && gz < p.S;" in src


def test_flagship_windows_fit_the_budget():
    """All 8 samples of the flagship geometry: every 4 x 8 x 8 (brick,
    view) window of K1, the brick's taps clamped to the map, fits the
    384-pixel budget (measured on the CPU: median 90, at most 288 pixels),
    so no brick takes the device-memory path; every voxel projects in
    front of every camera, so every window has pixels (220 of the pairs
    have no tap in the map: their windows are strips of the map's
    edge)."""
    m = _flagship_m()
    budget = AGG_WINDOW
    pixels, in_map = [], []
    for i in range(m.shape[0]):           # one sample at a time: less memory
        uvw = _project(m[i], FLAG_S)
        assert bool((uvw[..., 2] > 0).all())
        pixels.append(brick_windows(m[i:i + 1], FLAG_S, FLAG_HM, FLAG_HM,
                                    clamped=True)[1])
        in_map.append(brick_windows(m[i:i + 1], FLAG_S, FLAG_HM,
                                    FLAG_HM)[1])
    pixels = torch.cat(pixels)
    assert int((torch.cat(in_map) == 0).sum()) == 220
    assert tuple(pixels.shape) == (8, 4, (FLAG_S // 4) * (FLAG_S // 8) ** 2)
    assert int(pixels.max()) <= budget
    assert int((pixels > budget).sum()) == 0
    assert int((pixels == 0).sum()) == 0
    assert 60 <= float(pixels.double().median()) <= 120


def _scene(s, seed):
    """Two samples x 3 views on a 30 x 26 map: a perspective view, one with
    voxels behind the camera (w = gx - 2.5) and one partly off the map."""
    rng = np.random.RandomState(seed)
    m = np.zeros((2, 3, 3, 4), np.float32)
    m[..., 0, :] = [1.9, 0.2, 0.5, 0.4]
    m[..., 1, :] = [0.1, 2.1, 0.4, 0.3]
    m[..., 2, :] = [0.01, 0.02, 0.015, 1.0]
    m += rng.uniform(-0.05, 0.05, m.shape).astype(np.float32)
    m[1, 1, 2] = [1.0, 0.0, 0.0, -2.5]
    m[0, 2, 0, 3] = 18.0
    return torch.from_numpy(m), 26, 30


@pytest.mark.parametrize("s", [5, 6, 9, 10, 13, 16])
def test_brick_windows_hold_every_tap(s):
    """Brute force over every voxel: its taps that lie in the map are
    inside the box of its brick (decoded as the kernel decodes blockIdx.x:
    z fastest, then y, then x), and each side of every box is one of
    them; a brick without such a tap has no pixels."""
    m, h, w = _scene(s, seed=s)
    boxes, pixels = brick_windows(m, s, h, w)
    bx, by, bz = AGG_BRICK
    nby, nbz = math.ceil(s / by), math.ceil(s / bz)
    uvw = _project(m.reshape(-1, 3, 4), s).reshape(2, 3, s, s, s, 3)
    for b in range(2):
        for v in range(3):
            seen = {}
            for gx in range(s):
                for gy in range(s):
                    for gz in range(s):
                        u, q, d = (float(t) for t in uvw[b, v, gx, gy, gz])
                        if not d > 0:
                            continue
                        x0 = math.floor(np.float32(u) / np.float32(d)
                                        * np.float32((w - 1) / w))
                        y0 = math.floor(np.float32(q) / np.float32(d)
                                        * np.float32((h - 1) / h))
                        bi = ((gx // bx) * nby + gy // by) * nbz + gz // bz
                        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                            x, y = x0 + dx, y0 + dy
                            if not (0 <= x <= w - 1 and 0 <= y <= h - 1):
                                continue
                            box = boxes[b, v, bi].tolist()
                            assert box[0] <= x <= box[1], (b, v, bi, x, box)
                            assert box[2] <= y <= box[3], (b, v, bi, y, box)
                            seen.setdefault(bi, set()).update(
                                {("x", x), ("y", y)})
            for bi in range(boxes.shape[2]):
                x_lo, x_hi, y_lo, y_hi = boxes[b, v, bi].tolist()
                if bi not in seen:
                    assert pixels[b, v, bi] == 0
                    continue
                assert {("x", x_lo), ("x", x_hi), ("y", y_lo),
                        ("y", y_hi)} <= seen[bi]
                assert pixels[b, v, bi] == (x_hi - x_lo + 1) * (
                    y_hi - y_lo + 1)
            assert seen        # the scene puts taps on the map


@pytest.mark.parametrize("s", [5, 6, 9, 10, 13, 16])
def test_k1_windows_hold_every_clamped_tap(s):
    """Brute force over every voxel in front of its camera: each of its
    four taps, clamped to the map, is inside its brick's K1 window, and
    each side of every window is one of them; a brick whose voxels are all
    behind the camera has no pixels."""
    m, h, w = _scene(s, seed=s)
    boxes, pixels = brick_windows(m, s, h, w, clamped=True)
    bx, by, bz = AGG_BRICK
    nby, nbz = math.ceil(s / by), math.ceil(s / bz)
    uvw = _project(m.reshape(-1, 3, 4), s).reshape(2, 3, s, s, s, 3)
    behind = 0
    for b in range(2):
        for v in range(3):
            seen = {}
            for gx in range(s):
                for gy in range(s):
                    for gz in range(s):
                        u, q, d = (float(t) for t in uvw[b, v, gx, gy, gz])
                        if not d > 0:
                            behind += 1
                            continue
                        x0 = math.floor(np.float32(u) / np.float32(d)
                                        * np.float32((w - 1) / w))
                        y0 = math.floor(np.float32(q) / np.float32(d)
                                        * np.float32((h - 1) / h))
                        bi = ((gx // bx) * nby + gy // by) * nbz + gz // bz
                        box = boxes[b, v, bi].tolist()
                        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                            x = min(max(x0 + dx, 0), w - 1)
                            y = min(max(y0 + dy, 0), h - 1)
                            assert box[0] <= x <= box[1], (b, v, bi, x, box)
                            assert box[2] <= y <= box[3], (b, v, bi, y, box)
                            seen.setdefault(bi, set()).update(
                                {("x", x), ("y", y)})
            for bi in range(boxes.shape[2]):
                x_lo, x_hi, y_lo, y_hi = boxes[b, v, bi].tolist()
                if bi not in seen:
                    assert pixels[b, v, bi] == 0
                    continue
                assert {("x", x_lo), ("x", x_hi), ("y", y_lo),
                        ("y", y_hi)} <= seen[bi]
                assert pixels[b, v, bi] == (x_hi - x_lo + 1) * (
                    y_hi - y_lo + 1)
    assert behind       # the scene puts voxels behind a camera


def _k1_taps(m, s, h, w):
    """Each (sample * view, voxel)'s four taps as K1 reads them: pixel
    index y * W + x of the tap clamped to the map (x, y also returned), -1
    for a voxel behind the camera; weight 0 for a tap off the map."""
    uvw = _project(m.reshape(-1, 3, 4), s)
    z = uvw[..., 2]
    z_safe = torch.where(z == 0.0, torch.ones_like(z), z)
    x = uvw[..., 0] / z_safe * ((w - 1) / w)
    y = uvw[..., 1] / z_safe * ((h - 1) / h)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    wts = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                       wx * wy], -1)
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    front = (z > 0)[..., None].expand_as(inside)
    cx, cy = xs.clamp(0, w - 1).long(), ys.clamp(0, h - 1).long()
    pix = torch.where(front, cy * w + cx, -1)
    return pix, cx, cy, torch.where(inside & front, wts, 0.0)


def _k1_model(feats, m, mask, conf, method, s, budget):
    """K1 brick by brick: each (sample, brick, view) reads its voxels' taps
    from a copy of its window where the window fits ``budget`` (offsets
    into the window, which must hold them), else from the map, sums them
    k = 0..3 (a voxel behind the camera reads pixel 0, dropped by a
    select), and aggregates across views as the kernel does, the online
    softmax included (its sum plus the sum minus itself at the store: NaN
    after a +inf logit); 'conf' samples a masked view too and weighs it by
    0."""
    b, v, h, w, c = feats.shape
    pix, cx, cy, wts = _k1_taps(m, s, h, w)
    pix, cx, cy, wts = (t.reshape(b, v, s ** 3, 4) for t in
                        (pix, cx, cy, wts))
    boxes, pixels = brick_windows(m, s, h, w, clamped=True)
    out = torch.full((b, s ** 3, c), float("nan"))
    for bi, vox in enumerate(_bricks(s)):
        for i in range(b):
            acc = torch.full((len(vox), c), -math.inf if method == "max"
                             else 0.0)
            rm = torch.full((len(vox), c), -math.inf)
            dn = torch.zeros(len(vox), c)
            for u in range(v):
                keep = bool(mask[i, u] > 0) or method == "conf"
                off = pix[i, u, vox]
                src = feats[i, u].reshape(h * w, c)
                if keep and 0 < pixels[i, u, bi] <= budget:
                    x0, x1, y0, y1 = boxes[i, u, bi].tolist()
                    ww = x1 - x0 + 1
                    src = feats[i, u, y0:y1 + 1, x0:x1 + 1].reshape(-1, c)
                    off = torch.where(off >= 0, (cy[i, u, vox] - y0) * ww
                                      + cx[i, u, vox] - x0, -1)
                    assert bool((off < len(src)).all())
                val = torch.zeros(len(vox), c)
                if keep:
                    for k in range(4):
                        got = src[off[:, k].clamp_min(0)]
                        val = torch.where(off[:, k, None] >= 0, val
                                          + wts[i, u, vox, k, None] * got,
                                          val)
                if method == "softmax":
                    logit = val if keep else torch.full_like(val, -1e9)
                    contrib = val if keep else torch.zeros_like(val)
                    up = logit > rm
                    e = torch.exp(-(logit - rm).abs())
                    dn = torch.where(up, dn * e + 1.0, dn + e)
                    acc = torch.where(up, acc * e + contrib, acc + e * contrib)
                    rm = torch.where(up, logit, rm)
                elif keep and method == "sum":
                    acc = acc + val
                elif method == "max":
                    acc = torch.maximum(acc, val if keep
                                        else torch.full_like(val, -math.inf))
                elif method == "conf":
                    acc = acc + val * (conf[i, u] if mask[i, u] > 0
                                       else torch.zeros_like(conf[i, u]))
            if method == "softmax":
                acc = acc / dn + (acc - acc)
            if method == "max":
                acc = torch.where(acc == -math.inf, 0.0, acc)
            out[i, vox] = acc
    return out


def _bricks(s):
    """Each 4 x 8 x 8 brick's voxel indices n, in K1's grid order (z
    fastest, then y, then x), voxels outside the grid dropped."""
    bx, by, bz = AGG_BRICK
    nby, nbz = math.ceil(s / by), math.ceil(s / bz)
    j = torch.arange(bx * by * bz)
    out = []
    for bi in range(math.ceil(s / bx) * nby * nbz):
        gz = bi % nbz * bz + j % bz
        gy = bi // nbz % nby * by + j // bz % by
        gx = bi // (nbz * nby) * bx + j // (bz * by)
        keep = (gx < s) & (gy < s) & (gz < s)
        out.append(((gx * s + gy) * s + gz)[keep])
    return out


def _edge_features(b, v, h, w, c, seed):
    """Random features with NaN on the maps' first row, +inf on their last
    column and -inf on their last row, each in every third channel (the
    pixels that taps off the map read), and +inf at one interior pixel."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((b, v, h, w, c), generator=g)
    feats[:, :, 0, :, 0::3] = math.nan
    feats[:, :, :, -1, 1::3] = math.inf
    feats[:, :, -1, :, 2::3] = -math.inf
    feats[:, :, h // 2, w // 2, 1] = math.inf
    return feats


@pytest.mark.parametrize("budget", [0, 40, AGG_WINDOW])
@pytest.mark.parametrize("method", ["softmax", "sum", "max", "conf"])
@pytest.mark.parametrize("s", [7, 10])
def test_k1_model_keeps_nonfinite_as_the_plain_version(s, method, budget):
    """_scene's views (one with voxels behind its camera, one partly off
    the map) with NaN and infinities on the maps' edges and one +inf
    inside: the K1 model, with windows staged for every brick, some or
    none, has NaN exactly where unproject_agg_plain has it (off-map taps
    read the edge with weight 0: inf * 0 = NaN; a +inf logit makes the
    softmax NaN), its infinities, and its finite values within 1e-5 of
    the largest.  One view of sample 1 is masked: 'conf' samples it and
    multiplies by a confidence of 0, as the plain version and lt_tpu do,
    so its NaN and infinities make NaN."""
    m, h, w = _scene(s, seed=s)
    c = 9
    feats = _edge_features(2, 3, h, w, c, seed=s)
    mask = torch.ones(2, 3)
    mask[1, 2] = 0.0
    conf = (torch.rand((2, 3, c), generator=torch.Generator().manual_seed(1))
            if method == "conf" else None)
    got = _k1_model(feats, m, mask, conf, method, s, budget)
    ref = unproject.unproject_agg_plain(feats, m, mask, conf, method, s)
    nan = ref.isnan()
    assert bool(nan.any())
    assert torch.equal(got.isnan(), nan)
    inf = ref.isinf()
    assert torch.equal(got[inf], ref[inf])
    fin = ref.isfinite()
    assert bool(got[fin].isfinite().all())
    torch.testing.assert_close(got[fin], ref[fin], rtol=0,
                               atol=1e-5 * ref[fin].abs().max().item())
    if method == "softmax":
        # Fault 3's case: NaN where a kept view's sample is +inf.
        sampled = sample.sample_views_plain(
            feats.reshape(6, h, w, c), m.reshape(6, 3, 4), s).reshape(
                2, 3, s ** 3, c)
        pos = ((sampled == math.inf) & (mask[:, :, None, None] > 0)).any(1)
        assert bool(pos.any()) and bool(got[pos].isnan().all())


def _check_up_f32_plan(b, sx, sy, sz, cin, cout):
    """upsample_f32_plan fits and its blocks, decoded as upsample3d_2x.cu
    decodes them (N split fastest, then the M tile), cover every (input
    voxel, packed column) exactly once."""
    plan = upsample_f32_plan(b, sx, sy, sz, cin, cout)
    assert plan.smem == up_f32_smem_bytes(plan.kp) <= UP_SMEM_MAX
    assert plan.kp % 8 == 0 and cin <= plan.kp < cin + 8
    ntn = math.ceil(2 * cout / UP_F32_NT)
    steps = 4 * ntn
    mtiles = math.ceil(b * sx * sy * sz / UP_F32_VOXELS)
    assert plan.nsplit == math.ceil(steps / plan.per)
    assert plan.grid == mtiles * plan.nsplit < 2 ** 31
    hits = np.zeros((mtiles * UP_F32_VOXELS, 8 * cout), np.int32)
    for bid in range(plan.grid):
        split, mt = bid % plan.nsplit, bid // plan.nsplit
        s0 = split * plan.per
        assert s0 < steps                    # no block without work
        for st in range(s0, min(s0 + plan.per, steps)):
            pair, n0 = st // ntn, (st % ntn) * UP_F32_NT
            c0 = pair * 2 * cout + n0
            c1 = min(c0 + UP_F32_NT, (pair + 1) * 2 * cout)
            hits[mt * UP_F32_VOXELS:(mt + 1) * UP_F32_VOXELS, c0:c1] += 1
    assert (hits == 1).all()
    return plan


@pytest.mark.parametrize("side, cin, cout", FLAGSHIP_K3)
def test_upsample_f32_plan_of_each_flagship_launch(side, cin, cout):
    """At batch 8 Cin is whole in shared memory (Cin 64: three blocks an
    SM); the levels with few M tiles split their steps across blocks (2^3:
    one M tile, 16 blocks), the 32^3 level (2048 M tiles) does not."""
    plan = _check_up_f32_plan(8, side, side, side, cin, cout)
    if side == 2:
        assert plan.grid == 16 and plan.per == 1
    if side == 32:
        assert plan.nsplit == 1 and plan.grid == 2048
        assert 3 * (plan.smem + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("shape, cout", RAGGED_K3)
def test_upsample_f32_plan_of_ragged_shapes(shape, cout):
    _check_up_f32_plan(*shape, cout)


def test_upsample_f32_kernel_constants_are_the_plans():
    src = (CSRC / "upsample3d_2x.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;/]+);", src)
                   .group(1).strip().split()[0])

    assert const("kM") == UP_F32_VOXELS
    assert const("kNT") == UP_F32_NT
    assert "constexpr int kAP = kM + 4;" in src
    assert UP_F32_APITCH == UP_F32_VOXELS + 4
    assert const("kSmemMax") == UP_SMEM_MAX
    assert "return kp * kAP * 4 + 2 * kp * kNT * 4 + kM * 8;" in src
    with pytest.raises(ValueError, match="does not fit"):
        upsample_f32_plan(1, 2, 2, 2, 1024, 64)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers never plan a launch: the plain versions
    run whatever the plan would have been."""
    x = torch.randn(1, 2, 2, 2, 1024)
    w8 = torch.randn(1024, 8 * 4)
    out = updown.upsample3d_2x(x, w8, torch.zeros(32))
    torch.testing.assert_close(out, updown.upsample3d_2x_plain(
        x, w8, torch.zeros(32)))
    feats = torch.randn(1, 2, 5, 6, 8)
    m = _scene(4, 0)[0][:1, :2]
    mask = torch.ones(1, 2)
    got = unproject.unproject_agg(feats, m, mask, None, "softmax", 4)
    torch.testing.assert_close(got, unproject.unproject_agg_plain(
        feats, m, mask, None, "softmax", 4))
