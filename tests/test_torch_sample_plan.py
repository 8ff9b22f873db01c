"""The launch plans of K5 and K6 (``csrc/sample_views_t.cu``,
``csrc/sample_views_grad_t.cu`` on ``csrc/sample_brick.cuh``), and plain
PyTorch models of their two paths, on the CPU.

``ops/kernels/sample.sample_plan`` picks the window budget, dynamic shared
memory and grid of bricks for both kernels: K6 takes K1's 4 x 8 x 8 brick
(``AGG_BRICK``), K5 a brick elongated in z, 2 x 4 x 32 (``K5_BRICK``: its
z-runs are whole 128-byte rows of its output, and it measured faster).  A launch refused for too much shared memory never runs, so the
guard is here, where no card is needed:

- every plan fits the H100 (shared memory <= 232,448 bytes; the default
  plans leave room for five blocks on an SM),
  its grid (bricks, views, chunks) fits CUDA's limits, and the kernels'
  constants and shared-memory formula are the plan's;
- at the flagship training geometry (``chip_smoke.py``'s: the example rig's
  first 5 samples, a 2500 mm cuboid, 96^2 maps, 64^3) every (brick, view)
  window fits K6's budget, so every brick pre-reduces in shared memory;
- K6 modelled brick by brick (window path: the brick's taps added into a
  window of its box, then the window added to dF; direct path: the taps
  added to dF) and K5 modelled brick by brick (taps read from the staged
  window or from the map, a tap off the map reading pixel 0 and dropped
  by a select) equal the plain versions for budgets that take every brick
  down either path or some down each.
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
from lt_tpu_torch.ops.kernels import sample
from lt_tpu_torch.ops.kernels.bricks import AGG_BRICK, AGG_CHUNK, AGG_SMEM_MAX
from lt_tpu_torch.ops.kernels.sample import (K5_BRICK, K5_WINDOW, K6_WINDOW,
                                             _project, sample_plan,
                                             sample_smem_bytes)
from lt_tpu_torch.ops.kernels.unproject import (brick_windows,
                                                compose_grid_projection)
from lt_tpu_torch.utils.example import example_batch

CSRC = (Path(__file__).resolve().parents[1] / "lt_tpu_torch" / "ops"
        / "kernels" / "csrc")
# An H100 SM's shared memory, and what each resident block reserves.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
FLAG_S, FLAG_HM, FLAG_C, TRAIN_BATCH = 64, 96, 32, 5


@pytest.mark.parametrize("c, s", [(FLAG_C, FLAG_S), (17, 7), (48, 10),
                                  (40, 13), (1, 3), (32, 1), (100, 9),
                                  (64, 33), (8, 2), (256, 16)])
@pytest.mark.parametrize("window", [0, 24, K6_WINDOW, 1400])
@pytest.mark.parametrize("grad", [False, True])
def test_sample_plan_fits(c, s, window, grad):
    plan = sample_plan(c, s, window, grad)
    assert plan.window == window
    assert plan.smem == sample_smem_bytes(window, grad) <= AGG_SMEM_MAX
    brick = AGG_BRICK if grad else K5_BRICK
    assert plan.grid == math.prod(math.ceil(s / n) for n in brick)
    assert plan.chunks == math.ceil(c / AGG_CHUNK)
    # The launch grid (bricks, views, chunks) at the training batch's 20
    # views: CUDA's grid limits.
    assert plan.grid < 2 ** 31 and 20 <= 65535 and plan.chunks <= 65535


def test_sample_plan_defaults_at_the_flagship():
    """K6 pre-reduces by default with room for five blocks on an SM (its
    counts and sorted taps take 3.6 KB); K5 reads its taps from device
    memory with room for five (staged 384-pixel windows would leave room
    for two); one chunk of 32 channels, 1024 bricks of 256 voxels each."""
    k5 = sample_plan(FLAG_C, FLAG_S, K5_WINDOW, False)
    k6 = sample_plan(FLAG_C, FLAG_S, K6_WINDOW, True)
    assert K6_WINDOW == 384 and K5_WINDOW == 0
    assert k5.grid == k6.grid == 1024 and k5.chunks == k6.chunks == 1
    assert 5 * (k6.smem + BLOCK_RESERVED) <= SM_SMEM
    assert 5 * (k5.smem + BLOCK_RESERVED) <= SM_SMEM
    staged = sample_plan(FLAG_C, FLAG_S, K6_WINDOW, False)
    assert 2 * (staged.smem + BLOCK_RESERVED) <= SM_SMEM < 3 * (
        staged.smem + BLOCK_RESERVED)


def test_sample_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="does not fit"):
        sample_plan(32, 64, 2000, False)
    with pytest.raises(ValueError, match="does not fit"):
        sample_plan(32, 64, 60000, True)


def test_sample_kernel_constants_are_the_plans():
    src = (CSRC / "sample_brick.cuh").read_text()
    assert "return (window + 4) / 4 * 4;" in src
    assert ("return grad ? count_slots(window) * 4 + 4 * kNT * 2 : window * "
            "kChunk * 4;") in src
    assert ("return window_bytes(window, grad) + kChunk * kPitch * 4 + kNT * "
            "32 +\n         kNW * 16;") in src
    assert "constexpr int kPitch = kNT + 1;" in src
    assert "constexpr int kNW = kNT / 32;" in src

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kSmemMax") == AGG_SMEM_MAX
    assert const("kChunk") == AGG_CHUNK
    assert "constexpr int kNT = 256;" in src
    assert math.prod(AGG_BRICK) == math.prod(K5_BRICK) == 256
    assert "using K5Brick = Brick<{}, {}, {}>;".format(*K5_BRICK) in src
    assert "using K6Brick = Brick<{}, {}, {}>;".format(*AGG_BRICK) in src
    for name, brick in (("sample_views_t", "K5Brick"),
                        ("sample_views_grad_t", "K6Brick")):
        kernel = (CSRC / f"{name}.cu").read_text()
        assert '#include "sample_brick.cuh"' in kernel
        assert f"brick_voxel<{brick}>" in kernel
        assert f"plan_error<{brick}>" in kernel


def test_flagship_training_windows_fit_k6_budget():
    """chip_smoke.py's training geometry (the first 5 samples of the
    example rig at batch 8, 4 views): every (brick, view) window fits K6's
    384-pixel budget (median 90, at most 288 pixels), so no brick takes the
    direct path, and every voxel projects in front of every camera; 168 of
    the 20,480 pairs have no tap in the map."""
    _, proj, pelvis = (torch.from_numpy(a) for a in
                       example_batch(8, 4, 384, 17))
    aff = vol_ops.coord_volume_affine(
        select_base_points(pelvis[:TRAIN_BATCH], "mpii"), 2500.0, FLAG_S)
    m = compose_grid_projection(
        rescale_proj_to_heatmap(proj[:TRAIN_BATCH], (384, 384),
                                (FLAG_HM, FLAG_HM)), aff)
    pixels = []
    for i in range(TRAIN_BATCH):          # one sample at a time: less memory
        assert bool((_project(m[i], FLAG_S)[..., 2] > 0).all())
        pixels.append(brick_windows(m[i:i + 1], FLAG_S, FLAG_HM, FLAG_HM)[1])
    pixels = torch.cat(pixels)
    assert tuple(pixels.shape) == (TRAIN_BATCH, 4, 1024)
    assert int((pixels > K6_WINDOW).sum()) == 0
    # A few bricks have no tap in the map of a view: they add nothing.
    assert 0 < int((pixels == 0).sum()) < 0.01 * pixels.numel()
    assert int(pixels.max()) <= 288
    assert 60 <= float(pixels.double().median()) <= 120


# ---------------------------------------------------------------------------
# The kernels' two paths, modelled brick by brick in plain PyTorch
# ---------------------------------------------------------------------------


def _scene(s, seed, c=40):
    """6 views of a 11 x 13 map, C channels: perspective views, one at
    w <= 0 everywhere, one with w == 0 exactly on the plane gx = 3, one
    projecting every voxel off the map, one straddling the map's edge."""
    rng = np.random.RandomState(seed)
    h, w = 11, 13
    m = np.zeros((6, 3, 4), np.float32)
    m[:, 0] = [1.2, 0.2, 0.1, 0.3]
    m[:, 1] = [0.1, 1.3, 0.15, 0.2]
    m[:, 2] = [0.02, 0.01, 0.015, 1.0]
    m += rng.uniform(-0.02, 0.02, m.shape).astype(np.float32)
    m[1, 2] = [0.0, 0.0, 0.0, -1.0]
    m[2, 2] = [1.0, 0.0, 0.0, -3.0]
    m[3, 0, 3] = 1e4
    m[4, 0, 3] = -4.0
    feats = rng.randn(6, h, w, c).astype(np.float32)
    return torch.from_numpy(feats), torch.from_numpy(m)


def _bricks(s, brick):
    """Each brick's voxel indices n, in the kernels' order (bricks: z
    fastest, then y, then x; voxels in a brick likewise), voxels outside
    the grid dropped."""
    bx, by, bz = brick
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


def _taps(m, s, h, w):
    """Each view's and voxel's four taps as ltk_voxel_taps picks them:
    pixel x, y (int64), weights, and whether the tap is in the map (never
    for a voxel at w <= 0)."""
    uvw = _project(m, s)
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
    inside = ((z > 0)[..., None] & (xs >= 0) & (xs <= w - 1) & (ys >= 0)
              & (ys <= h - 1))
    big = 1 << 20        # a far-off projection: any value off the map
    return (xs.clamp(-big, big).long(), ys.clamp(-big, big).long(), wts,
            inside)


def _windows(m, s, h, w, budget, brick):
    """Per view and brick: its box (x0, x1, y0, y1), pixels, and whether
    the kernel takes the window path (the box has pixels, within the
    budget)."""
    boxes, pixels = brick_windows(m[None], s, h, w, brick)
    boxes, pixels = boxes[0], pixels[0]
    fits = (pixels > 0) & (pixels <= budget)
    return boxes, pixels, fits


def _k6_model(g, m, shape, s, budget):
    """Window path: the brick's taps summed by pixel of its box (the
    kernel's counting sort and per-pixel sums), each pixel's sum added to
    dF; direct path: each tap added to dF."""
    bv, h, w, c = shape
    xs, ys, wts, inside = _taps(m, s, h, w)
    boxes, pixels, fits = _windows(m, s, h, w, budget, AGG_BRICK)
    df = torch.zeros(bv, h * w, c)
    for v in range(bv):
        for bi, vox in enumerate(_bricks(s, AGG_BRICK)):
            keep = inside[v, vox]                            # (n, 4)
            terms = (g[v][:, vox].T[:, None, :]
                     * wts[v, vox][..., None])[keep]         # (taps, C)
            x, y = xs[v, vox][keep], ys[v, vox][keep]
            if fits[v, bi]:
                x0, _, y0, _ = boxes[v, bi].tolist()
                ww = boxes[v, bi, 1].item() - x0 + 1
                npix = pixels[v, bi].item()
                idx = (y - y0) * ww + (x - x0)
                assert bool(((idx >= 0) & (idx < npix)).all())
                win = torch.zeros(npix, c).index_add_(0, idx, terms)
                py, px = torch.arange(npix) // ww, torch.arange(npix) % ww
                df[v].index_add_(0, (y0 + py) * w + x0 + px, win)
            else:
                df[v].index_add_(0, y * w + x, terms)
    return df.reshape(shape)


def _k5_model(feats, m, s, budget):
    """Taps read from the brick's staged window or from the map; a tap off
    the map reads pixel 0 and its term is dropped by a select."""
    bv, h, w, c = feats.shape
    xs, ys, wts, inside = _taps(m, s, h, w)
    boxes, pixels, fits = _windows(m, s, h, w, budget, K5_BRICK)
    out = torch.zeros(bv, c, s ** 3)
    for v in range(bv):
        for bi, vox in enumerate(_bricks(s, K5_BRICK)):
            keep = inside[v, vox]
            x, y = xs[v, vox], ys[v, vox]
            if fits[v, bi]:
                x0, x1, y0, y1 = boxes[v, bi].tolist()
                src = feats[v, y0:y1 + 1, x0:x1 + 1].reshape(-1, c)
                idx = (y - y0) * (x1 - x0 + 1) + (x - x0)
            else:
                src = feats[v].reshape(-1, c)
                idx = y * w + x
            vals = src[torch.where(keep, idx, 0)]           # (n, 4, C)
            val = torch.zeros(len(vox), c)
            for k in range(4):
                val = torch.where(keep[:, k, None],
                                  val + wts[v, vox, k, None] * vals[:, k],
                                  val)
            out[v][:, vox] = val.T
    return out


def _paths_taken(m, s, h, w, budget, brick):
    """Budget 0 takes every brick with a tap in the map down the direct
    path, K6_WINDOW every one down the window path, the middle budget some
    down each."""
    _, pixels, fits = _windows(m, s, h, w, budget, brick)
    direct = (pixels > 0) & ~fits
    assert bool(fits.any()) == (budget > 0)
    assert bool(direct.any()) == (budget < K6_WINDOW)


@pytest.mark.parametrize("budget", [0, 40, K6_WINDOW])
@pytest.mark.parametrize("s, c", [(7, 40), (10, 17), (13, 8)])
def test_k6_model_of_both_paths_is_the_plain_scatter(s, c, budget):
    """Each equals sample_views_grad_t_plain, and a masked view (a gradient
    of 0) gets no gradient."""
    feats, m = _scene(s, seed=s, c=c)
    shape = tuple(feats.shape)
    g = torch.from_numpy(np.random.RandomState(1).randn(
        shape[0], c, s ** 3).astype(np.float32))
    g[5] = 0.0
    _paths_taken(m, s, shape[1], shape[2], budget, AGG_BRICK)
    got = _k6_model(g, m, shape, s, budget)
    ref = sample.sample_views_grad_t_plain(g, m, shape, s)
    assert bool((got[5] == 0).all()) and bool((got[1] == 0).all())
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("budget", [0, 16, K6_WINDOW])
@pytest.mark.parametrize("s, c", [(7, 40), (10, 17)])
def test_k5_model_of_both_paths_is_the_plain_sample(s, c, budget):
    """Taps read from the staged window or from the map, a tap off the map
    reading pixel 0 and dropped by a select: equal to
    sample_views_t_plain; with inf in the maps' first row and column, every
    voxel whose taps in the map stay clear of them (all of views 1 and 3,
    whose taps are all off the map) keeps its sample bit for bit."""
    feats, m = _scene(s, seed=s, c=c)
    _paths_taken(m, s, *feats.shape[1:3], budget, K5_BRICK)
    ref = sample.sample_views_t_plain(feats, m, s)
    got = _k5_model(feats, m, s, budget)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    xs, ys, _, inside = _taps(m, s, *feats.shape[1:3])
    clear = ~(inside & ((xs == 0) | (ys == 0))).any(-1)        # (BV, N)
    assert bool(clear[1].all()) and bool(clear[3].all())
    inf = feats.clone()
    inf[:, 0] = float("inf")
    inf[:, :, 0] = float("inf")
    got_inf = _k5_model(inf, m, s, budget).transpose(1, 2)
    assert torch.equal(got_inf[clear], got.transpose(1, 2)[clear])


def test_wrappers_take_the_plain_versions_on_the_cpu_whatever_the_plan():
    feats, m = _scene(7, seed=0)
    plan = sample_plan(40, 7, 24, False)
    torch.testing.assert_close(sample.sample_views_t(feats, m, 7, plan),
                               sample.sample_views_t_plain(feats, m, 7))
    plan = sample_plan(40, 7, 24, True)
    g = torch.randn(6, 40, 7 ** 3, generator=torch.Generator().manual_seed(0))
    shape = tuple(feats.shape)
    torch.testing.assert_close(
        sample.sample_views_grad_t(g, m, shape, 7, plan),
        sample.sample_views_grad_t_plain(g, m, shape, 7))
