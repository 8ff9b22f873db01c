"""The launch plans of K5-K8 (``csrc/sample_views_t.cu``,
``csrc/sample_views_grad_t.cu``, ``csrc/sample_views.cu``,
``csrc/sample_views_grad.cu`` on ``csrc/sample_brick.cuh``), and plain
PyTorch models of the kernels, brick by brick, on the CPU.

``ops/kernels/sample.sample_plan`` picks the window budget (the scatters K6
and K8 only), dynamic shared memory and grid of bricks of each kernel: K6,
K7 and K8 take K1's 4 x 8 x 8 brick (``AGG_BRICK``), K5 a brick elongated
in z, 2 x 4 x 32 (``K5_BRICK``: its z-runs are whole 128-byte rows of its
output, and it measured faster there).  A launch refused for too much shared
memory never runs, so the guard is here, where no card is needed:

- every plan fits the H100 (shared memory <= 232,448 bytes; the default
  plans leave room for the blocks on an SM that each design assumes), its
  grid (bricks, views, chunks) fits CUDA's limits, and the kernels'
  constants and shared-memory formula are the plan's;
- at the flagship training geometry (``chip_smoke.py``'s: the example rig's
  first 5 samples, a 2500 mm cuboid, 96^2 maps, 64^3) every (brick, view)
  window fits the scatters' budget, so every brick pre-reduces in shared
  memory;
- K6 and K8 modelled brick by brick (window path: the brick's taps added
  into a window of its box, then the window added to dF; direct path: the
  taps added to dF; K8's tile loaded from whole voxels-major rows, bfloat16
  widened) equal the plain versions for budgets that take every brick down
  either path or some down each, NaN and infinities in the gradient at
  voxels whose taps fall off the map included; K5 and K7 modelled brick
  by brick (taps
  read from the map, a tap off the map at its pixel clamped to the map
  with weight 0, a voxel behind the camera reading pixel 0 and dropped by
  a select; K7 reading bfloat16 features widened and writing rows, a
  bfloat16 output rounded once) equal the plain versions and each other,
  NaN and infinities on the maps' edges included.
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
from lt_tpu_torch.ops.kernels.sample import (K5_BRICK, K6_WINDOW,
                                             SAMPLE_BRICKS, _project,
                                             sample_plan, sample_smem_bytes)
from lt_tpu_torch.ops.kernels.unproject import (brick_windows,
                                                compose_grid_projection)
from lt_tpu_torch.utils.example import example_batch

CSRC = (Path(__file__).resolve().parents[1] / "lt_tpu_torch" / "ops"
        / "kernels" / "csrc")
# An H100 SM's shared memory, and what each resident block reserves.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
FLAG_S, FLAG_HM, FLAG_C, TRAIN_BATCH = 64, 96, 32, 5


KERNELS = ("sample_views_t", "sample_views_grad_t", "sample_views",
           "sample_views_grad")


@pytest.mark.parametrize("c, s", [(FLAG_C, FLAG_S), (17, 7), (48, 10),
                                  (40, 13), (1, 3), (32, 1), (100, 9),
                                  (64, 33), (8, 2), (256, 16)])
@pytest.mark.parametrize("kernel, window", [
    ("sample_views_t", 0), ("sample_views", 0),
    ("sample_views_grad_t", 0), ("sample_views_grad_t", 24),
    ("sample_views_grad_t", K6_WINDOW), ("sample_views_grad_t", 1400),
    ("sample_views_grad", 0), ("sample_views_grad", K6_WINDOW)])
def test_sample_plan_fits(c, s, kernel, window):
    plan = sample_plan(kernel, c, s, window)
    assert plan.window == window
    assert plan.smem == sample_smem_bytes(kernel, window) <= AGG_SMEM_MAX
    brick = K5_BRICK if kernel == "sample_views_t" else AGG_BRICK
    assert SAMPLE_BRICKS[kernel] == brick
    assert plan.grid == math.prod(math.ceil(s / n) for n in brick)
    assert plan.chunks == math.ceil(c / AGG_CHUNK)
    # The launch grid (bricks, views, chunks) at the training batch's 20
    # views: CUDA's grid limits.
    assert plan.grid < 2 ** 31 and 20 <= 65535 and plan.chunks <= 65535
    if kernel == "sample_views_grad":       # K8 launches K6's plan
        assert plan == sample_plan("sample_views_grad_t", c, s, window)


def test_sample_plan_defaults_at_the_flagship():
    """K5, K6 and K8 leave room for five blocks on an SM (K6's and K8's
    counts and sorted taps take 3.6 KB beside the 32 KB tile); K7, with no
    tile, for eight, the most 256-thread blocks an SM holds; one chunk of
    32 channels, 1024 bricks of 256 voxels each."""
    plans = {k: sample_plan(k, FLAG_C, FLAG_S,
                            K6_WINDOW if "grad" in k else 0)
             for k in KERNELS}
    assert K6_WINDOW == 384
    for k, plan in plans.items():
        assert plan.grid == 1024 and plan.chunks == 1
        blocks = 8 if k == "sample_views" else 5
        assert blocks * (plan.smem + BLOCK_RESERVED) <= SM_SMEM
    assert plans["sample_views"].smem == 256 * 32


def test_sample_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="does not fit"):
        sample_plan("sample_views_grad_t", 32, 64, 60000)
    with pytest.raises(ValueError, match="does not fit"):
        sample_plan("sample_views_grad", 32, 64, 60000)
    for kernel in ("sample_views_t", "sample_views"):
        with pytest.raises(ValueError, match="no window"):
            sample_plan(kernel, 32, 64, 24)
    with pytest.raises(ValueError, match="no kernel"):
        sample_plan("unproject_agg", 32, 64)


def test_sample_kernel_constants_are_the_plans():
    src = (CSRC / "sample_brick.cuh").read_text()
    assert "return (window + 4) / 4 * 4;" in src
    assert ("return l == kScatter ? count_slots(window) * 4 + 4 * kNT * 2 : "
            "0;") in src
    assert ("return region_bytes(window, l) + (l == kTaps ? 0 : kChunk * "
            "kPitch * 4) +\n         kNT * 32 + (l == kScatter ? kNW * 16 : "
            "0);") in src
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
    assert "using K6Brick = Brick<{}, {}, {}>;  // K6, K7, K8".format(
        *AGG_BRICK) in src
    for name, brick, layout in (("sample_views_t", "K5Brick", "kTile"),
                                ("sample_views_grad_t", "K6Brick",
                                 "kScatter"),
                                ("sample_views", "K6Brick", "kTaps"),
                                ("sample_views_grad", "K6Brick",
                                 "kScatter")):
        kernel = (CSRC / f"{name}.cu").read_text()
        assert '#include "sample_brick.cuh"' in kernel
        assert f"brick_voxel<{brick}>" in kernel
        assert f"plan_error<{brick}>" in kernel
        assert re.search(rf"smem_layout\(smem, [\w.]+, {layout}\)", kernel)
        assert re.search(rf"plan_error<{brick}>\([^;]*{layout}\);", kernel)
        assert SAMPLE_BRICKS[name] == (K5_BRICK if brick == "K5Brick"
                                       else AGG_BRICK)
    # K8 shares K6's body: the pre-reduction is written once.
    for name in ("sample_views_grad_t", "sample_views_grad"):
        kernel = (CSRC / f"{name}.cu").read_text()
        assert "brick_scatter(p, sm, box, bv, c0, CH);" in kernel
        assert "atomicAdd(" not in kernel


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


def _windows(m, s, h, w, budget):
    """Per view and brick: its box (x0, x1, y0, y1), pixels, and whether
    the scatter takes the window path (the box has pixels, within the
    budget)."""
    boxes, pixels = brick_windows(m[None], s, h, w)
    boxes, pixels = boxes[0], pixels[0]
    fits = (pixels > 0) & (pixels <= budget)
    return boxes, pixels, fits


def _scatter_model(tile, m, shape, s, budget):
    """K6's body, brick by brick (brick_scatter): ``tile(v, vox)`` is the
    brick's gradient tile (C, voxels) as the kernel loads it.  Window path:
    the brick's taps summed by pixel of its box (the kernel's counting sort
    and per-pixel sums), each pixel's sum added to dF; direct path: each
    tap added to dF.  Where a voxel's gradients are not all finite, each
    such g first adds 0 * g at the clamped pixel of each of the voxel's
    taps off the map, if the voxel is in front of the camera (edge_taps)."""
    bv, h, w, c = shape
    xs, ys, wts, inside = _taps(m, s, h, w)
    front = _project(m, s)[..., 2] > 0
    boxes, pixels, fits = _windows(m, s, h, w, budget)
    df = torch.zeros(bv, h * w, c)
    for v in range(bv):
        for bi, vox in enumerate(_bricks(s, AGG_BRICK)):
            keep = inside[v, vox]                            # (n, 4)
            g = tile(v, vox).T                               # (n, C)
            if not bool(g.isfinite().all()):
                off = front[v, vox][:, None] & ~keep
                cx = xs[v, vox].clamp(0, w - 1)
                cy = ys[v, vox].clamp(0, h - 1)
                for k in range(4):
                    sel = off[:, k]
                    df[v].index_add_(0, cy[sel, k] * w + cx[sel, k],
                                     torch.where(g[sel].isfinite(), 0.0,
                                                 0.0 * g[sel]))
            terms = (g[:, None, :] * wts[v, vox][..., None])[keep]
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


def _k6_model(g, m, shape, s, budget):
    """K6: the tile is g's (C, S^3) columns of the brick's voxels."""
    return _scatter_model(lambda v, vox: g[v][:, vox], m, shape, s, budget)


def _k8_model(g, m, shape, s, budget):
    """K8: the tile loaded from g's voxels-major rows, chunk by chunk of 32
    channels, at ((gx * S + gy) * S + gz) * C + c0 + cc of the flattened
    view, bfloat16 widened; then K6's body."""
    c = shape[-1]
    flat = g.float().reshape(shape[0], -1)

    def tile(v, vox):
        rows = torch.cat([flat[v][vox[:, None] * c + c0
                                  + torch.arange(min(AGG_CHUNK, c - c0))]
                          for c0 in range(0, c, AGG_CHUNK)], 1)
        return rows.T

    return _scatter_model(tile, m, shape, s, budget)


def _map_taps(m, s, h, w, c):
    """Each view's and voxel's tap offsets (y * W + x) * C into the
    flattened map of the tap's pixel clamped to the map, -1 for a voxel
    behind the camera, and weights, 0 for a tap off the map
    (sample_brick.cuh's map_taps)."""
    xs, ys, wts, inside = _taps(m, s, h, w)
    front = (_project(m, s)[..., 2] > 0)[..., None].expand_as(inside)
    off = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)) * c
    return (torch.where(front, off, -1),
            torch.where(inside, wts, torch.zeros_like(wts)))


def _gather(flat, off, wt, c0, ch):
    """gather4 over a chunk: channels c0..c0+ch of the voxels' samples, the
    taps summed k = 0..3, a voxel behind the camera reading pixel 0 and
    dropped by a select."""
    val = torch.zeros(len(off), ch)
    cols = c0 + torch.arange(ch)
    for k in range(4):
        keep = off[:, k, None] >= 0
        vals = flat[off[:, k, None].clamp_min(0) + cols]
        val = torch.where(keep, val + wt[:, k, None] * vals, val)
    return val


def _k5_model(feats, m, s):
    """K5: taps read from the map; each brick's samples into the (C,
    voxels) tile, stored as channel rows."""
    bv, h, w, c = feats.shape
    off, wts = _map_taps(m, s, h, w, c)
    flat = feats.float().reshape(bv, -1)
    out = torch.zeros((bv, c, s ** 3))
    written = torch.zeros(out.shape, dtype=torch.int64)
    for v in range(bv):
        for vox in _bricks(s, K5_BRICK):
            for c0 in range(0, c, AGG_CHUNK):
                ch = min(AGG_CHUNK, c - c0)
                out[v, c0:c0 + ch, vox] = _gather(flat[v], off[v, vox],
                                                  wts[v, vox], c0, ch).T
                written[v, c0:c0 + ch, vox] += 1
    assert bool((written == 1).all())        # every element written once
    return out


def _k7_model(feats, m, s, out_dtype=torch.float32):
    """K7: taps read from the map (bfloat16 features widened); each brick's
    samples written as rows at ((gx * S + gy) * S + gz) * C + c0 + cc of
    the flattened view, rounded once to ``out_dtype``."""
    bv, h, w, c = feats.shape
    off, wts = _map_taps(m, s, h, w, c)
    flat = feats.float().reshape(bv, -1)
    out = torch.zeros((bv, s ** 3 * c))
    written = torch.zeros(out.shape, dtype=torch.int64)
    for v in range(bv):
        for vox in _bricks(s, AGG_BRICK):
            for c0 in range(0, c, AGG_CHUNK):
                ch = min(AGG_CHUNK, c - c0)
                rows = vox[:, None] * c + c0 + torch.arange(ch)
                out[v][rows] = _gather(flat[v], off[v, vox], wts[v, vox], c0,
                                       ch)
                written[v][rows] += 1
    assert bool((written == 1).all())        # every element written once
    return out.reshape(bv, s ** 3, c).to(out_dtype)


def _paths_taken(m, s, h, w, budget):
    """Budget 0 takes every brick with a tap in the map down the direct
    path, K6_WINDOW every one down the window path, the middle budget some
    down each."""
    _, pixels, fits = _windows(m, s, h, w, budget)
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
    _paths_taken(m, s, shape[1], shape[2], budget)
    got = _k6_model(g, m, shape, s, budget)
    ref = sample.sample_views_grad_t_plain(g, m, shape, s)
    assert bool((got[5] == 0).all()) and bool((got[1] == 0).all())
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("budget", [0, 40, K6_WINDOW])
@pytest.mark.parametrize("s, c", [(7, 40), (10, 17), (13, 8)])
def test_k8_model_of_both_paths_is_the_plain_scatter(s, c, budget, g_dtype):
    """K8's tile from whole voxels-major rows, then K6's body: equal to
    sample_views_grad_plain for float32 and bfloat16 g (widened), and to
    the K6 model on the transposed cotangent; a masked view (a gradient of
    0) and the view behind its camera get no gradient."""
    feats, m = _scene(s, seed=s, c=c)
    shape = tuple(feats.shape)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        shape[0], s ** 3, c).astype(np.float32)).to(g_dtype)
    g[5] = 0.0
    _paths_taken(m, s, shape[1], shape[2], budget)
    got = _k8_model(g, m, shape, s, budget)
    ref = sample.sample_views_grad_plain(g, m, shape, s)
    assert bool((got[5] == 0).all()) and bool((got[1] == 0).all())
    atol = 1e-5 * ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)
    k6 = _k6_model(g.float().transpose(1, 2), m, shape, s, budget)
    torch.testing.assert_close(got, k6, rtol=0, atol=atol)


def _nonfinite_g(shape_g, s, m, h, w, seed):
    """A cotangent (BV, S^3, C) with NaN, +inf and -inf at voxels that
    have a tap off the map (views 0, 3, 4: partly, wholly and across the
    edge), a few inside, and NaN over view 1, behind its camera."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(*shape_g).astype(np.float32))
    _, _, _, inside = _taps(m, s, h, w)
    front = _project(m, s)[..., 2] > 0
    for v in (0, 3, 4):
        off = torch.nonzero(front[v] & ~inside[v].all(-1))[:, 0]
        ins = torch.nonzero(inside[v].all(-1))[:, 0]
        for i, val in enumerate((math.nan, math.inf, -math.inf)):
            g[v, off[i::7][:3], i::3] = val
            if len(ins):
                g[v, ins[i::11][:1], i] = val
    g[1] = math.nan
    return g


@pytest.mark.parametrize("kernel", ["K6", "K8"])
@pytest.mark.parametrize("budget", [0, 40, K6_WINDOW])
@pytest.mark.parametrize("s, c", [(7, 40), (10, 17)])
def test_scatter_models_carry_nonfinite_g_as_the_plain_scatter(s, c, budget,
                                                               kernel):
    """NaN and infinities in g at voxels with taps off the map reach dF at
    those taps' clamped pixels (0 * g, as the plain version and lt_tpu's
    autodiff), those inside at their pixels; view 1, behind its camera,
    gets nothing; every finite value within 1e-5 of the largest."""
    feats, m = _scene(s, seed=s, c=c)
    shape = tuple(feats.shape)
    g = _nonfinite_g((shape[0], s ** 3, c), s, m, shape[1], shape[2], s)
    if kernel == "K6":
        got = _k6_model(g.transpose(1, 2), m, shape, s, budget)
        ref = sample.sample_views_grad_t_plain(g.transpose(1, 2), m, shape,
                                               s)
    else:
        got = _k8_model(g, m, shape, s, budget)
        ref = sample.sample_views_grad_plain(g, m, shape, s)
    nan = ref.isnan()
    assert bool(nan[[0, 3, 4]].flatten(1).any(1).all())
    assert bool((ref[1] == 0).all())
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[ref.isinf()], ref[ref.isinf()])
    fin = ref.isfinite()
    torch.testing.assert_close(got[fin], ref[fin], rtol=0,
                               atol=1e-5 * ref[fin].abs().max().item())


def _edges_nonfinite(feats, m, s, model, plain):
    """With NaN in the maps' first row, +inf in their first column and
    -inf in their last column (every third channel each), ``model`` (voxels
    -major samples, float32) has NaN exactly where ``plain`` has it (the
    taps off the map read the edge with weight 0: inf * 0 = NaN), its
    infinities and its finite values within 1e-6 of the largest; view 1,
    behind its camera, stays 0."""
    edge = feats.clone()
    edge[:, 0, :, 0::3] = float("nan")
    edge[:, :, 0, 1::3] = float("inf")
    edge[:, :, -1, 2::3] = -float("inf")
    got, ref = model(edge).float(), plain(edge).float()
    nan = ref.isnan()
    assert bool(nan.any())
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[ref.isinf()], ref[ref.isinf()])
    fin = ref.isfinite()
    torch.testing.assert_close(got[fin], ref[fin], rtol=0,
                               atol=1e-6 * ref[fin].abs().max().item())
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("s, c", [(7, 40), (10, 17), (13, 8)])
def test_k5_model_of_both_paths_is_the_plain_sample(s, c):
    """Taps read from the map, a tap off the map at its clamped pixel with
    weight 0: equal to sample_views_t_plain, also with NaN and infinities
    on the maps' edges."""
    feats, m = _scene(s, seed=s, c=c)
    ref = sample.sample_views_t_plain(feats, m, s)
    got = _k5_model(feats, m, s)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    _edges_nonfinite(feats, m, s,
                     lambda f: _k5_model(f, m, s).transpose(1, 2),
                     lambda f: sample.sample_views_t_plain(f, m, s)
                     .transpose(1, 2))


@pytest.mark.parametrize("in_dtype, out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("s", [7, 10, 13])
@pytest.mark.parametrize("c", [40, 17, 8])
def test_k7_model_of_its_bricks_is_the_plain_sample(c, s, in_dtype,
                                                     out_dtype):
    """Voxels-major rows, brick by brick: equal to sample_views_plain on
    _scene's edge views (one bfloat16 ulp of the largest value where the
    output is bfloat16: the two round once, from float32 sums in another
    order) and to the K5 model transposed (bit for bit, rounded once);
    with NaN and infinities on the maps' edges, the plain version's NaN
    and infinities."""
    feats, m = _scene(s, seed=s, c=c)
    feats = feats.to(in_dtype)
    got = _k7_model(feats, m, s, out_dtype)
    assert got.dtype == out_dtype
    ref = sample.sample_views_plain(feats, m, s, out_dtype)
    atol = (2.0 ** -7 * ref.abs().max().item() if out_dtype == torch.bfloat16
            else 1e-6)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)
    assert torch.equal(got, _k5_model(feats, m, s).transpose(1, 2)
                       .to(out_dtype))
    assert bool((got[1] == 0).all()) and bool((got[3] == 0).all())
    _edges_nonfinite(feats, m, s, lambda f: _k7_model(f, m, s, out_dtype),
                     lambda f: sample.sample_views_plain(f, m, s,
                                                         out_dtype))


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_take_the_plain_versions_on_the_cpu_whatever_the_plan(
        kernel):
    feats, m = _scene(7, seed=0)
    shape = tuple(feats.shape)
    plan = sample_plan(kernel, 40, 7, 24 if "grad" in kernel else 0)
    gen = torch.Generator().manual_seed(0)
    if kernel == "sample_views_t":
        got, ref = (sample.sample_views_t(feats, m, 7, plan),
                    sample.sample_views_t_plain(feats, m, 7))
    elif kernel == "sample_views":
        got, ref = (sample.sample_views(feats, m, 7, torch.bfloat16, plan),
                    sample.sample_views_plain(feats, m, 7, torch.bfloat16))
    elif kernel == "sample_views_grad_t":
        g = torch.randn(6, 40, 7 ** 3, generator=gen)
        got, ref = (sample.sample_views_grad_t(g, m, shape, 7, plan),
                    sample.sample_views_grad_t_plain(g, m, shape, 7))
    else:
        g = torch.randn(6, 7 ** 3, 40, generator=gen)
        got, ref = (sample.sample_views_grad(g, m, shape, 7, plan),
                    sample.sample_views_grad_plain(g, m, shape, 7))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
