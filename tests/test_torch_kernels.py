"""Each kernel-bearing function of lt_tpu_torch (its plain version on the
CPU) vs its lt_tpu Pallas function in interpret mode, at 8^3 / 16^3; the
sampling kernels K5 / K6 and the fused-aggregation gradient also vs XLA
autodiff of ``lt_tpu.ops.volumetric.unproject_heatmaps``.

Tolerance: max |port - pallas| <= 1e-4 * max |pallas| (float32 sums of up
to 27 * 16 products taken in other orders), unless a test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops import volumetric as j_vol
from lt_tpu.ops.pallas import conv3d as j_conv3d
from lt_tpu.ops.pallas import conv_mp as j_conv_mp
from lt_tpu.ops.pallas import res3d as j_res3d
from lt_tpu.ops.pallas import unproject as j_unproject
from lt_tpu.ops.pallas import updown as j_updown
from lt_tpu_torch.ops import volumetric as t_vol
from lt_tpu_torch.ops.kernels import conv3d as t_conv3d
from lt_tpu_torch.ops.kernels import conv_mp as t_conv_mp
from lt_tpu_torch.ops.kernels import res3d as t_res3d
from lt_tpu_torch.ops.kernels import sample as t_sample
from lt_tpu_torch.ops.kernels import unproject as t_unproject
from lt_tpu_torch.ops.kernels import updown as t_updown

REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, ref, rel=REL):
    """NaN and the infinities where ``ref`` has them; finite values within
    ``rel`` of the largest finite |ref|."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(got[inf], ref[inf])
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all()
    scale = np.abs(ref[fin]).max()
    assert scale > 0
    err = np.abs(got[fin] - ref[fin]).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def _plant(rng, a, count=3):
    """``a`` with NaN, +inf and -inf each at ``count`` random elements (in
    place; returns a)."""
    flat = a.reshape(-1)
    for v in (np.nan, np.inf, -np.inf):
        flat[rng.randint(0, flat.size, count)] = v
    return a


def _w(rng, *shape):
    fan_in = int(np.prod(shape[:-1]))
    return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)


def _b(rng, c):
    return (0.1 * rng.randn(c)).astype(np.float32)


def _block(rng, cin, c, proj=False):
    blk = [_w(rng, 3, 3, 3, cin, c), _b(rng, c), _w(rng, 3, 3, 3, c, c),
           _b(rng, c)]
    if proj:
        blk.append((_w(rng, cin, c), _b(rng, c)))
    return blk


def _to_j(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_j(t) for t in tree)
    if tree is None or isinstance(tree, bool):
        return tree
    return jnp.asarray(tree)


def _to_t(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_t(t) for t in tree)
    if tree is None or isinstance(tree, bool):
        return tree
    return _t(tree)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_mp_matches_pallas(relu):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 8, 8).astype(np.float32)
    w, b = _w(rng, 7, 7, 7, 8, 16), _b(rng, 16)
    ref = j_conv_mp.conv3d_mp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              s=2, relu=relu, interpret=True)
    _close(t_conv_mp.conv3d_mp(_t(x), _t(w), _t(b), relu=relu), ref)


@pytest.mark.parametrize("side", [8, 16])
@pytest.mark.parametrize("variant", ["identity", "projection", "tail",
                                     "emit_pooled"])
def test_res3d_block_fused_matches_pallas(variant, side):
    rng = np.random.RandomState(1)
    c = 16
    cin = 8 if variant == "projection" else c
    x = rng.randn(2, side, side, side, cin).astype(np.float32)
    blk = _block(rng, cin, c, proj=variant == "projection")
    skip_proj = blk[4] if variant == "projection" else None
    tail = ()
    if variant == "tail":
        tail = ((_w(rng, c, c), _b(rng, c), True),
                (_w(rng, c, 5), _b(rng, 5), False))
    emit = variant == "emit_pooled"
    ref = j_res3d.res3d_block_fused(
        _to_j(x), *_to_j(blk[:4]), skip_proj=_to_j(skip_proj),
        tail=_to_j(tail), emit_pooled=emit, interpret=True)
    got = t_res3d.res3d_block_fused(
        _t(x), *_to_t(blk[:4]), skip_proj=_to_t(skip_proj),
        tail=_to_t(tail), emit_pooled=emit)
    if emit:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    else:
        _close(got, ref)


@pytest.mark.parametrize("emit_pooled", [False, True])
def test_res3d_chain_fused_matches_pallas(emit_pooled):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 8, 8).astype(np.float32)
    blocks = [_block(rng, 8, 16, proj=True), _block(rng, 16, 16),
              _block(rng, 16, 16)]
    ref = j_res3d.res3d_chain_fused(_to_j(x), _to_j(blocks),
                                    emit_pooled=emit_pooled, interpret=True)
    got = t_res3d.res3d_chain_fused(_t(x), _to_t(blocks),
                                    emit_pooled=emit_pooled)
    if emit_pooled:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    else:
        _close(got, ref)


def test_upsample_res3d_fused_with_tail_matches_pallas():
    rng = np.random.RandomState(3)
    cin, c = 16, 8
    x = rng.randn(2, 4, 4, 4, cin).astype(np.float32)
    w8 = _w(rng, cin, 8 * c)
    b8 = np.tile(_b(rng, c), 8)
    skip = rng.randn(2, 8, 8, 8, c).astype(np.float32)
    blocks = [_block(rng, c, c)]
    tail = ((_w(rng, c, c), _b(rng, c), True), (_w(rng, c, c), _b(rng, c),
                                                 True),
            (_w(rng, c, 5), _b(rng, 5), False))
    ref = j_res3d.upsample_res3d_fused(
        _to_j(x), _to_j(w8), _to_j(b8), _to_j(skip), _to_j(blocks),
        tail=_to_j(tail), interpret=True)
    got = t_res3d.upsample_res3d_fused(
        _t(x), _t(w8), _t(b8), _t(skip), _to_t(blocks), tail=_to_t(tail))
    _close(got, ref)


@pytest.mark.parametrize("shape, planted", [
    pytest.param((2, 8, 8, 8, 16), False, id="shape0"),
    pytest.param((1, 16, 8, 4, 32), False, id="shape1"),
    pytest.param((2, 8, 8, 8, 16), True, id="shape0-planted"),
    pytest.param((1, 16, 8, 4, 32), True, id="shape1-planted")])
def test_max_pool3d_2x_matches_pallas(shape, planted):
    """Bit for bit; with NaN, +inf and -inf planted and one window all NaN,
    the same NaN (jnp.maximum keeps it)."""
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    if planted:
        _plant(rng, x)
        x[0, :2, :2, :2, 0] = np.nan
    ref = j_updown.max_pool3d_2x(jnp.asarray(x), interpret=True)
    got = t_updown.max_pool3d_2x(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_skip, planted", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(True, True, id="True-planted")])
def test_upsample3d_2x_matches_pallas(with_skip, planted):
    """``planted``: NaN, +inf and -inf in x and the skip; the ReLU keeps
    NaN as jnp.maximum does."""
    rng = np.random.RandomState(5)
    cin, c = 16, 8
    x = rng.randn(2, 4, 4, 4, cin).astype(np.float32)
    w8, b8 = _w(rng, cin, 8 * c), np.tile(_b(rng, c), 8)
    skip = rng.randn(2, 8, 8, 8, c).astype(np.float32) if with_skip else None
    if planted:
        _plant(rng, x)
        _plant(rng, skip)
    ref = j_updown.upsample3d_2x(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(b8), interpret=True,
        skip=None if skip is None else jnp.asarray(skip))
    got = t_updown.upsample3d_2x(_t(x), _t(w8), _t(b8),
                                 skip=None if skip is None else _t(skip))
    _close(got, ref)


def test_fold_bn_and_pack_upsample_weights_match_jax():
    rng = np.random.RandomState(6)
    w, cb = _w(rng, 3, 3, 3, 8, 16), _b(rng, 16)
    scale, bias, mean = (1 + 0.1 * rng.randn(16)), _b(rng, 16), _b(rng, 16)
    var = 1 + 0.3 * rng.rand(16)
    bn = [np.asarray(a, np.float32) for a in (scale, bias, mean, var)]
    ref = j_conv3d.fold_bn(jnp.asarray(w), jnp.asarray(cb),
                           *map(jnp.asarray, bn))
    got = t_conv3d.fold_bn(_t(w), _t(cb), *map(_t, bn))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)

    kernel = _w(rng, 2, 2, 2, 16, 8)                    # (.., Cout, Cin)
    ref = j_updown.pack_upsample_weights(jnp.asarray(kernel),
                                         jnp.asarray(cb),
                                         *map(jnp.asarray, bn))
    got = t_updown.pack_upsample_weights(_t(kernel), _t(cb), *map(_t, bn))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# K5 / K6: per-view sampling and its feature gradient
# ---------------------------------------------------------------------------


def _views(seed, b=2, v=3, h=12, w=10, c=8, s=8, behind=True):
    """Features on a non-square map, cameras that see most of an S^3 grid
    (world coordinates = grid indices), and, with ``behind``, one view with
    w = gx - 3 (zero on a plane, negative below it) and one view with
    w = -1 everywhere.  Returns (features, proj, base, side, S, m) with m
    the port's composed (B, V, 3, 4) grid -> pixel matrices."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, v, h, w, c).astype(np.float32)
    proj = np.zeros((b, v, 3, 4), np.float32)
    proj[..., 0, :] = [1.2, 0.2, 0.1, 0.3]
    proj[..., 1, :] = [0.1, 1.3, 0.15, 0.2]
    proj[..., 2, :] = [0.02, 0.01, 0.015, 1.0]
    proj += rng.uniform(-0.05, 0.05, proj.shape).astype(np.float32)
    if behind:
        proj[1, 0, 2, :] = [1.0, 0.0, 0.0, -3.0]
        proj[1, 2, 2, :] = [0.0, 0.0, 0.0, -1.0]
    base = np.full((b, 3), (s - 1) / 2.0, np.float32)
    side = float(s - 1)
    aff = t_vol.coord_volume_affine(_t(base), side, s)
    m = t_unproject.compose_grid_projection(_t(proj), aff)
    return feats, proj, base, side, s, m


def _xla_unproject_vjp(feats, proj, base, side, s, method, mask, cot):
    """d <cot, lt_tpu's XLA unproject_heatmaps> / d features."""
    cv = j_vol.build_coord_volumes(jnp.asarray(base), side, s)

    def f(x):
        return j_vol.unproject_heatmaps(
            x, jnp.asarray(proj), cv, method, None,
            None if mask is None else jnp.asarray(mask))

    out, pull = jax.vjp(f, jnp.asarray(feats))
    return np.asarray(out), np.asarray(pull(jnp.asarray(cot))[0])


def test_sample_views_t_matches_pallas():
    """K5 plain vs _sample_views_fwd_impl_t in interpret mode, at rel 1e-5
    (the Pallas float32 mode drops the lo*lo term of its bf16 split)."""
    feats, _, _, _, s, m = _views(0)
    b, v, h, w, c = feats.shape
    f, mm = feats.reshape(b * v, h, w, c), m.reshape(b * v, 3, 4)
    ref = j_unproject._sample_views_fwd_impl_t(
        jnp.asarray(f), jnp.asarray(mm.numpy()), s, interpret=True)
    got = t_sample.sample_views_t(_t(f), mm, s)
    _close(got, ref, rel=1e-5)
    assert np.all(got.numpy().reshape(b, v, c, s, s, s)[1, 2] == 0.0)


def test_sample_views_grad_t_matches_pallas():
    """K6 plain vs _sample_views_grad_features_t in interpret mode.  The
    Pallas kernel rounds its bilinear weights and products to bf16
    (unproject.py:961, :970): atol 2e-2 * max |ref|, rtol 1e-2, as
    tests/test_pallas_unproject.py holds it."""
    feats, _, _, _, s, m = _views(1)
    b, v, h, w, c = feats.shape
    shape, mm = (b * v, h, w, c), m.reshape(b * v, 3, 4)
    g = np.random.RandomState(2).randn(b * v, c, s ** 3).astype(np.float32)
    ref = np.asarray(j_unproject._sample_views_grad_features_t(
        jnp.asarray(g), jnp.asarray(mm.numpy()), shape, s, 256, 16, True))
    got = t_sample.sample_views_grad_t(_t(g), mm, shape, s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2,
                               atol=2e-2 * np.abs(ref).max())


def test_sample_views_grad_t_matches_xla_autodiff():
    """K6 plain vs XLA autodiff of unproject_heatmaps with one view per
    sample ('sum' over one view is the sampling itself), rel 1e-5."""
    feats, proj, base, side, s, m = _views(3)
    b, v, h, w, c = feats.shape
    g = np.random.RandomState(4).randn(b * v, c, s ** 3).astype(np.float32)
    _, ref = _xla_unproject_vjp(
        feats.reshape(b * v, 1, h, w, c), proj.reshape(b * v, 1, 3, 4),
        np.repeat(base, v, axis=0), side, s, "sum", None,
        g.reshape(b * v, c, s, s, s))
    got = t_sample.sample_views_grad_t(_t(g), m.reshape(b * v, 3, 4),
                                       (b * v, h, w, c), s)
    _close(got, ref.reshape(b * v, h, w, c), rel=1e-5)


def test_sample_views_affine_t_backward_is_grad_kernel():
    """The autograd Function: backward = K6 on the cotangent; no gradient
    for the matrices."""
    feats, _, _, _, s, m = _views(5)
    b, v, h, w, c = feats.shape
    x = _t(feats.reshape(b * v, h, w, c)).requires_grad_()
    mm = m.reshape(b * v, 3, 4).requires_grad_()
    g = torch.randn(b * v, c, s ** 3,
                    generator=torch.Generator().manual_seed(0))
    (t_sample.sample_views_affine_t(x, mm, s) * g).sum().backward()
    assert mm.grad is None
    assert torch.equal(x.grad, t_sample.sample_views_grad_t(
        g, mm.detach(), (b * v, h, w, c), s))


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("method", ["softmax", "sum"])
def test_sample_views_agg_grad_matches_xla_autodiff(method, use_mask):
    """The fused aggregation's gradient (K1 forward; K5, the VJP and K6
    backward) vs XLA autodiff of unproject_heatmaps, rel 1e-4; sample 1 has
    a view at w <= 0 everywhere and one partly behind its camera."""
    feats, proj, base, side, s, m = _views(6)
    b, v, h, w, c = feats.shape
    mask = None
    if use_mask:
        mask = np.ones((b, v), np.float32)
        mask[0, 1] = 0.0
    cot = np.random.RandomState(7).randn(b, c, s, s, s).astype(np.float32)
    ref_out, ref = _xla_unproject_vjp(feats, proj, base, side, s, method,
                                      mask, cot)
    x = _t(feats).requires_grad_()
    vm = (torch.ones(b, v) if mask is None else _t(mask))
    out = t_unproject.sample_views_agg(x, m, vm, method, s)      # (B, N, C)
    out = out.transpose(1, 2).reshape(b, c, s, s, s)
    (out * _t(cot)).sum().backward()
    _close(out.detach(), ref_out, rel=1e-5)
    _close(x.grad, ref, rel=1e-4)


@pytest.mark.parametrize("method", ["max", "conf"])
def test_unfused_training_path_grad_matches_xla_autodiff(method):
    """unproject_heatmaps_affine(fuse_aggregation=False), the training path
    of 'max' and 'conf' (K5 forward, K6 backward, aggregation in PyTorch
    ops), vs XLA autodiff of unproject_heatmaps, rel 1e-4."""
    feats, proj, base, side, s, _ = _views(8, behind=False)
    b, v, h, w, c = feats.shape
    conf = np.random.RandomState(9).uniform(0.1, 1.0, (b, v, c)).astype(
        np.float32)
    mask = np.ones((b, v), np.float32)
    mask[0, 1] = 0.0
    cot = np.random.RandomState(10).randn(b, c, s, s, s).astype(np.float32)
    cv = j_vol.build_coord_volumes(jnp.asarray(base), side, s)
    jconf = jnp.asarray(conf) if method == "conf" else None

    def f(x):
        return j_vol.unproject_heatmaps(x, jnp.asarray(proj), cv, method,
                                        jconf, jnp.asarray(mask))

    _, pull = jax.vjp(f, jnp.asarray(feats))
    ref = np.asarray(pull(jnp.asarray(cot))[0])
    x = _t(feats).requires_grad_()
    out = t_unproject.unproject_heatmaps_affine(
        x, _t(proj), t_vol.coord_volume_affine(_t(base), side, s), s, method,
        _t(conf) if method == "conf" else None, _t(mask),
        fuse_aggregation=False)
    (out * _t(cot)).sum().backward()
    _close(x.grad, ref, rel=1e-4)
