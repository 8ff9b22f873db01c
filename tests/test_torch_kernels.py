"""Each kernel-bearing function of lt_tpu_torch (its plain version on the
CPU) vs its lt_tpu Pallas function in interpret mode, at 8^3 / 16^3.

Tolerance: max |port - pallas| <= 1e-4 * max |pallas| (float32 sums of up
to 27 * 16 products taken in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops.pallas import conv3d as j_conv3d
from lt_tpu.ops.pallas import conv_mp as j_conv_mp
from lt_tpu.ops.pallas import res3d as j_res3d
from lt_tpu.ops.pallas import updown as j_updown
from lt_tpu_torch.ops.kernels import conv3d as t_conv3d
from lt_tpu_torch.ops.kernels import conv_mp as t_conv_mp
from lt_tpu_torch.ops.kernels import res3d as t_res3d
from lt_tpu_torch.ops.kernels import updown as t_updown

REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, ref, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


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


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (1, 16, 8, 4, 32)])
def test_max_pool3d_2x_matches_pallas(shape):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    ref = j_updown.max_pool3d_2x(jnp.asarray(x), interpret=True)
    got = t_updown.max_pool3d_2x(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_skip", [False, True])
def test_upsample3d_2x_matches_pallas(with_skip):
    rng = np.random.RandomState(5)
    cin, c = 16, 8
    x = rng.randn(2, 4, 4, 4, cin).astype(np.float32)
    w8, b8 = _w(rng, cin, 8 * c), np.tile(_b(rng, c), 8)
    skip = rng.randn(2, 8, 8, 8, c).astype(np.float32) if with_skip else None
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
