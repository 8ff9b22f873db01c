"""The port's counterparts of the TPU entry points that the model paths do
not call (``conv3d_same``, ``res3d_block_mp``, ``res3d_block_q4``,
``res3d_block_folded``, ``sample_views_affine``) vs the lt_tpu Pallas
functions in interpret mode, on the CPU, from the same numpy-seeded inputs,
at the sizes lt_tpu's own tests use.

Tolerance: max |port - pallas| <= 1e-4 * max |pallas| in float32, unless a
test states another.  The measured value stands beside each limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops import volumetric as j_vol
from lt_tpu.ops.pallas import conv3d as j_conv3d
from lt_tpu.ops.pallas import conv_mp as j_conv_mp
from lt_tpu.ops.pallas import res3d_folded as j_folded
from lt_tpu.ops.pallas import res3d_q4 as j_q4
from lt_tpu.ops.pallas import unproject as j_unproject
from lt_tpu_torch.ops.kernels import conv3d as t_conv3d
from lt_tpu_torch.ops.kernels import conv_mp as t_conv_mp
from lt_tpu_torch.ops.kernels import res3d_folded as t_folded
from lt_tpu_torch.ops.kernels import res3d_q4 as t_q4
from lt_tpu_torch.ops.kernels import sample as t_sample
from tests.test_torch_kernels import _views as _scene

REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rel_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(got - ref).max() / scale


def _close(got, ref, rel=REL):
    """NaN and the infinities where ``ref`` has them; finite values within
    ``rel`` of the largest finite |ref|."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(got[inf], ref[inf])
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all()
    if not fin.all():
        got, ref = got[fin], ref[fin]
    err = _rel_err(got, ref)
    print(f"measured relative max err {err:.2e} (limit {rel:.1e})")
    assert err <= rel, f"relative max err {err} > {rel}"


def _w(rng, *shape, scale=0.1):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _tree(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, t) for t in tree)
    if tree is None or isinstance(tree, bool):
        return tree
    return fn(tree)


def _block(rng, cin, c):
    return [_w(rng, 3, 3, 3, cin, c), _w(rng, c), _w(rng, 3, 3, 3, c, c),
            _w(rng, c)]


# ---------------------------------------------------------------------------
# Row 12: conv3d_same
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bias_relu", "residual", "bare_rect",
                                  "relu_nonfinite"])
def test_conv3d_same_matches_pallas(case):
    """Measured relative error: 2.7e-7 to 5.9e-7 (limit 1e-4).
    ``relu_nonfinite``: NaN, +inf and -inf in x and the residual; NaN and
    the infinities where the Pallas function has them (its ReLU is
    jnp.maximum, which keeps NaN)."""
    rng = np.random.RandomState(0)
    if case == "relu_nonfinite":
        x, w = rng.randn(1, 8, 8, 8, 8), _w(rng, 3, 3, 3, 8, 8)
        res = rng.randn(1, 8, 8, 8, 8)
        for a in (x, res):
            flat = a.reshape(-1)
            for v in (np.nan, np.inf, -np.inf):
                flat[rng.randint(0, flat.size, 2)] = v
        kw = dict(bias=rng.randn(8), relu=True, residual=res)
    elif case == "bias_relu":        # tests/test_pallas_conv3d.py:11
        x, w = rng.randn(2, 16, 16, 16, 8), _w(rng, 3, 3, 3, 8, 8)
        kw = dict(bias=rng.randn(8), relu=True)
    elif case == "residual":         # :27
        x, w = rng.randn(1, 8, 8, 8, 8), _w(rng, 3, 3, 3, 8, 8)
        kw = dict(bias=rng.randn(8), relu=True,
                  residual=rng.randn(1, 8, 8, 8, 8))
    else:                            # :45, in float32: no bias, X != Y != Z
        x, w = rng.randn(2, 6, 16, 8, 4), _w(rng, 3, 3, 3, 4, 8)
        kw = {}
    x = x.astype(np.float32)
    kw = {k: v if isinstance(v, bool) else v.astype(np.float32)
          for k, v in kw.items()}
    ref = j_conv3d.conv3d_same(
        jnp.asarray(x), jnp.asarray(w), interpret=True,
        **{k: _tree(jnp.asarray, v) for k, v in kw.items()})
    got = t_conv3d.conv3d_same(_t(x), _t(w),
                               **{k: _tree(_t, v) for k, v in kw.items()})
    _close(got, ref)


def test_conv3d_same_casts_weights_and_honours_out_dtype():
    """As lt_tpu (conv3d.py:153, :215): weights follow x's type, the output
    is ``out_dtype``.  bfloat16 in, float32 out vs the Pallas function on the
    same bfloat16 inputs: both sum exact products of the same values, but
    lt_tpu carries its partial sums between planes in bfloat16 (:216-221)
    and the port does not; measured 1.6e-3 of max |ref| (limit 1.6e-2)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 16, 8, 4).astype(np.float32)
    w = _w(rng, 3, 3, 3, 4, 8)
    ref = j_conv3d.conv3d_same(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               out_dtype=jnp.float32, interpret=True)
    got = t_conv3d.conv3d_same(_t(x).bfloat16(), _t(w),
                               out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, np.asarray(ref), rel=1.6e-2)
    assert t_conv3d.conv3d_same(_t(x).bfloat16(), _t(w)).dtype == \
        torch.bfloat16


def test_conv3d_same_shape_rules():
    x = torch.zeros(1, 4, 4, 4, 8)
    with pytest.raises(ValueError, match="3, 3, 3"):
        t_conv3d.conv3d_same(x, torch.zeros(7, 7, 7, 8, 8))
    with pytest.raises(ValueError, match="do not fit"):
        t_conv3d.conv3d_same(x, torch.zeros(3, 3, 3, 4, 8))
    with pytest.raises(ValueError, match="residual"):
        t_conv3d.conv3d_same(x, torch.zeros(3, 3, 3, 8, 8),
                             residual=torch.zeros(1, 4, 4, 4, 4))


# ---------------------------------------------------------------------------
# Rows 13-15: the three schedules of the Res3D block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("variant", ["identity", "projection_tail"])
def test_res3d_block_mp_matches_pallas(variant, s):
    """tests/test_conv_mp.py:41, :56 (side 8, 5 channels; 3 -> 5 projection
    and a 5 -> 4 tail).  Measured relative error: 1.9e-7 to 3.7e-7 (limit
    1e-4)."""
    rng = np.random.RandomState(2)
    cin, c = (5, 5) if variant == "identity" else (3, 5)
    x = rng.randn(2, 8, 8, 8, cin).astype(np.float32)
    blk = _block(rng, cin, c)
    skip_proj, tail = None, ()
    if variant == "projection_tail":
        skip_proj = (_w(rng, cin, c), _w(rng, c))
        tail = ((_w(rng, c, 4), _w(rng, 4), True),)
    ref = j_conv_mp.res3d_block_mp(
        jnp.asarray(x), *_tree(jnp.asarray, blk),
        skip_proj=_tree(jnp.asarray, skip_proj),
        tail=_tree(jnp.asarray, tail), s=s, interpret=True)
    got = t_conv_mp.res3d_block_mp(
        _t(x), *_tree(_t, blk), skip_proj=_tree(_t, skip_proj),
        tail=_tree(_t, tail), s=s)
    _close(got, ref)


@pytest.mark.parametrize("variant, side, batch", [
    ("identity", 8, 2), ("identity", 12, 2), ("projection", 8, 2),
    ("tail", 8, 2)])
def test_res3d_block_q4_matches_pallas(variant, side, batch):
    """tests/test_pallas_res3d_q4.py:20, :31, :60 (32 channels; 16 -> 32
    projection; a 32 -> 16 -> 8 tail).  Measured: 5.3e-7 to 1.1e-6 (limit
    1e-4)."""
    rng = np.random.RandomState(3)
    c = 32
    cin = 16 if variant == "projection" else c
    x = rng.randn(batch, side, side, side, cin).astype(np.float32)
    blk = _block(rng, cin, c)
    skip_proj = ((_w(rng, cin, c), _w(rng, c)) if variant == "projection"
                 else None)
    tail = (((_w(rng, c, 16, scale=0.2), _w(rng, 16), True),
             (_w(rng, 16, 8, scale=0.2), _w(rng, 8), False))
            if variant == "tail" else ())
    ref = j_q4.res3d_block_q4(
        jnp.asarray(x), *_tree(jnp.asarray, blk),
        skip_proj=_tree(jnp.asarray, skip_proj),
        tail=_tree(jnp.asarray, tail), interpret=True)
    got = t_q4.res3d_block_q4(_t(x), *_tree(_t, blk),
                              skip_proj=_tree(_t, skip_proj),
                              tail=_tree(_t, tail))
    _close(got, ref)


@pytest.mark.parametrize("with_tail", [False, True])
def test_res3d_block_folded_matches_pallas(with_tail):
    """tests/test_pallas_res3d_folded.py:48, :56 (32 channels at 8^3, a
    32 -> 16 tail).  Measured: 6.6e-7 to 8.7e-7 (limit 1e-4)."""
    rng = np.random.RandomState(4)
    c = 32
    x = rng.randn(2, 8, 8, 8, c).astype(np.float32)
    blk = _block(rng, c, c)
    tail = ((_w(rng, c, 16, scale=0.2), _w(rng, 16), True),) if with_tail \
        else ()
    ref = j_folded.res3d_block_folded(
        jnp.asarray(x), *_tree(jnp.asarray, blk),
        tail=_tree(jnp.asarray, tail), interpret=True)
    got = t_folded.res3d_block_folded(_t(x), *_tree(_t, blk),
                                      tail=_tree(_t, tail))
    _close(got, ref)


def test_res3d_entry_points_raise_where_lt_tpu_asserts():
    """X % s (conv_mp.py:367), X % 4 (res3d_q4.py:187), even X, Z % 4 and
    Cin == C (res3d_folded.py:231-235), identity skip without a projection
    (conv_mp.py:370, res3d_q4.py:190)."""
    rng = np.random.RandomState(5)
    same = _tree(_t, _block(rng, 8, 8))
    wide = _tree(_t, _block(rng, 4, 8))

    def x(sx, sz=4, c=8):
        return torch.zeros(1, sx, 4, sz, c)

    for fn_j, args in ((j_conv_mp.res3d_block_mp, dict(s=4)),
                       (j_q4.res3d_block_q4, {})):
        with pytest.raises(AssertionError):
            fn_j(jnp.zeros((1, 6, 4, 4, 8)), *_tree(jnp.asarray, _block(
                rng, 8, 8)), interpret=True, **args)
    with pytest.raises(ValueError, match="X % s"):
        t_conv_mp.res3d_block_mp(x(6), *same, s=4)
    t_conv_mp.res3d_block_mp(x(6), *same, s=2)
    with pytest.raises(ValueError, match="X % 4"):
        t_q4.res3d_block_q4(x(6), *same)
    for fn in (t_conv_mp.res3d_block_mp, t_q4.res3d_block_q4):
        with pytest.raises(ValueError, match="identity skip"):
            fn(x(4, c=4), *wide)
    with pytest.raises(ValueError, match="even X"):
        t_folded.res3d_block_folded(x(3), *same)
    with pytest.raises(ValueError, match="Z % 4"):
        t_folded.res3d_block_folded(x(4, sz=6), *same)
    with pytest.raises(ValueError, match="identity"):
        t_folded.res3d_block_folded(x(4, c=4), *wide)


# ---------------------------------------------------------------------------
# Rows 10-11: sample_views_affine, voxels-major
# ---------------------------------------------------------------------------


def _views(seed, **kw):
    """The scene of tests/test_torch_kernels.py (a non-square map, cameras
    that see most of an S^3 grid, one view partly and one wholly behind its
    camera), flattened over views: (features (BV, H, W, C), proj, base,
    side, S, m (BV, 3, 4))."""
    feats, proj, base, side, s, m = _scene(seed, **kw)
    return (feats.reshape((-1,) + feats.shape[2:]), proj, base, side, s,
            m.reshape(-1, 3, 4))


def test_sample_views_matches_pallas():
    """K7's plain version vs _sample_views_fwd_impl in interpret mode, both
    of its pallas_call sites (unbanded, :548, and banded, :581).  Limit
    1e-4; measured 1.0e-5 for both (the Pallas float32 mode drops the lo*lo
    term of its bf16 split)."""
    feats, _, _, _, s, m = _views(0)
    got = t_sample.sample_views(_t(feats), m, s)
    for band_width in (None, 4):
        ref = j_unproject._sample_views_fwd_impl(
            jnp.asarray(feats), jnp.asarray(m.numpy()), s, tile=64,
            band_width=band_width, interpret=True)
        _close(got, ref)
    bv, c = feats.shape[0], feats.shape[-1]
    assert np.all(got.numpy().reshape(2, 3, s ** 3, c)[1, 2] == 0.0)
    # The two orientations of the port are each other's transpose.
    assert torch.equal(got, t_sample.sample_views_t(_t(feats), m, s)
                       .transpose(1, 2))
    assert got.shape == (bv, s ** 3, c)


def test_sample_views_out_dtype_matches_pallas():
    """out_dtype=bfloat16 (unproject.py:558): one rounding of the same
    float32 samples; within one bfloat16 ulp (2^-8 of max |ref|; measured
    1.5e-3)."""
    feats, _, _, _, s, m = _views(1)
    ref = j_unproject._sample_views_fwd_impl(
        jnp.asarray(feats), jnp.asarray(m.numpy()), s, band_width=None,
        interpret=True, out_dtype=jnp.bfloat16)
    got = t_sample.sample_views(_t(feats), m, s, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(ref.astype(jnp.float32)), rel=2.0 ** -8)


def test_sample_views_grad_matches_pallas():
    """K8's plain version vs _sample_views_grad_features in interpret mode.
    The Pallas body rounds its weights and g to bfloat16
    (unproject.py:876-880): atol 2e-2 * max |ref|, rtol 1e-2, the tolerance
    that holds K6 to its TPU kernel in tests/test_torch_kernels.py."""
    feats, _, _, _, s, m = _views(2)
    shape = feats.shape
    g = np.random.RandomState(3).randn(shape[0], s ** 3, shape[-1]).astype(
        np.float32)
    ref = np.asarray(j_unproject._sample_views_grad_features(
        jnp.asarray(g), jnp.asarray(m.numpy()), shape, s, 256, True))
    got = t_sample.sample_views_grad(_t(g), m, shape, s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2,
                               atol=2e-2 * np.abs(ref).max())


def test_sample_views_grad_matches_xla_autodiff():
    """K8's plain version vs jax.vjp of lt_tpu's plain sampling
    (``volumetric.unproject_heatmaps`` with one view per sample: 'sum' over
    one view is the sampling itself).  Limit 1e-4; measured 1.0e-6 for the
    gradient, 1.8e-6 for the forward."""
    feats, proj, base, side, s, m = _views(4)
    bv, h, w, c = feats.shape
    g = np.random.RandomState(5).randn(bv, s ** 3, c).astype(np.float32)
    cv = j_vol.build_coord_volumes(jnp.asarray(np.repeat(base, 3, axis=0)),
                                   side, s)

    def f(x):
        return j_vol.unproject_heatmaps(
            x, jnp.asarray(proj.reshape(bv, 1, 3, 4)), cv, "sum", None, None)

    out, pull = jax.vjp(f, jnp.asarray(feats.reshape(bv, 1, h, w, c)))
    cot = g.transpose(0, 2, 1).reshape(bv, c, s, s, s)
    ref = np.asarray(pull(jnp.asarray(cot))[0]).reshape(bv, h, w, c)
    _close(t_sample.sample_views_grad(_t(g), m, feats.shape, s), ref)
    # ... and the forward against the same plain sampling.
    _close(t_sample.sample_views(_t(feats), m, s),
           np.asarray(out).reshape(bv, c, s ** 3).transpose(0, 2, 1))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_sample_views_affine_backward_is_the_plain_scatter(out_dtype):
    """The autograd Function: its backward is K8 on the cotangent (bit for
    bit the plain scatter on the CPU), the matrices get no gradient, and
    the gradient comes back in the features' type."""
    feats, _, _, _, s, m = _views(6)
    x = _t(feats).requires_grad_()
    mm = m.clone().requires_grad_()
    out = t_sample.sample_views_affine(x, mm, s, out_dtype)
    assert out.dtype == out_dtype
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)
                    ).to(out_dtype)
    out.backward(g)
    assert mm.grad is None and x.grad.dtype == torch.float32
    assert torch.equal(x.grad, t_sample.sample_views_grad_plain(
        g, m, tuple(x.shape), s))


def test_sample_views_affine_gradcheck():
    """torch.autograd.gradcheck in float64 on a scene without edge voxels'
    kinks: the analytic backward (the scatter) against finite differences
    of the forward (the gather)."""
    feats, _, _, _, s, m = _views(7, b=1, v=2, h=6, w=5, c=3, s=4,
                                  behind=False)
    x = torch.from_numpy(feats).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: t_sample.sample_views_affine(f, m.double(), s,
                                               torch.float64),
        (x,), eps=1e-6, atol=1e-6)


def test_sample_views_shape_rules():
    feats, _, _, _, s, m = _views(8)
    with pytest.raises(ValueError, match="affine"):
        t_sample.sample_views(_t(feats), m[:-1], s)
    with pytest.raises(ValueError, match="g "):
        t_sample.sample_views_grad(torch.zeros(6, 8, s ** 3), m, feats.shape,
                                   s)
