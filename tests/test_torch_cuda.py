"""The CUDA kernels against their plain versions on the card, at small and
awkward shapes (odd sizes, Cout = 17, Cin = 16, k = 1 / 3 / 7, ragged
tiles), plus K1's, K5's and K6's edge cases, K2's tensor-core bodies over
ragged channels and volumes (conv3d_mma.cu for bfloat16 inputs;
conv3d_mma_f32.cu, the split into bfloat16 parts, and its split_bf16 for
float32 inputs), K3's tensor-core body for bfloat16 (upsample3d_2x_mma.cu),
the fused aggregation's gradient, the wrappers' device / launch rules, and
V2V's folded weights after an optimizer step; K1-K4 in bfloat16, the
voxels-major sampling kernels K7 / K8 on their bricks (four type pairs,
both of K8's paths, bit for bit against K5 and within 1e-5 of K6),
``conv3d_same`` and the three
``res3d_block_*`` entry points at a small and at the flagship shape, and
V2V's per-conv and bfloat16 paths; K4's vector and scalar instances and
the plans its C entry point refuses; NaN and infinities kept by K1's
'max', K2's and K3's ReLU and K4 where their plain versions keep them.

K5 and K6 in bfloat16 (K5 into a bfloat16 output from either type, bit
for bit K7's; K6 on a bfloat16 g) on their bricks, and the ``bf16: true``
training step on the card against the same step on the CPU.

Marked ``cuda``: without a GPU every test skips.  On a machine with one
(this file imports torch only, so ``--noconftest`` keeps JAX out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| (float32, other
summation orders); TF32 is off for the plain versions.  bfloat16: 1.6e-2
(two bfloat16 ulps of the largest value), the plain version rounding where
the kernel rounds.
"""

import itertools

import pytest
import torch

pytestmark = pytest.mark.cuda

REL = 1e-4
REL_BF16 = 1.6e-2
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rel=REL):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert bool(got.isfinite().all())
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    assert err <= rel * max(ref.abs().max().item(), 1e-30), err


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * scale


@pytest.mark.parametrize("shape, k, cout, res, relu", [
    ((2, 5, 7, 9, 16), 3, 32, True, True),
    ((1, 6, 6, 6, 32), 7, 16, False, True),
    ((1, 4, 4, 4, 32), 1, 17, False, False),
    ((3, 3, 2, 5, 64), 3, 128, True, False),
    ((1, 9, 9, 9, 24), 3, 20, False, True),
])
def test_conv3d_fused(dev, shape, k, cout, res, relu):
    """float32 K2 (conv3d_mma_f32: six products of three bfloat16 parts,
    three of two for k = 7) vs true float32."""
    from lt_tpu_torch.ops.kernels import conv3d

    cin = shape[-1]
    x = _randn(dev, *shape)
    w = _randn(dev, k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5, seed=1)
    b = _randn(dev, cout, scale=0.1, seed=2)
    r = _randn(dev, *shape[:-1], cout, seed=3) if res else None
    _close(conv3d.conv3d_fused(x, w, b, r, relu),
           conv3d.conv3d_fused_plain(x, w, b, r, relu))


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("shape, cout", [((2, 3, 2, 5, 64), 32),
                                         ((1, 2, 2, 2, 128), 17)])
def test_upsample3d_2x(dev, shape, cout, with_skip):
    from lt_tpu_torch.ops.kernels import updown

    b, sx, sy, sz, cin = shape
    x = _randn(dev, *shape)
    w8 = _randn(dev, cin, 8 * cout, scale=cin ** -0.5, seed=1)
    b8 = _randn(dev, 8 * cout, scale=0.1, seed=2)
    skip = (_randn(dev, b, 2 * sx, 2 * sy, 2 * sz, cout, seed=3)
            if with_skip else None)
    _close(updown.upsample3d_2x(x, w8, b8, skip),
           updown.upsample3d_2x_plain(x, w8, b8, skip))


def _plant(t, seed=7):
    """``t`` with NaN, +inf and -inf each at three random elements (in
    place; returns t)."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    flat = t.view(-1)
    idx = torch.randint(0, flat.numel(), (3, 3), generator=g,
                        device=t.device)
    for row, v in zip(idx, (float("nan"), float("inf"), -float("inf"))):
        flat[row] = v
    return t


def _pool_equal(x, instance, planted):
    """K4 equals its plain version bit for bit, NaN included: the vector
    instance on an aligned base where C fills 16 bytes, else (and on a base
    off 16 bytes) the scalar one."""
    from lt_tpu_torch.ops.kernels import updown

    if planted:
        _plant(x)
        x[0, :2, :2, :2, 0] = float("nan")          # a window all NaN
    if instance == "scalar":
        x = _offset(x)
    got = updown.max_pool3d_2x(x)
    ref = updown.max_pool3d_2x_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert bool(ref.isnan().any()) == planted


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("instance", ["vector", "scalar"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 32), (1, 2, 2, 2, 17),
                                   (2, 4, 4, 4, 4), (1, 64, 64, 64, 32)])
def test_max_pool3d_2x(dev, shape, instance, planted):
    _pool_equal(_randn(dev, *shape), instance, planted)


@pytest.mark.parametrize("wrong", ["vec for C = 17", "vec off 16 bytes",
                                   "grid y", "too few z blocks"])
def test_max_pool3d_2x_refuses_wrong_plans(dev, monkeypatch, wrong):
    """The C entry point checks the plan against the shapes, the type and
    the pointers and launches nothing where it does not fit."""
    from lt_tpu_torch.ops.kernels import _build, updown

    c = 17 if wrong == "vec for C = 17" else 32
    x = _randn(dev, 2, 4, 6, 8, c)
    if wrong == "vec off 16 bytes":
        x = _offset(x)
    plan = updown.pool_plan(2, 4, 6, 8, c, torch.float32, True)
    bad = {"grid y": plan._replace(gy=plan.gy + 1),
           "too few z blocks": plan._replace(gx=0)}.get(
               wrong, plan._replace(vec=4))
    monkeypatch.setattr(updown, "pool_plan", lambda *args: bad)
    before = _build.LAUNCHES["max_pool3d_2x"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        updown.max_pool3d_2x(x)
    assert _build.LAUNCHES["max_pool3d_2x"] == before


def _nan_close(got, ref, rel):
    """NaN exactly where ``ref`` has it, ref's infinities elsewhere, the
    finite values within ``rel`` of the largest finite |ref|."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    want = r.isnan()
    assert want.any()
    assert torch.equal(g.isnan(), want)
    inf = r.isinf() & ~want
    assert torch.equal(g[inf], r[inf])
    fin = r.isfinite() & ~want
    assert bool(g[fin].isfinite().all())
    err = (g[fin] - r[fin]).abs().max().item()
    assert err <= rel * r[fin].abs().max().item(), err


def _plant_edges(feats):
    """NaN in the maps' first row, +inf in their last column and -inf in
    their last row (every third channel each): the pixels that taps off
    the map read, with weight 0 (in place; returns feats)."""
    feats[..., 0, :, 0::3] = float("nan")
    feats[..., :, -1, 1::3] = float("inf")
    feats[..., -1, :, 2::3] = -float("inf")
    return feats


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("kernel", ["conv3d_fused", "upsample3d_2x",
                                    "unproject_agg max",
                                    "unproject_agg softmax",
                                    "unproject_agg softmax edges",
                                    "unproject_agg sum edges",
                                    "unproject_agg softmax +inf",
                                    "unproject_agg conf masked edges",
                                    "sample_views_t edges",
                                    "sample_views_t edges own type",
                                    "sample_views edges"])
def test_kernels_keep_nan(dev, kernel, dt):
    """NaN, +inf and -inf in K2's and K3's inputs, NaN in K1's features:
    the ReLU epilogues and K1's 'max' keep NaN as their plain versions do,
    and the float32 K2 has true float32's NaN and infinities (an
    infinity's bfloat16 parts are (0, ..., 0, inf), whose last part meets
    only w's first).  'edges': NaN and
    infinities on the maps' edges, which the flagship's taps off the map
    read at their clamped pixels with weight 0 (K1, K5 and K7 as lt_tpu's
    sampler: inf * 0 = NaN; K5 reads float32 features, the bfloat16 case's
    rounded ones widened, and with 'own type' the features in their type
    into an output of it).  '+inf': +inf features inside the maps, whose
    softmax over the views is NaN.  'masked': one view masked, which 'conf'
    samples and weighs by 0, as lt_tpu does."""
    from lt_tpu_torch.ops.kernels import conv3d, sample, unproject, updown

    rel = REL if dt == torch.float32 else REL_BF16
    if kernel == "conv3d_fused":
        x, w, b, r = _conv_inputs(dev, (2, 6, 7, 8, 32), 3, 24, True, dt)
        _plant(x)
        _plant(r, seed=8)
        _nan_close(conv3d.conv3d_fused(x, w, b, r, True),
                   conv3d.conv3d_fused_plain(x, w, b, r, True), rel)
    elif kernel == "upsample3d_2x":
        x = _plant(_randn(dev, 2, 3, 4, 5, 64).to(dt))
        w8 = _randn(dev, 64, 8 * 32, scale=0.125, seed=1).to(dt)
        b8 = _randn(dev, 8 * 32, scale=0.1, seed=2)
        skip = _plant(_randn(dev, 2, 6, 8, 10, 32, seed=3).to(dt), seed=9)
        _nan_close(updown.upsample3d_2x(x, w8, b8, skip),
                   updown.upsample3d_2x_plain(x, w8, b8, skip), rel)
    elif kernel.startswith("sample_views"):
        feats, m = _flagship_k1_inputs(dev)
        b, v, h, w, c = feats.shape
        feats = _plant_edges(feats.to(dt)).reshape(b * v, h, w, c)
        m = m.reshape(b * v, 3, 4)
        if kernel == "sample_views_t edges own type":
            _nan_close(sample.sample_views_t(feats, m, FLAG, out_dtype=dt),
                       sample.sample_views_t_plain(feats, m, FLAG, dt), rel)
        elif kernel.startswith("sample_views_t"):
            feats = feats.float()
            _nan_close(sample.sample_views_t(feats, m, FLAG),
                       sample.sample_views_t_plain(feats, m, FLAG), REL)
        else:
            _nan_close(sample.sample_views(feats, m, FLAG, dt),
                       sample.sample_views_plain(feats, m, FLAG, dt), rel)
    else:
        _, method, *where = kernel.split()
        feats, m = _flagship_k1_inputs(dev)
        feats = feats.to(dt)
        mask = torch.ones(feats.shape[:2], device=dev)
        conf = None
        if where[-1:] == ["edges"]:
            _plant_edges(feats)
        elif where == ["+inf"]:
            feats[:, :, 40:56, 40:56, 1::3] = float("inf")
        else:
            feats[:, :, 44:52, 44:52, ::3] = float("nan")  # inside every map
        if where[:1] == ["masked"]:
            mask[1, 2] = 0.0
            conf = _randn(dev, *feats.shape[:2], feats.shape[-1],
                          seed=2).abs()
        _nan_close(unproject.unproject_agg(feats, m, mask, conf, method,
                                           FLAG),
                   unproject.unproject_agg_plain(feats, m, mask, conf, method,
                                                 FLAG), rel)


@pytest.mark.parametrize("kernel", ["sample_views_grad_t",
                                    "sample_views_grad_t bfloat16",
                                    "sample_views_grad float32",
                                    "sample_views_grad bfloat16"])
def test_scatters_carry_nonfinite_g_off_the_map(dev, kernel):
    """NaN, +inf and -inf in g at voxels with a tap off the map reach dF
    at the taps' clamped pixels (0 * g), as in the plain versions."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m = _flagship_k1_inputs(dev)
    b, v, h, w, c = feats.shape
    m = m.reshape(b * v, 3, 4)
    shape = (b * v, h, w, c)
    g = _randn(dev, b * v, FLAG ** 3, c, seed=5)
    uvw = sample._project(m, FLAG)
    z = uvw[..., 2]
    x0 = torch.floor(uvw[..., 0] / z * ((w - 1) / w))
    off = (z > 0) & ((x0 < 0) | (x0 + 1 > w - 1))
    for vi in range(b * v):
        idx = torch.nonzero(off[vi])[:, 0]
        for i, val in enumerate((float("nan"), float("inf"),
                                 -float("inf"))):
            g[vi, idx[i::97][:8], i::3] = val
    assert bool(off.any())
    if kernel.startswith("sample_views_grad_t"):
        gt = g.transpose(1, 2).contiguous()
        if kernel.endswith("bfloat16"):
            gt = gt.to(BF16)
        _nan_close(sample.sample_views_grad_t(gt, m, shape, FLAG),
                   sample.sample_views_grad_t_plain(gt, m, shape, FLAG), REL)
    else:
        gd = g.to(BF16) if kernel.endswith("bfloat16") else g
        _nan_close(sample.sample_views_grad(gd, m, shape, FLAG),
                   sample.sample_views_grad_plain(gd, m, shape, FLAG), REL)


@pytest.mark.parametrize("method", ["softmax", "sum", "max", "conf"])
def test_unproject_agg_edge_cases(dev, method):
    """Non-square maps, C = 40 (two lane groups), voxels behind cameras,
    w == 0 exactly, and a sample whose views are all masked."""
    from lt_tpu_torch.ops.kernels import unproject

    b, v, h, w, c, s = 2, 3, 12, 10, 40, 8
    feats = _randn(dev, b, v, h, w, c)
    m = torch.zeros(b, v, 3, 4, device=dev)
    m[..., 0, :] = torch.tensor([1.2, 0.2, 0.1, 0.3])
    m[..., 1, :] = torch.tensor([0.1, 1.3, 0.15, 0.2])
    m[..., 2, :] = torch.tensor([0.02, 0.01, 0.015, 1.0])
    m += _randn(dev, b, v, 3, 4, scale=0.02, seed=1)
    m[1, :, 2] = torch.tensor([1.0, 0.0, 0.0, -3.0], device=dev)
    mask = torch.ones(b, v, device=dev)
    mask[0] = 0.0
    conf = _randn(dev, b, v, c, seed=2).abs() if method == "conf" else None
    got = unproject.unproject_agg(feats, m, mask, conf, method, s)
    ref = unproject.unproject_agg_plain(feats, m, mask, conf, method, s)
    _close(got, ref)
    assert bool((got.reshape(b, s, s, s, c)[1, :3] == 0).all())


def test_wrappers_count_launches_and_reject_bad_tensors(dev):
    from lt_tpu_torch.ops.kernels import _build, updown

    x = _randn(dev, 1, 4, 4, 4, 8)
    _build.reset_launches()
    updown.max_pool3d_2x(x)
    assert _build.LAUNCHES["max_pool3d_2x"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        updown.max_pool3d_2x(x.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        updown.max_pool3d_2x(x.double())
    assert _build.LAUNCHES["max_pool3d_2x"] == 1


def test_no_wrapper_takes_its_plain_version_on_the_card(dev, monkeypatch):
    """Every wrapper, old and new, in float32 and bfloat16: on a CUDA tensor
    the plain version is never called and exactly the expected kernels are
    launched."""
    from lt_tpu_torch.ops.kernels import (_build, conv3d, conv_mp, res3d,
                                          res3d_folded, res3d_q4, sample,
                                          unproject, updown)

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, names in ((conv3d, ["conv3d_fused_plain", "split_bf16_plain",
                                 "conv3d_split_plain"]),
                       (updown, ["max_pool3d_2x_plain",
                                 "upsample3d_2x_plain"]),
                       (unproject, ["unproject_agg_plain"]),
                       (sample, ["sample_views_t_plain",
                                 "sample_views_grad_t_plain",
                                 "sample_views_plain",
                                 "sample_views_grad_plain"])):
        for name in names:
            monkeypatch.setattr(mod, name, forbidden)
    for dt in (torch.float32, BF16):
        f32 = dt == torch.float32
        k2 = "conv3d_mma_f32" if f32 else "conv3d_mma"
        k3 = "upsample3d_2x" if f32 else "upsample3d_2x_mma"
        x = _randn(dev, 1, 4, 4, 4, 8).to(dt)
        w = _randn(dev, 3, 3, 3, 8, 8, scale=0.1, seed=1).to(dt)
        b = _randn(dev, 8, scale=0.1, seed=2)
        ws = (_randn(dev, 8, 8, scale=0.3, seed=3).to(dt), b)
        w8 = _randn(dev, 8, 64, scale=0.3, seed=4).to(dt)

        def k2s(n):
            """n K2 launches, each (in float32) after the splits of its
            input and of its whole weights."""
            return {k2: n, "split_bf16": 2 * n} if f32 else {k2: n}

        feats = _randn(dev, 2, 6, 5, 8, seed=5).to(dt)
        m = torch.tensor([[1., 0, 0, .3], [0, 1., 0, .2], [0, 0, 0, 1.]],
                         device=dev).expand(2, 3, 4).contiguous()
        for want, fn in (
                (k2s(1), lambda: conv3d.conv3d_same(x, w, b)),
                (k2s(1), lambda: conv_mp.conv3d_mp(x, w, b)),
                (k2s(3), lambda: conv_mp.res3d_block_mp(
                    x, w, b, w, b, skip_proj=ws, s=2)),
                (k2s(3), lambda: res3d_q4.res3d_block_q4(
                    x, w, b, w, b, tail=((ws[0], b, True),))),
                (k2s(2), lambda: res3d_folded.res3d_block_folded(
                    x, w, b, w, b)),
                ({**k2s(4), "max_pool3d_2x": 1},
                 lambda: res3d.res3d_chain_fused(
                     x, [(w, b, w, b)] * 2, emit_pooled=True)),
                ({k3: 1}, lambda: updown.upsample3d_2x(
                    x, w8, b.repeat(8))),
                ({"unproject_agg": 1}, lambda: unproject.unproject_agg(
                    feats[None], m[None], torch.ones(1, 2, device=dev), None,
                    "softmax", 4)),
                ({"sample_views": 1}, lambda: sample.sample_views(
                    feats, m, 4, out_dtype=dt))):
            _build.reset_launches()
            fn()
            got = {k: v for k, v in _build.LAUNCHES.items() if v}
            assert got == want, (dt, got, want)
    f32 = _randn(dev, 2, 6, 5, 8, seed=6).requires_grad_()
    _build.reset_launches()
    sample.sample_views_affine(f32, m, 4).sum().backward()
    sample.sample_views_affine_t(f32, m, 4).sum().backward()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "sample_views": 1, "sample_views_grad": 1, "sample_views_t": 1,
        "sample_views_grad_t": 1}


def test_v2v_kernel_path_matches_module_graph(dev):
    """V2V at 32^3: the kernel composition vs the unfused module graph."""
    from lt_tpu_torch.models.v2v import V2VModel

    fused = V2VModel(32, 17, device=dev, seed=5)
    plain = V2VModel(32, 17, use_kernels=False, device=dev, seed=5)
    x = _randn(dev, 1, 32, 32, 32, 32)
    with torch.no_grad():
        _close(fused(x), plain(x))


def _sampling_scene(dev, b=2, v=3, h=11, w=13, c=40, s=7):
    """Odd shapes (C = 40: two lane groups, S^3 = 343: a ragged tile) and
    the edge cases: view 0 of sample 1 at w <= 0 everywhere, view 1 of
    sample 1 with w == 0 exactly on the plane gx = 3, view 2 of sample 1
    projecting every voxel off the map, and taps exactly on the last row
    and column (sample 0, view 2 maps voxel (gx, gy) to pixel
    (gx * (W-1) / (S-1), gy * (H-1) / (S-1)) before the (W-1)/W scaling is
    undone by the matrix)."""
    feats = _randn(dev, b * v, h, w, c)
    m = torch.zeros(b * v, 3, 4, device=dev)
    m[:, 0] = torch.tensor([1.2, 0.2, 0.1, 0.3])
    m[:, 1] = torch.tensor([0.1, 1.3, 0.15, 0.2])
    m[:, 2] = torch.tensor([0.02, 0.01, 0.015, 1.0])
    m += _randn(dev, b * v, 3, 4, scale=0.02, seed=1)
    m[2] = 0.0                               # sample 0, view 2: exact taps
    m[2, 0, 0] = w / (s - 1)                 # x = gx*(W-1)/(S-1) after scaling
    m[2, 1, 1] = h / (s - 1)
    m[2, 2, 3] = 1.0
    m[3, 2] = torch.tensor([0.0, 0.0, 0.0, -1.0], device=dev)
    m[4, 2] = torch.tensor([1.0, 0.0, 0.0, -3.0], device=dev)
    m[5, 0, 3] = 1e4                         # every tap off the map
    return feats, m, s


def test_sample_views_t(dev):
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _sampling_scene(dev)
    got = sample.sample_views_t(feats, m, s)
    _close(got, sample.sample_views_t_plain(feats, m, s))
    assert bool((got[3] == 0).all()) and bool((got[5] == 0).all())
    # The voxel at (S-1, S-1, *) of the exact-tap view samples the last
    # pixel of the map.
    n = ((s - 1) * s + (s - 1)) * s
    torch.testing.assert_close(got[2, :, n], feats[2, -1, -1])


def test_sample_views_grad_t(dev):
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _sampling_scene(dev)
    shape = tuple(feats.shape)
    g = _randn(dev, shape[0], shape[-1], s ** 3, seed=4)
    got = sample.sample_views_grad_t(g, m, shape, s)
    _close(got, sample.sample_views_grad_t_plain(g, m, shape, s))
    assert bool((got[3] == 0).all()) and bool((got[5] == 0).all())


@pytest.mark.parametrize("method", ["softmax", "sum"])
def test_sample_views_agg_gradient(dev, method):
    """The fused aggregation's backward on the card (K5, the VJP, K6) vs
    autograd of the plain aggregation, with a masked view."""
    from lt_tpu_torch.ops.kernels import _build, unproject

    feats, m, s = _sampling_scene(dev)
    b, v = 2, 3
    feats = feats.reshape(b, v, *feats.shape[1:])
    m = m.reshape(b, v, 3, 4)
    mask = torch.ones(b, v, device=dev)
    mask[0, 1] = 0.0
    cot = _randn(dev, b, s ** 3, feats.shape[-1], seed=5)
    grads = []
    for fn in (unproject.sample_views_agg, None):
        x = feats.clone().requires_grad_()
        if fn is None:
            out = unproject.unproject_agg_plain(x, m, mask, None, method, s)
        else:
            _build.reset_launches()
            out = fn(x, m, mask, method, s)
        (out * cot).sum().backward()
        grads.append(x.grad)
    assert _build.LAUNCHES["sample_views_t"] == 1
    assert _build.LAUNCHES["sample_views_grad_t"] == 1
    _close(grads[0], grads[1])


def test_packed_params_rebuilt_after_optimizer_step(dev):
    """An in-place Adam step on the card invalidates V2V's folded weights:
    the eval kernel path then runs the new weights."""
    from lt_tpu_torch.models.v2v import V2VModel

    fused = V2VModel(32, 17, device=dev, seed=6)
    x = _randn(dev, 2, 32, 32, 32, 32)
    first = fused.packed_params()
    opt = torch.optim.Adam(fused.parameters(), lr=1e-2)
    fused.train()
    fused(x).square().mean().backward()
    opt.step()
    fused.eval()
    assert fused.packed_params() is not first
    plain = V2VModel(32, 17, use_kernels=False, device=dev, seed=6)
    plain.load_state_dict(fused.state_dict())
    plain.eval()
    with torch.no_grad():
        _close(fused(x), plain(x))


@pytest.mark.parametrize("shape", [(5, 8, 6, 6), (5, 8, 2, 2, 2),
                                   (2, 8, 1, 1, 1)])
def test_batchnorm_training_update_matches_cpu(dev, shape):
    """A training BatchNorm call on the card (cuDNN or PyTorch's CUDA
    kernel) vs the same call on the CPU: output, running mean and flax's
    biased running variance, float32 within 1e-5 relative."""
    from lt_tpu_torch.models.batchnorm import BatchNorm

    x = _randn(torch.device("cpu"), *shape, scale=2.0) + 3.0
    outs = []
    for d in ("cpu", dev):
        bn = BatchNorm(shape[1]).to(d).train()
        with torch.no_grad():
            bn.running_var.fill_(0.7)
            bn.weight.fill_(1.3)
        y = bn(x.to(d))
        outs.append((y, bn.running_mean, bn.running_var))
    for got, ref in zip(outs[1], outs[0]):
        _close(got.cpu(), ref, rel=1e-5)


# ---------------------------------------------------------------------------
# bfloat16 K1-K4, the alternative entry points, K7 / K8
# ---------------------------------------------------------------------------

FLAG = 64       # the flagship volume side


def _conv_inputs(dev, shape, k, cout, res, dt):
    cin = shape[-1]
    x = _randn(dev, *shape).to(dt)
    w = _randn(dev, k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5,
               seed=1).to(dt)
    b = _randn(dev, cout, scale=0.1, seed=2)
    r = _randn(dev, *shape[:-1], cout, seed=3).to(dt) if res else None
    return x, w, b, r


@pytest.mark.parametrize("out_dtype", [None, torch.float32, BF16])
@pytest.mark.parametrize("shape, k, cout, res, relu", [
    ((2, 5, 7, 9, 16), 3, 32, True, True),
    ((1, 6, 6, 6, 32), 7, 16, False, True),
    ((1, 4, 4, 4, 32), 1, 17, False, False),
    ((1, 9, 9, 9, 24), 3, 20, True, False),
    ((2, FLAG, FLAG, FLAG, 32), 3, 32, True, True),
])
def test_conv3d_fused_bf16(dev, shape, k, cout, res, relu, out_dtype):
    from lt_tpu_torch.ops.kernels import conv3d

    x, w, b, r = _conv_inputs(dev, shape, k, cout, res, BF16)
    got = conv3d.conv3d_fused(x, w, b, r, relu, out_dtype)
    assert got.dtype == (out_dtype or BF16)
    _close(got, conv3d.conv3d_fused_plain(x, w, b, r, relu, out_dtype),
           REL if out_dtype == torch.float32 else REL_BF16)


def test_conv3d_fused_float32_in_bfloat16_out(dev):
    from lt_tpu_torch.ops.kernels import conv3d

    x, w, b, r = _conv_inputs(dev, (1, 6, 5, 4, 16), 3, 32, True,
                              torch.float32)
    _close(conv3d.conv3d_fused(x, w, b, r, True, BF16),
           conv3d.conv3d_fused_plain(x, w, b, r, True, BF16), REL_BF16)


# K2's tensor-core body for bfloat16 (conv3d_mma.cu): every bfloat16 call.
MMA_CH = [(32, 16), (16, 32), (32, 32), (32, 64), (64, 128), (128, 128),
          (32, 17), (24, 40)]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("vol", [(2, 2, 2), (5, 6, 7), (1, 3, 5)])
@pytest.mark.parametrize("cin, cout", MMA_CH)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv3d_mma(dev, k, cin, cout, vol, batch):
    """conv3d_mma against the plain version on volumes that are not
    multiples of the brick, ragged Cin / Cout (17, 24, 40), residual and
    ReLU on and off, output bfloat16 (1.6e-2 of max |plain|) and float32
    (1e-4: the products of bfloat16 values are exact in float32; the sums
    differ in order and in the tensor cores' float32 accumulation, whose
    error grows with the number of terms)."""
    from lt_tpu_torch.ops.kernels import conv3d

    x, w, b, r = _conv_inputs(dev, (batch, *vol, cin), k, cout, True, BF16)
    for res, relu, out_dtype in itertools.product((None, r), (False, True),
                                                  (BF16, torch.float32)):
        got = conv3d.conv3d_fused(x, w, b, res, relu, out_dtype)
        _close(got, conv3d.conv3d_fused_plain(x, w, b, res, relu, out_dtype),
               REL_BF16 if out_dtype == BF16 else REL)


@pytest.mark.parametrize("shape, k, cout, misalign", [
    ((1, 5, 6, 7, 17), 3, 20, False),      # Cin % 8 != 0: element-wise halo
    ((1, 5, 6, 7, 5), 1, 3, False),
    ((2, 5, 6, 7, 12), 7, 8, False),
    ((2, 5, 6, 7, 32), 3, 32, True),       # x, w, residual 2 bytes off 16
    ((1, 6, 5, 7, 128), 9, 64, False),     # one halo buffer, reloaded
    ((2, 9, 10, 11, 128), 11, 128, False),  # a smaller brick, CK = 16
])
def test_conv3d_mma_element_paths_and_large_k(dev, shape, k, cout, misalign):
    """conv3d_mma's element-by-element loads and stores (channel counts
    that are not multiples of 8, pointers off a 16-byte boundary) and the
    plans of a large k, against the plain version."""
    from lt_tpu_torch.ops.kernels import conv3d

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, w, b, r = _conv_inputs(dev, shape, k, cout, True, BF16)
    if misalign:
        x, w, r = off(x), off(w), off(r)
        assert x.data_ptr() % 16 and x.is_contiguous()
    for out_dtype in (BF16, torch.float32):
        got = conv3d.conv3d_fused(x, w, b, r, True, out_dtype)
        _close(got, conv3d.conv3d_fused_plain(x, w, b, r, True, out_dtype),
               REL_BF16 if out_dtype == BF16 else REL)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("vol", [(2, 2, 2), (5, 6, 7), (1, 3, 5)])
@pytest.mark.parametrize("cin, cout", MMA_CH)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv3d_mma_f32(dev, k, cin, cout, vol, batch):
    """K2's float32 body (conv3d_mma_f32: three bfloat16 parts, two for
    k = 7) on test_conv3d_mma's shapes, residual and ReLU on and off,
    output float32 (relative 1e-4 of max |plain|, true float32) and
    bfloat16 (1.6e-2)."""
    from lt_tpu_torch.ops.kernels import conv3d

    x, w, b, r = _conv_inputs(dev, (batch, *vol, cin), k, cout, True,
                              torch.float32)
    for res, relu, out_dtype in itertools.product((None, r), (False, True),
                                                  (BF16, torch.float32)):
        got = conv3d.conv3d_fused(x, w, b, res, relu, out_dtype)
        _close(got, conv3d.conv3d_fused_plain(x, w, b, res, relu, out_dtype),
               REL_BF16 if out_dtype == BF16 else REL)


@pytest.mark.parametrize("shape, k, cout, misalign", [
    ((1, 5, 6, 7, 17), 3, 20, False),      # Cin % 8 != 0: element-wise halo
    ((1, 5, 6, 7, 5), 1, 3, False),
    ((2, 5, 6, 7, 12), 7, 8, False),
    ((2, 5, 6, 7, 32), 3, 32, True),       # x, w, residual 4 bytes off 16
    ((1, 6, 5, 7, 128), 9, 64, False),     # small brick, CK = 16, reloaded
    ((2, 9, 10, 11, 32), 11, 17, False),   # the largest k that fits
])
def test_conv3d_mma_f32_element_paths_and_large_k(dev, shape, k, cout,
                                                  misalign):
    """conv3d_mma_f32's element-by-element loads and stores and the plans
    of a large k, against true float32; a misaligned x and w take
    split_bf16's element path, a misaligned residual the element-by-element
    epilogue."""
    from lt_tpu_torch.ops.kernels import conv3d

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, w, b, r = _conv_inputs(dev, shape, k, cout, True, torch.float32)
    if misalign:
        x, w, r = off(x), off(w), off(r)
        assert x.data_ptr() % 16 and x.is_contiguous()
    for out_dtype in (BF16, torch.float32):
        got = conv3d.conv3d_fused(x, w, b, r, True, out_dtype)
        _close(got, conv3d.conv3d_fused_plain(x, w, b, r, True, out_dtype),
               REL_BF16 if out_dtype == BF16 else REL)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("n, offset", [(8 * 1000, 0), (1, 0), (1003, 0),
                                       (4096, 1), (2 ** 21 + 5, 0)])
def test_split_bf16(dev, n, offset, parts):
    """split_bf16 on the card is its plain version bit for bit: vector
    (n % 8 == 0, aligned) and element paths, a tiny and a huge value."""
    from lt_tpu_torch.ops.kernels import conv3d

    buf = _randn(dev, n + offset, scale=3.0)
    buf[0] = 3.3e38
    if n > 2:
        buf[offset + 1] = 1e-30
    v = buf[offset:]
    got = conv3d.split_bf16(v, parts)
    assert got.dtype == BF16 and tuple(got.shape) == (parts, n)
    assert torch.equal(got, conv3d.split_bf16_plain(v, parts))


def test_bf16_conv_launches_only_the_tensor_core_body(dev):
    """A bfloat16 K2 call counts one conv3d_mma launch, a float32 call one
    conv3d_mma_f32 launch after one split_bf16 of its input (weights given
    as their parts, as V2V packs them) or two (whole weights); each C entry
    point refuses the other's type; a bfloat16 K3 call launches
    upsample3d_2x_mma, whose CUDA-core sibling upsample3d_2x refuses
    bfloat16."""
    from lt_tpu_torch.ops.kernels import _build, conv3d, updown

    for dt, parted, want in (
            (BF16, False, {"conv3d_mma": 1}),
            (torch.float32, True, {"split_bf16": 1, "conv3d_mma_f32": 1}),
            (torch.float32, False, {"split_bf16": 2, "conv3d_mma_f32": 1})):
        x, w, b, r = _conv_inputs(dev, (2, 6, 6, 6, 32), 3, 32, True, dt)
        if parted:
            w = conv3d.split_bf16(w, conv3d.split_parts(3))
        _build.reset_launches()
        conv3d.conv3d_fused(x, w, b, r, True)
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    x, w, b, _ = _conv_inputs(dev, (1, 4, 4, 4, 8), 3, 8, False, BF16)
    out = torch.empty_like(x)
    p, i = _build.ptr, _build.i32
    plan = conv3d.conv3d_mma_plan(1, 4, 4, 4, 8, 8, 3, 3).args + (3,)
    with pytest.raises(RuntimeError, match="conv3d_mma_f32 failed"):
        _build.launch("conv3d_mma_f32", dev, [p] * 5 + [i] * (10 + len(plan)),
                      x.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                      out.data_ptr(), 1, 4, 4, 4, 8, 8, 3, 0, 1, 1, *plan)
    plan = conv3d.conv3d_mma_plan(1, 4, 4, 4, 8, 8, 3).args
    with pytest.raises(RuntimeError, match="conv3d_mma failed"):
        _build.launch("conv3d_mma", dev, [p] * 5 + [i] * (10 + len(plan)),
                      x.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                      out.data_ptr(), 1, 4, 4, 4, 8, 8, 3, 0, 0, 0, *plan)
    w8 = _randn(dev, 8, 64, scale=0.3, seed=4).to(BF16)
    b8 = _randn(dev, 64, scale=0.1, seed=5)
    _build.reset_launches()
    updown.upsample3d_2x(x, w8, b8)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "upsample3d_2x_mma": 1}
    up = torch.empty(1, 8, 8, 8, 8, dtype=BF16, device=dev)
    plan = updown.upsample_f32_plan(1, 4, 4, 4, 8, 8).args
    with pytest.raises(RuntimeError, match="upsample3d_2x failed"):
        _build.launch("upsample3d_2x", dev, [p] * 5 + [i] * (7 + len(plan)),
                      x.data_ptr(), w8.data_ptr(), b8.data_ptr(), None,
                      up.data_ptr(), 1, 4, 4, 4, 8, 8, 1, *plan)


def test_kernels_refuse_mixed_types(dev):
    from lt_tpu_torch.ops.kernels import conv3d, updown

    x, w, b, r = _conv_inputs(dev, (1, 4, 4, 4, 8), 3, 8, True, BF16)
    with pytest.raises(TypeError, match="one type"):
        conv3d.conv3d_fused(x, w.float(), b)
    with pytest.raises(TypeError, match="one type"):
        conv3d.conv3d_fused(x, w, b, r.float())
    with pytest.raises(TypeError, match="float32"):
        conv3d.conv3d_fused(x, w, b.to(BF16))
    with pytest.raises(TypeError, match="one type"):
        updown.upsample3d_2x(x, _randn(dev, 8, 64), _randn(dev, 64))


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("side, residual", [(6, True), (7, False),
                                            (FLAG, True)])
def test_conv3d_same(dev, dt, side, residual):
    from lt_tpu_torch.ops.kernels import conv3d

    b = 2 if side == FLAG else 1
    x, w, bias, r = _conv_inputs(dev, (b, side, side, side, 32), 3, 32,
                                 residual, dt)
    got = conv3d.conv3d_same(x, w.float(), bias, relu=True, residual=r)
    assert got.dtype == dt
    _close(got, conv3d.conv3d_fused_plain(x, w, bias, r, True),
           REL if dt == torch.float32 else REL_BF16)
    no_bias = conv3d.conv3d_same(x, w)
    _close(no_bias, conv3d.conv3d_fused_plain(x, w, torch.zeros_like(bias)),
           REL if dt == torch.float32 else REL_BF16)


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("shape, cout", [((2, 3, 2, 5, 64), 32),
                                         ((1, 2, 2, 2, 128), 17),
                                         ((2, 32, 32, 32, 64), 32),
                                         ((8, 2, 2, 2, 128), 128),
                                         ((8, 16, 16, 16, 128), 64),
                                         ((1, 3, 5, 7, 24), 12),
                                         ((3, 1, 1, 1, 40), 100)])
def test_upsample3d_2x_bf16(dev, shape, cout, with_skip):
    """K3's tensor-core body (upsample3d_2x_mma.cu): flagship levels, a
    ragged M tile, Cin not a multiple of 16 (24, 40), Cout whose runs are
    not 16-byte vectors (12, 17, 100: the element epilogue), with and
    without the skip."""
    from lt_tpu_torch.ops.kernels import updown

    b, sx, sy, sz, cin = shape
    x = _randn(dev, *shape).to(BF16)
    w8 = _randn(dev, cin, 8 * cout, scale=cin ** -0.5, seed=1).to(BF16)
    b8 = _randn(dev, 8 * cout, scale=0.1, seed=2)
    skip = (_randn(dev, b, 2 * sx, 2 * sy, 2 * sz, cout, seed=3).to(BF16)
            if with_skip else None)
    _close(updown.upsample3d_2x(x, w8, b8, skip),
           updown.upsample3d_2x_plain(x, w8, b8, skip), REL_BF16)


def test_upsample3d_2x_bf16_element_paths(dev):
    """x, w8 and the skip 2 bytes off a 16-byte boundary: the element-by-
    element copies and epilogue of upsample3d_2x_mma."""
    from lt_tpu_torch.ops.kernels import updown

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x = off(_randn(dev, 2, 3, 4, 5, 64).to(BF16))
    w8 = off(_randn(dev, 64, 8 * 32, scale=0.125, seed=1).to(BF16))
    b8 = _randn(dev, 8 * 32, scale=0.1, seed=2)
    skip = off(_randn(dev, 2, 6, 8, 10, 32, seed=3).to(BF16))
    assert x.data_ptr() % 16 and x.is_contiguous()
    _close(updown.upsample3d_2x(x, w8, b8, skip),
           updown.upsample3d_2x_plain(x, w8, b8, skip), REL_BF16)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("instance", ["vector", "scalar"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 32), (1, 2, 2, 2, 17),
                                   (2, 4, 4, 4, 4),
                                   (2, FLAG, FLAG, FLAG, 32)])
def test_max_pool3d_2x_bf16(dev, shape, instance, planted):
    _pool_equal(_randn(dev, *shape).to(BF16), instance, planted)


@pytest.mark.parametrize("method", ["softmax", "sum", "max", "conf"])
def test_unproject_agg_bf16(dev, method):
    """K1 with bfloat16 features: the edge-case scene, and the flagship
    shape (2 x 4 views of 96^2 x 32 into 64^3) on a perspective rig."""
    from lt_tpu_torch.ops.kernels import unproject

    b, v, h, w, c, s = 2, 3, 12, 10, 40, 8
    feats = _randn(dev, b, v, h, w, c).to(BF16)
    m = torch.zeros(b, v, 3, 4, device=dev)
    m[..., 0, :] = torch.tensor([1.2, 0.2, 0.1, 0.3])
    m[..., 1, :] = torch.tensor([0.1, 1.3, 0.15, 0.2])
    m[..., 2, :] = torch.tensor([0.02, 0.01, 0.015, 1.0])
    m += _randn(dev, b, v, 3, 4, scale=0.02, seed=1)
    m[1, :, 2] = torch.tensor([1.0, 0.0, 0.0, -3.0], device=dev)
    mask = torch.ones(b, v, device=dev)
    mask[0, 1] = 0.0
    conf = _randn(dev, b, v, c, seed=2).abs() if method == "conf" else None
    got = unproject.unproject_agg(feats, m, mask, conf, method, s)
    assert got.dtype == BF16
    _close(got, unproject.unproject_agg_plain(feats, m, mask, conf, method,
                                              s), REL_BF16)
    big = _randn(dev, 2, 4, 96, 96, 32, seed=3).to(BF16)
    mm = torch.zeros(2, 4, 3, 4, device=dev)
    mm[..., 0, :] = torch.tensor([1.4, 0.1, 0.05, 3.0])
    mm[..., 1, :] = torch.tensor([0.05, 1.4, 0.1, 2.0])
    mm[..., 2, :] = torch.tensor([0.002, 0.001, 0.0015, 1.0])
    conf = _randn(dev, 2, 4, 32, seed=4).abs() if method == "conf" else None
    ones = torch.ones(2, 4, device=dev)
    _close(unproject.unproject_agg(big, mm, ones, conf, method, FLAG),
           unproject.unproject_agg_plain(big, mm, ones, conf, method, FLAG),
           REL_BF16)


def _block_params(dev, cin, c, dt, proj=False, tail_out=None):
    def cw(k, i, o, seed):
        return _randn(dev, k, k, k, i, o, scale=(k ** 3 * i) ** -0.5,
                      seed=seed).to(dt)

    prm = [cw(3, cin, c, 1), _randn(dev, c, scale=0.1, seed=2),
           cw(3, c, c, 3), _randn(dev, c, scale=0.1, seed=4)]
    skip = ((_randn(dev, cin, c, scale=cin ** -0.5, seed=5).to(dt),
             _randn(dev, c, scale=0.1, seed=6)) if proj else None)
    tail = ()
    if tail_out:
        tail = ((_randn(dev, c, c, scale=c ** -0.5, seed=7).to(dt),
                 _randn(dev, c, scale=0.1, seed=8), True),
                (_randn(dev, c, tail_out, scale=c ** -0.5, seed=9).to(dt),
                 _randn(dev, tail_out, scale=0.1, seed=10), False))
    return prm, skip, tail


def _plain_block(x, prm, skip, tail):
    from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused_plain as cp

    def pw(x, w, b, relu=False):
        return cp(x, w.reshape(1, 1, 1, *w.shape), b, relu=relu)

    y = cp(x, prm[0], prm[1], relu=True)
    s = x if skip is None else pw(x, *skip)
    y = cp(y, prm[2], prm[3], residual=s, relu=True)
    for w, b, relu in tail:
        y = pw(y, w, b, relu)
    return y


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("side", [8, FLAG])
@pytest.mark.parametrize("entry", ["mp2", "mp4", "q4", "folded"])
def test_res3d_block_entry_points(dev, entry, side, dt):
    """res3d_block_mp (s = 2, 4; 16 -> 32 projection), res3d_block_q4 (with
    the 32 -> 17 tail) and res3d_block_folded (32 ch, tail) against the plain
    composition; a block rounds three times, hence twice the conv limit in
    bfloat16."""
    from lt_tpu_torch.ops.kernels import conv_mp, res3d_folded, res3d_q4

    proj = entry.startswith("mp")
    cin = 16 if proj else 32
    prm, skip, tail = _block_params(dev, cin, 32, dt, proj=proj,
                                    tail_out=None if proj else 17)
    x = _randn(dev, 1, side, side, side, cin).to(dt)
    if entry == "mp2":
        got = conv_mp.res3d_block_mp(x, *prm, skip_proj=skip, s=2)
    elif entry == "mp4":
        got = conv_mp.res3d_block_mp(x, *prm, skip_proj=skip, s=4)
    elif entry == "q4":
        got = res3d_q4.res3d_block_q4(x, *prm, tail=tail)
    else:
        got = res3d_folded.res3d_block_folded(x, *prm, tail=tail)
    _close(got, _plain_block(x, prm, skip, tail),
           REL if dt == torch.float32 else 2 * REL_BF16)


def test_res3d_entry_points_keep_their_shape_rules(dev):
    from lt_tpu_torch.ops.kernels import conv_mp, res3d_folded, res3d_q4

    prm, skip, _ = _block_params(dev, 16, 32, torch.float32, proj=True)
    same, _, _ = _block_params(dev, 32, 32, torch.float32)
    with pytest.raises(ValueError, match="X % s"):
        conv_mp.res3d_block_mp(_randn(dev, 1, 6, 4, 4, 16), *prm,
                               skip_proj=skip, s=4)
    with pytest.raises(ValueError, match="X % 4"):
        res3d_q4.res3d_block_q4(_randn(dev, 1, 6, 4, 4, 32), *same)
    with pytest.raises(ValueError, match="Z % 4"):
        res3d_folded.res3d_block_folded(_randn(dev, 1, 4, 4, 6, 32), *same)
    with pytest.raises(ValueError, match="identity"):
        res3d_folded.res3d_block_folded(_randn(dev, 1, 4, 4, 4, 16), *prm)


TYPE_PAIRS = [(torch.float32, torch.float32), (torch.float32, BF16),
              (BF16, torch.float32), (BF16, BF16)]


def _k7_bits(feats, m, s, out_dtype, got):
    """K7's three bit-for-bit relations: float32 (or bfloat16 widened)
    features give K5's sample transposed; a bfloat16 output is that sample
    rounded to nearest even once."""
    from lt_tpu_torch.ops.kernels import sample

    k5 = sample.sample_views_t(feats.float(), m, s).transpose(1, 2)
    torch.testing.assert_close(got, k5.to(out_dtype), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("in_dtype, out_dtype", TYPE_PAIRS)
def test_sample_views(dev, in_dtype, out_dtype):
    """K7 on the edge-case scene in all four type pairs, against its plain
    version and, bit for bit, K5's sample transposed (of the widened
    features; rounded once for a bfloat16 output): same taps, same sum.
    The views behind the camera and off the map are exactly 0."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _sampling_scene(dev)
    feats = feats.to(in_dtype)
    got = sample.sample_views(feats, m, s, out_dtype)
    assert got.dtype == out_dtype
    exact = in_dtype == out_dtype == torch.float32
    _close(got, sample.sample_views_plain(feats, m, s, out_dtype),
           REL if exact else REL_BF16)
    assert bool((got[3] == 0).all()) and bool((got[5] == 0).all())
    _k7_bits(feats, m, s, out_dtype, got)
    if out_dtype == BF16:
        f32 = sample.sample_views(feats, m, s)
        assert torch.equal(got, f32.to(BF16))


@pytest.mark.parametrize("g_dtype", [torch.float32, BF16])
def test_sample_views_grad(dev, g_dtype):
    """K8 on the edge-case scene for both g types and both plans (the
    pre-reduction and direct atomics only): against the plain scatter, and
    against K6 on the transposed cotangent (1e-5); the views behind the
    camera and off the map, and a view whose gradient is 0, get exactly
    0."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _sampling_scene(dev)
    shape = tuple(feats.shape)
    g = _randn(dev, shape[0], s ** 3, shape[-1], seed=4).to(g_dtype)
    g[1] = 0.0
    ref = sample.sample_views_grad_plain(g, m, shape, s)
    k6 = sample.sample_views_grad_t(g.float().transpose(1, 2).contiguous(), m,
                                    shape, s)
    for window in (sample.K6_WINDOW, 0):
        got = sample.sample_views_grad(
            g, m, shape, s,
            sample.sample_plan("sample_views_grad", shape[-1], s, window))
        assert got.dtype == torch.float32
        _close(got, ref)
        _close(got, k6, rel=1e-5)
        for view in (1, 3, 5):
            assert bool((got[view] == 0).all())


def test_sample_views_affine_at_training_shapes(dev):
    """20 views of 96^2 x 32 into 64^3: forward vs plain, backward vs the
    plain scatter and vs K6 on the transposed cotangent."""
    from lt_tpu_torch.ops.kernels import sample

    bv, hm, c, s = 20, 96, 32, FLAG
    feats = _randn(dev, bv, hm, hm, c).requires_grad_()
    m = torch.zeros(bv, 3, 4, device=dev)
    m[:, 0] = torch.tensor([1.4, 0.1, 0.05, 3.0])
    m[:, 1] = torch.tensor([0.05, 1.4, 0.1, 2.0])
    m[:, 2] = torch.tensor([0.002, 0.001, 0.0015, 1.0])
    m += _randn(dev, bv, 3, 4, scale=1e-3, seed=1)
    out = sample.sample_views_affine(feats, m, s)
    _close(out.detach(), sample.sample_views_plain(feats.detach(), m, s))
    g = _randn(dev, bv, s ** 3, c, seed=2)
    out.backward(g)
    _close(feats.grad, sample.sample_views_grad_plain(g, m, tuple(feats.shape),
                                                      s))
    _close(feats.grad, sample.sample_views_grad_t(
        g.transpose(1, 2).contiguous(), m, tuple(feats.shape), s), rel=1e-5)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_v2v_conv_path_matches_fused_path(dev, dt):
    """V2V at 32^3: the per-conv configuration launches K2-K4 only and
    agrees with the fused composition (the same launches in another order of
    pools: bit for bit)."""
    from lt_tpu_torch.models.v2v import V2VModel
    from lt_tpu_torch.ops.kernels import _build

    fused = V2VModel(32, 17, device=dev, seed=5, compute_dtype=dt)
    conv = V2VModel(32, 17, use_kernels="conv", device=dev, seed=5,
                    compute_dtype=dt)
    x = _randn(dev, 1, 32, 32, 32, 32)
    with torch.no_grad():
        ref = fused(x)
        _build.reset_launches()
        got = conv(x)
    assert got.dtype == dt
    assert {k for k, v in _build.LAUNCHES.items() if v} == (
        {"conv3d_mma_f32", "split_bf16", "upsample3d_2x", "max_pool3d_2x"}
        if dt == torch.float32 else
        {"conv3d_mma", "upsample3d_2x_mma", "max_pool3d_2x"})
    assert torch.equal(got, ref)


def test_v2v_bf16_kernel_path_near_float32(dev):
    """V2V at 32^3 in bfloat16 against its float32 self: relative 5e-2 of
    the output's max at random weights (about 40 roundings deep)."""
    from lt_tpu_torch.models.v2v import V2VModel

    f32 = V2VModel(32, 17, device=dev, seed=5)
    b16 = V2VModel(32, 17, device=dev, seed=5, compute_dtype=BF16)
    x = _randn(dev, 1, 32, 32, 32, 32)
    with torch.no_grad():
        ref, got = f32(x), b16(x)
    assert got.dtype == BF16
    _close(got.float(), ref, rel=5e-2)


# ---------------------------------------------------------------------------
# K1's bricks and staged windows; the float32 K3's register-tiled GEMM
# ---------------------------------------------------------------------------


def _flagship_k1_inputs(dev, batch=2):
    """Features (batch, 4, 96, 96, 32) and the flagship's composed matrices:
    the example rig, a 2500 mm cuboid around the pelvis, a 64^3 grid."""
    from lt_tpu_torch.models.triangulation import (rescale_proj_to_heatmap,
                                                   select_base_points)
    from lt_tpu_torch.ops import volumetric as vol_ops
    from lt_tpu_torch.ops.kernels.unproject import compose_grid_projection
    from lt_tpu_torch.utils.example import example_batch

    _, proj, pelvis = (torch.from_numpy(a).to(dev) for a in
                       example_batch(batch, 4, 384, 17))
    aff = vol_ops.coord_volume_affine(
        select_base_points(pelvis, "mpii"), 2500.0, FLAG)
    m = compose_grid_projection(
        rescale_proj_to_heatmap(proj, (384, 384), (96, 96)), aff).contiguous()
    return _randn(dev, batch, 4, 96, 96, 32, seed=11), m


def _edge_k1_inputs(dev):
    """test_unproject_agg_edge_cases's scene: non-square maps, C = 40,
    voxels behind the cameras and w == 0 exactly."""
    b, v, h, w, c = 2, 3, 12, 10, 40
    feats = _randn(dev, b, v, h, w, c)
    m = torch.zeros(b, v, 3, 4, device=dev)
    m[..., 0, :] = torch.tensor([1.2, 0.2, 0.1, 0.3])
    m[..., 1, :] = torch.tensor([0.1, 1.3, 0.15, 0.2])
    m[..., 2, :] = torch.tensor([0.02, 0.01, 0.015, 1.0])
    m += _randn(dev, b, v, 3, 4, scale=0.02, seed=1)
    m[1, :, 2] = torch.tensor([1.0, 0.0, 0.0, -3.0], device=dev)
    return feats, m


@pytest.mark.parametrize("scene", ["flagship", "edge", "edge_inf"])
def test_unproject_agg_sum_of_one_view_is_k5_bit_for_bit(dev, scene):
    """K1 'sum' with a one-hot view mask equals K5's sample of that view bit
    for bit (float32), with windows staged or not: both take common.cuh's
    taps and sum them k = 0..3 with ltk_tap, so the training backward (K5,
    K6) recomputes exactly the samples that K1 aggregated.  edge_inf puts
    inf in the maps' first row and column (pixel 0 of the map and of the
    windows that touch them), which taps off the map read at their clamped
    pixels with weight 0: both give the same NaN there."""
    from lt_tpu_torch.ops.kernels import sample, unproject

    feats, m = (_flagship_k1_inputs(dev) if scene == "flagship"
                else _edge_k1_inputs(dev))
    if scene == "edge_inf":
        feats[:, :, 0] = float("inf")
        feats[:, :, :, 0] = float("inf")
    b, v, h, w, c = feats.shape
    s = FLAG if scene == "flagship" else 8
    k5 = sample.sample_views_t(feats.reshape(b * v, h, w, c),
                               m.reshape(b * v, 3, 4), s).reshape(b, v, c, -1)
    for plan in (unproject.unproject_plan(c, s, 4, window=0),
                 unproject.unproject_plan(c, s, 4, window=384)):
        for view in range(v):
            mask = torch.zeros(b, v, device=dev)
            mask[:, view] = 1.0
            got = unproject.unproject_agg(feats, m, mask, None, "sum", s,
                                          plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, k5[:, view].transpose(1, 2),
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=f"view {view}, {plan}")


def _k1_scene(dev, scene, dt):
    """(features, m, S) of one of K1's brick and window cases.

    over_budget: 12 pixels a voxel in view 0 (a 4 x 8 x 8 brick spans
      about 60 x 100 pixels, over the 384-pixel budget: device memory), 1
      in view 1 (staged), 3 in view 2 (windows at and over the budget);
      elsewhere 2 (every window staged);
    straddles_w0: w = gx - 2.5 in sample 1, so that bricks at gx 0..3 hold
      voxels on both sides of the camera plane;
    s6, s10: S not a multiple of the brick;
    c16, c32, c40: channels (c40: a second chunk of 8); c17: the element-
      by-element path (17 channels are no 16-byte rows);
    v3: three views."""
    b, v, s, c, hw = 2, 4, 8, 32, (40, 44)
    if scene in ("s6", "s10"):
        s = int(scene[1:])
    if scene.startswith("c"):
        c = int(scene[1:])
    if scene == "v3":
        v = 3
    if scene == "over_budget":
        hw = (200, 180)
    scale = torch.full((b, v), 2.0, device=dev)
    if scene == "over_budget":
        scale[:, 0], scale[:, 1], scale[:, 2] = 12.0, 1.0, 3.0
    m = torch.zeros(b, v, 3, 4, device=dev)
    m[..., 0, 0] = scale
    m[..., 0, 2] = 0.3 * scale
    m[..., 1, 1] = scale
    m[..., 1, 2] = 0.2 * scale
    m[..., 0, 3] = 2.0
    m[..., 1, 3] = 1.5
    m[..., 2, :] = torch.tensor([0.002, 0.001, 0.01, 1.0], device=dev)
    m += _randn(dev, b, v, 3, 4, scale=0.01, seed=7)
    if scene == "straddles_w0":
        m[1, :, 2] = torch.tensor([1.0, 0.0, 0.0, -2.5], device=dev)
    feats = _randn(dev, b, v, *hw, c, seed=8).to(dt)
    return feats, m, s


K1_SCENES = ["over_budget", "straddles_w0", "s6", "s10", "c16", "c32",
             "c40", "c17", "v3"]


@pytest.mark.parametrize("method", ["softmax", "sum", "max", "conf"])
@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("scene", K1_SCENES)
def test_unproject_agg_bricks_and_windows(dev, scene, dt, method):
    """K1 against its plain version where its bricks and windows have edges:
    views over the window budget, bricks across w = 0, ragged bricks, one
    or two channel chunks, the element path, three views; one view masked
    in sample 0."""
    from lt_tpu_torch.ops.kernels import unproject

    feats, m, s = _k1_scene(dev, scene, dt)
    b, v, c = feats.shape[0], feats.shape[1], feats.shape[-1]
    mask = torch.ones(b, v, device=dev)
    mask[0, 1] = 0.0
    conf = _randn(dev, b, v, c, seed=9).abs() if method == "conf" else None
    ref = unproject.unproject_agg_plain(feats, m, mask, conf, method, s)
    # The default plan, and windows staged (float32 stages none by default).
    for plan in (None, unproject.unproject_plan(c, s, feats.element_size(),
                                                window=384)):
        got = unproject.unproject_agg(feats, m, mask, conf, method, s, plan)
        assert got.dtype == dt
        _close(got, ref, REL if dt == torch.float32 else REL_BF16)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("scene", ["flagship", "over_budget", "s10", "c40"])
def test_unproject_agg_plans_agree_bit_for_bit(dev, scene, dt):
    """Every launch plan computes each voxel the same way: the default plan,
    windows of 384 pixels or none, and a 24-pixel budget (some views
    staged, some not) give the same bits."""
    from lt_tpu_torch.ops.kernels import unproject

    if scene == "flagship":
        feats, m = _flagship_k1_inputs(dev)
        feats, s = feats.to(dt), FLAG
    else:
        feats, m, s = _k1_scene(dev, scene, dt)
    mask = torch.ones(feats.shape[:2], device=dev)
    c, f = feats.shape[-1], feats.element_size()
    ref = unproject.unproject_agg(feats, m, mask, None, "softmax", s)
    for plan in (unproject.unproject_plan(c, s, f, window=0),
                 unproject.unproject_plan(c, s, f, window=384),
                 unproject.unproject_plan(c, s, f, window=24)):
        got = unproject.unproject_agg(feats, m, mask, None, "softmax", s,
                                      plan)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), plan


def _offset(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("shape, cout", [((8, 2, 2, 2, 128), 128),
                                         ((8, 4, 4, 4, 128), 128),
                                         ((8, 8, 8, 8, 128), 128),
                                         ((8, 16, 16, 16, 128), 64),
                                         ((8, FLAG // 2, FLAG // 2,
                                           FLAG // 2, 64), 32),
                                         ((3, 5, 3, 7, 24), 12),
                                         ((2, 3, 3, 3, 40), 17),
                                         ((1, 2, 3, 2, 8), 6)])
def test_upsample3d_2x_f32(dev, shape, cout, with_skip):
    """The float32 K3 (upsample3d_2x.cu): the five flagship levels at batch
    8, a ragged M tile (Cin 24, 315 voxels), Cout 17 (no 16-byte runs or
    weight rows) and 6 (16-byte weight rows, element epilogue)."""
    from lt_tpu_torch.ops.kernels import updown

    b, sx, sy, sz, cin = shape
    x = _randn(dev, *shape)
    w8 = _randn(dev, cin, 8 * cout, scale=cin ** -0.5, seed=1)
    b8 = _randn(dev, 8 * cout, scale=0.1, seed=2)
    skip = (_randn(dev, b, 2 * sx, 2 * sy, 2 * sz, cout, seed=3)
            if with_skip else None)
    _close(updown.upsample3d_2x(x, w8, b8, skip),
           updown.upsample3d_2x_plain(x, w8, b8, skip))


@pytest.mark.parametrize("which", ["skip", "x", "w8", "all"])
def test_upsample3d_2x_f32_misaligned(dev, which):
    """The float32 K3 with x, w8 and / or the skip 4 bytes off a 16-byte
    boundary: the 4-byte weight copies and the element epilogue."""
    from lt_tpu_torch.ops.kernels import updown

    x = _randn(dev, 2, 3, 4, 5, 64)
    w8 = _randn(dev, 64, 8 * 32, scale=0.125, seed=1)
    b8 = _randn(dev, 8 * 32, scale=0.1, seed=2)
    skip = _randn(dev, 2, 6, 8, 10, 32, seed=3)
    if which in ("x", "all"):
        x = _offset(x)
    if which in ("w8", "all"):
        w8 = _offset(w8)
    if which in ("skip", "all"):
        skip = _offset(skip)
    _close(updown.upsample3d_2x(x, w8, b8, skip),
           updown.upsample3d_2x_plain(x, w8, b8, skip))


# ---------------------------------------------------------------------------
# K5's and K6's bricks: the pre-reduction, the direct path
# ---------------------------------------------------------------------------


def _k56_scene(dev, scene):
    """(features (BV, H, W, C), m (BV, 3, 4), S) of one of K5's and K6's
    brick cases; features hold inf where the scene says so.

    edge: _sampling_scene (C = 40, S = 7: behind the camera, w == 0, off
      the map, exact taps on the last row and column);
    s10: S not a multiple of the brick; c17: a ragged chunk and the
      element path; c48: a second chunk of 16 channels; misaligned: C = 48
      with features 4 bytes off a 16-byte boundary;
    over_budget: _k1_scene's views whose windows exceed 384 pixels;
    inf: inf in the maps' first row and column, where no tap in the map
      lands (x = 5 gx - 12.5, y = 5 gy - 12.5 pixels; view 1 behind its
      camera): only taps off the map read them, at their clamped pixels
      with weight 0 (inf * 0 = NaN, as in the plain version)."""
    if scene == "over_budget":
        feats, m, s = _k1_scene(dev, scene, torch.float32)
        b, v = feats.shape[:2]
        return (feats.reshape(b * v, *feats.shape[2:]),
                m.reshape(b * v, 3, 4).contiguous(), s)
    if scene == "inf":
        s, hw = 8, 40
        px = (hw - 1) / hw
        m = torch.zeros(3, 3, 4, device=dev)
        m[:, 0, 0] = m[:, 1, 1] = 5.0 / px
        m[:, 0, 3] = m[:, 1, 3] = -12.5 / px
        m[2, 0, 3] = -13.5 / px
        m[:, 2, 3] = 1.0
        m[1, 2, 3] = -1.0
        feats = _randn(dev, 3, hw, hw, 32, seed=12)
        feats[:, 0] = float("inf")
        feats[:, :, 0] = float("inf")
        return feats, m, s
    c, s = {"edge": (40, 7), "s10": (40, 10), "c17": (17, 13),
            "c48": (48, 9), "misaligned": (48, 7)}[scene]
    feats, m, s = _sampling_scene(dev, c=c, s=s)
    return (_offset(feats) if scene == "misaligned" else feats), m, s


K56_SCENES = ["edge", "s10", "c17", "c48", "misaligned", "over_budget"]


@pytest.mark.parametrize("scene", K56_SCENES + ["inf"])
def test_sample_views_t_bricks_and_windows(dev, scene):
    """K5 against its plain version where its bricks have edges, with its
    one plan; a plan that does not fit is refused.  With inf in the maps'
    first row and column K5 has the plain version's NaN (the taps off the
    map read the edge with weight 0), as K1 does, and the view behind its
    camera stays 0."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k56_scene(dev, scene)
    out = sample.sample_views_t(feats, m, s)
    ref = sample.sample_views_t_plain(feats, m, s)
    _refuses_wrong_plans(sample.sample_views_t, "sample_views_t",
                         feats.shape[-1], s, feats, m, s)
    if scene == "inf":
        _nan_close(out, ref, REL)
        assert bool((out[1] == 0).all())
    else:
        _close(out, ref)


def _refuses_wrong_plans(fn, kernel, c, s, *args):
    """``fn(*args, plan=...)`` raises, before anything runs, for a window
    budget on a sampler and for sample_plan's plan with another grid or
    shared-memory size (the C entry's plan_error)."""
    from lt_tpu_torch.ops.kernels import _build, sample

    plan = sample.sample_plan(kernel, c, s)
    before = _build.LAUNCHES[kernel]
    with pytest.raises(ValueError, match="window"):
        fn(*args, plan=plan._replace(window=24))
    for wrong in (plan._replace(grid=plan.grid + 1),
                  plan._replace(smem=plan.smem + 16)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            fn(*args, plan=wrong)
    assert _build.LAUNCHES[kernel] == before


@pytest.mark.parametrize("scene", K56_SCENES)
def test_sample_views_grad_t_bricks_and_paths(dev, scene):
    """K6 against its plain version where its bricks have edges, with one
    view masked (a gradient of 0: no gradient reaches its maps): the
    default plan (every brick within 384 pixels pre-reduced), a 24-pixel
    budget (some pre-reduced, some direct) and no window (every brick
    direct); the direct path within 1e-4 of the pre-reduction."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k56_scene(dev, scene)
    shape = tuple(feats.shape)
    g = _randn(dev, shape[0], shape[-1], s ** 3, seed=4)
    g[1] = 0.0
    if scene == "misaligned":
        g = _offset(g)
    ref = sample.sample_views_grad_t_plain(g, m, shape, s)
    got = {w: sample.sample_views_grad_t(
        g, m, shape, s,
        sample.sample_plan("sample_views_grad_t", shape[-1], s, w))
           for w in (sample.K6_WINDOW, 24, 0)}
    for df in got.values():
        _close(df, ref)
        assert bool((df[1] == 0).all())
    _close(got[0], got[sample.K6_WINDOW])


# ---------------------------------------------------------------------------
# K7's and K8's bricks: the voxels-major sampling and its scatter
# ---------------------------------------------------------------------------


K78_SCENES = K56_SCENES + ["c17_s7", "c17_s10"]


def _k78_scene(dev, scene):
    """_k56_scene's cases and C = 17 at S = 7 and 10 (the element path on
    bricks past the grid's sides)."""
    if scene.startswith("c17_s"):
        return _sampling_scene(dev, c=17, s=int(scene[5:]))
    return _k56_scene(dev, scene)


@pytest.mark.parametrize("in_dtype, out_dtype", TYPE_PAIRS)
@pytest.mark.parametrize("scene", K78_SCENES + ["inf"])
def test_sample_views_bricks_and_types(dev, scene, in_dtype, out_dtype):
    """K7 against its plain version (1e-4 in float32, 1.6e-2 with bfloat16
    anywhere) where its bricks have edges, in all four type pairs, with its
    one plan (a plan that does not fit is refused); bit for bit K5's
    sample transposed (of the widened features, rounded once for a
    bfloat16 output).  misaligned: features one element off their 16-byte
    (float32) or 8-byte (bfloat16) boundary.  With inf in the maps' first
    row and column K7 has the plain version's NaN, as K5 does."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k78_scene(dev, scene)
    feats = feats.to(in_dtype)
    if scene == "misaligned":
        feats = _offset(feats)
    out = sample.sample_views(feats, m, s, out_dtype)
    exact = in_dtype == out_dtype == torch.float32
    ref = sample.sample_views_plain(feats, m, s, out_dtype)
    if scene == "inf":
        _nan_close(out, ref, REL if exact else REL_BF16)
        assert bool((out[1] == 0).all())
    else:
        _close(out, ref, REL if exact else REL_BF16)
    _refuses_wrong_plans(sample.sample_views, "sample_views",
                         feats.shape[-1], s, feats, m, s, out_dtype)
    _k7_bits(feats, m, s, out_dtype, out)


@pytest.mark.parametrize("g_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("scene", K78_SCENES)
def test_sample_views_grad_bricks_and_paths(dev, scene, g_dtype):
    """K8 against its plain version where its bricks have edges, with one
    view masked (exactly 0 reaches its maps), for float32 and bfloat16 g:
    the default plan, a 24-pixel budget (some bricks pre-reduced, some
    direct) and direct atomics only, each within 1e-5 of K6 on the
    transposed (widened) cotangent.  misaligned: g one element off its
    16-byte (float32) or 8-byte (bfloat16) boundary."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k78_scene(dev, scene)
    shape = tuple(feats.shape)
    g = _randn(dev, shape[0], s ** 3, shape[-1], seed=4).to(g_dtype)
    g[1] = 0.0
    if scene == "misaligned":
        g = _offset(g)
    ref = sample.sample_views_grad_plain(g, m, shape, s)
    k6 = sample.sample_views_grad_t(g.float().transpose(1, 2).contiguous(), m,
                                    shape, s)
    for w in (sample.K6_WINDOW, 24, 0):
        df = sample.sample_views_grad(
            g, m, shape, s,
            sample.sample_plan("sample_views_grad", shape[-1], s, w))
        _close(df, ref)
        _close(df, k6, rel=1e-5)
        assert bool((df[1] == 0).all())


# ---------------------------------------------------------------------------
# bfloat16 training: K5 and K6 in bfloat16, the step card vs CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("scene", K56_SCENES + ["inf"])
def test_sample_views_t_bf16_bricks(dev, scene, in_dtype):
    """K5 into a bfloat16 output, from float32 or bfloat16 features, where
    its bricks have edges: against its plain version (1.6e-2; NaN where it
    has NaN for the inf scene), bit for bit K7's bfloat16 sample
    transposed and K5's float32 sample (of the widened features) rounded
    once; a plan that does not fit is refused.  misaligned: features one
    element off their 16-byte (float32) or 8-byte (bfloat16) boundary."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k56_scene(dev, scene)
    feats = feats.to(in_dtype)
    if scene == "misaligned":
        feats = _offset(feats)
    out = sample.sample_views_t(feats, m, s, out_dtype=BF16)
    assert out.dtype == BF16
    ref = sample.sample_views_t_plain(feats, m, s, BF16)
    if scene == "inf":
        _nan_close(out, ref, REL_BF16)
        assert bool((out[1] == 0).all())
    else:
        _close(out, ref, REL_BF16)
    k7 = sample.sample_views(feats, m, s, BF16).transpose(1, 2)
    torch.testing.assert_close(out, k7, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        out, sample.sample_views_t(feats.float(), m, s).to(BF16), rtol=0,
        atol=0, equal_nan=True)
    _refuses_wrong_plans(
        lambda *a, plan: sample.sample_views_t(*a, plan=plan,
                                               out_dtype=BF16),
        "sample_views_t", feats.shape[-1], s, feats, m, s)


@pytest.mark.parametrize("scene", K56_SCENES)
def test_sample_views_grad_t_bf16_g_bricks(dev, scene):
    """K6 on a bfloat16 g where its bricks have edges, one view's g 0: the
    default plan, a 24-pixel budget and direct atomics only, each against
    the plain scatter and within 1e-5 of K6 on the widened g; dF float32.
    misaligned: g one element off an 8-byte boundary."""
    from lt_tpu_torch.ops.kernels import sample

    feats, m, s = _k56_scene(dev, scene)
    shape = tuple(feats.shape)
    g = _randn(dev, shape[0], shape[-1], s ** 3, seed=4).to(BF16)
    g[1] = 0.0
    if scene == "misaligned":
        g = _offset(g)
    ref = sample.sample_views_grad_t_plain(g, m, shape, s)
    wide = sample.sample_views_grad_t(g.float(), m, shape, s)
    for w in (sample.K6_WINDOW, 24, 0):
        df = sample.sample_views_grad_t(
            g, m, shape, s,
            sample.sample_plan("sample_views_grad_t", shape[-1], s, w))
        assert df.dtype == torch.float32
        _close(df, ref)
        _close(df, wide, rel=1e-5)
        assert bool((df[1] == 0).all())


@pytest.mark.parametrize("method", ["softmax", "sum"])
def test_sample_views_agg_gradient_bf16(dev, method):
    """The fused aggregation's backward from bfloat16 features on the card
    (K5 bfloat16 -> bfloat16, the VJP in float32, K6 on the rounded
    cotangent; one launch each, in bfloat16) against the same backward on
    the CPU (the plain versions), with a masked view: the gradient in
    bfloat16 within 1.6e-2 of the CPU's."""
    from lt_tpu_torch.ops.kernels import _build, unproject

    feats, m, s = _sampling_scene(dev)
    b, v = 2, 3
    feats = feats.reshape(b, v, *feats.shape[1:]).to(BF16)
    m = m.reshape(b, v, 3, 4)
    mask = torch.ones(b, v, device=dev)
    mask[0, 1] = 0.0
    cot = _randn(dev, b, s ** 3, feats.shape[-1], seed=5).to(BF16)
    grads = []
    for d in (dev, torch.device("cpu")):
        x = feats.to(d).clone().requires_grad_()
        _build.reset_launches()
        out = unproject.sample_views_agg(x, m.to(d), mask.to(d), method, s)
        assert out.dtype == BF16
        out.backward(cot.to(d))
        assert x.grad.dtype == BF16
        grads.append(x.grad)
        if d == dev:
            assert {k: n for k, n in _build.LAUNCHES.items() if n} == {
                "unproject_agg": 1, "sample_views_t": 1,
                "sample_views_grad_t": 1}
    _close(grads[0].cpu(), grads[1], REL_BF16)


@pytest.mark.parametrize("shape", [(5, 8, 6, 6), (5, 8, 2, 2, 2)])
def test_batchnorm_bf16_training_update_matches_cpu(dev, shape):
    """A training BatchNorm call on a bfloat16 input (float32 weights and
    statistics, as under autocast) on the card vs on the CPU: the output
    bfloat16 within 1.6e-2, the float32 running mean and flax's biased
    running variance within 1e-5 relative."""
    from lt_tpu_torch.models.batchnorm import BatchNorm

    x = (_randn(torch.device("cpu"), *shape, scale=2.0) + 3.0).to(BF16)
    outs = []
    for d in ("cpu", dev):
        bn = BatchNorm(shape[1]).to(d).train()
        with torch.no_grad():
            bn.running_var.fill_(0.7)
            bn.weight.fill_(1.3)
        y = bn(x.to(d))
        assert y.dtype == BF16 and bn.running_var.dtype == torch.float32
        outs.append((y, bn.running_mean, bn.running_var))
    for (got, ref), rel in zip(zip(outs[1], outs[0]), (REL_BF16, 1e-5, 1e-5)):
        _close(got.cpu(), ref, rel=rel)


def _bf16_step(config, variables, batch, d, use_kernels="fused"):
    """One ``train_step`` of the volumetric fixture on ``d``: (loss,
    {group: flattened float64 gradients})."""
    from lt_tpu_torch.engine import factory, steps
    from lt_tpu_torch.utils.weights import volumetric_state_dict

    model = factory.make_model(config, device=d, use_kernels=use_kernels)
    model.load_state_dict(volumetric_state_dict(variables, 18))
    opt = factory.make_optimizer(config, model)
    m = steps.train_step(model, opt, factory.make_criterion(config), config,
                         {k: torch.from_numpy(a).to(d)
                          for k, a in batch.items()})
    grads = {}
    for group in factory.GROUPS:
        grads[group] = torch.cat([
            p.grad.detach().double().cpu().flatten()
            for k, p in model.named_parameters()
            if k.startswith(group + ".") and p.grad is not None])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return m["total_loss"], grads


# The bfloat16 step of the trained volumetric fixture on the card, kernel
# path and plain path, against the CPU's float32 step: relative loss
# difference, relative L2 of each group's gradient, each averaged over
# BF16_STEP_ROTATIONS pairs of cuboid rotations (seed 0).  One step's
# distance is one draw of a wide distribution (on an H100 each path's
# process_features gradient lay 0.07-0.40 from float32 across 16
# rotations), so the kernel path's means are held to BF16_STEP_RATIO times
# the plain path's, chip_smoke.py's [train fixture bf16] rule.
BF16_STEP_ROTATIONS = 8
BF16_STEP_RATIO = 1.5


def test_bf16_train_step_card_vs_cpu(dev):
    """The bf16: true step of the trained volumetric fixture
    (vol_tiny_2stage.yaml, RN-18, 128^2, 4 views, 32^3, batch 2) on the
    card, on the kernel path (K1, K5, K6 in bfloat16, each launched once a
    step) and on the plain path (use_kernels=False), from the CPU's
    float32 step (the plain versions), at BF16_STEP_ROTATIONS rotations:
    the kernel path's mean distances within BF16_STEP_RATIO times the
    plain path's, every loss finite."""
    import numpy as np

    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
    from lt_tpu_torch.ops.kernels import _build
    from lt_tpu_torch.utils import cfg
    from lt_tpu_torch.utils.weights import load_npz_variables

    ds = SyntheticMultiViewDataset(n_samples=2, n_views=4, image_size=128)
    val = [ds[i] for i in range(2)]
    kp = np.stack([x["keypoints_3d"] for x in val]).astype(np.float32)
    batch = {"images": np.stack([np.stack(x["images"]) for x in val])
             .astype(np.float32),
             "proj_matrices": np.stack([np.stack(x["proj_matrices"])
                                        for x in val]).astype(np.float32),
             "keypoints_3d": kp, "keypoints_validity": kp[..., 3:].copy(),
             "view_mask": np.ones((2, 4), np.float32)}
    variables = load_npz_variables("tests/fixtures/vol_rn18_synth.npz")
    over = {"model.init_weights": False, "model.backbone.init_weights": False}
    yaml = "experiments/synthetic/vol_tiny_2stage.yaml"
    config32 = cfg.load_config(yaml, over)
    config = cfg.load_config(yaml, {**over, "bf16": True})
    rotations = np.random.RandomState(0).uniform(
        0.0, 2.0 * np.pi, (BF16_STEP_ROTATIONS, 2)).astype(np.float32)
    dist = {"kernel": [], "plain": []}
    for rot in rotations:
        batch["rotation_thetas"] = rot
        ref_loss, ref = _bf16_step(config32, variables, batch,
                                   torch.device("cpu"))
        _build.reset_launches()
        paths = {"kernel": _bf16_step(config, variables, batch, dev)}
        for k in ("unproject_agg", "sample_views_t", "sample_views_grad_t"):
            assert _build.LAUNCHES[k] == 1, (k, _build.LAUNCHES[k])
        paths["plain"] = _bf16_step(config, variables, batch, dev, False)
        for name, (loss, grads) in paths.items():
            assert np.isfinite(loss), name
            dist[name].append([abs(loss - ref_loss) / ref_loss] + [
                float((grads[g] - ref[g]).norm() / ref[g].norm())
                for g in ref])
    kernel, plain = (np.mean(dist[k], axis=0) for k in ("kernel", "plain"))
    assert (kernel <= BF16_STEP_RATIO * plain).all(), (kernel, plain)
