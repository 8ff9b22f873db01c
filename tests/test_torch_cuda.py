"""The CUDA kernels against their plain versions on the card, at small and
awkward shapes (odd sizes, Cout = 17, Cin = 16, k = 1 / 3 / 7, ragged
tiles), plus K1's, K5's and K6's edge cases, the fused aggregation's
gradient, the wrappers' device / launch rules, and V2V's folded weights
after an optimizer step.

Marked ``cuda``: without a GPU every test skips.  On a machine with one
(this file imports torch only, so ``--noconftest`` keeps JAX out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| (float32, other
summation orders); TF32 is off for the plain versions.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rel=REL):
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert bool(got.isfinite().all())
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


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 32), (1, 2, 2, 2, 17)])
def test_max_pool3d_2x(dev, shape):
    from lt_tpu_torch.ops.kernels import updown

    x = _randn(dev, *shape)
    assert torch.equal(updown.max_pool3d_2x(x), updown.max_pool3d_2x_plain(x))


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
