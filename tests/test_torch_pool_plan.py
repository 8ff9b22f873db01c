"""K4's launch plan (``updown.pool_plan``) and its indexing, on the CPU.

``csrc/max_pool3d_2x.cu`` runs only on the card.  Here its plan is held at
the flagship's five pool launches in both types, the scalar instance is
chosen where C does not fill 16 bytes or the base is not 16-byte aligned,
and the host refuses what the kernel's 32-bit offsets and grid cannot take.
Then the kernel's own index arithmetic, thread by thread, is replayed in
PyTorch from the plan (``_model``) and held bit for bit to the plain
version, NaN and infinities included: every output element written once,
every vector load on a multiple of its width.
"""

import math

import pytest
import torch

from lt_tpu_torch.ops.kernels import updown

BF16 = torch.bfloat16
F32 = torch.float32

# The flagship forward's five pools at batch 8 (input side, channels), and
# the plan each takes: (vec, block x, block y, grid x, grid y, grid z).
FLAGSHIP = [
    ((64, 32), F32, (4, 8, 32, 1, 32, 256)),
    ((32, 64), F32, (4, 16, 16, 1, 16, 128)),
    ((16, 128), F32, (4, 32, 8, 1, 8, 64)),
    ((8, 128), F32, (4, 32, 4, 1, 4, 32)),
    ((4, 128), F32, (4, 32, 2, 1, 2, 16)),
    ((64, 32), BF16, (8, 4, 32, 1, 32, 256)),
    ((32, 64), BF16, (8, 8, 16, 1, 16, 128)),
    ((16, 128), BF16, (8, 16, 8, 1, 8, 64)),
    ((8, 128), BF16, (8, 16, 4, 1, 4, 32)),
    ((4, 128), BF16, (8, 16, 2, 1, 2, 16)),
]


@pytest.mark.parametrize("shape, dt, want", FLAGSHIP)
def test_pool_plan_at_the_flagship_launches(shape, dt, want):
    side, c = shape
    plan = updown.pool_plan(8, side, side, side, c, dt, True)
    assert plan.args == want
    assert plan.vec * dt.itemsize == 16
    assert plan.bx * plan.by <= updown.POOL_THREADS
    assert plan.gx * plan.by >= side // 2       # every output z covered


@pytest.mark.parametrize("c, dt, aligned, vec", [
    (17, F32, True, 1), (17, BF16, True, 1), (4, BF16, True, 1),
    (4, F32, True, 4), (32, F32, False, 1), (32, BF16, False, 1),
    (24, BF16, True, 8), (12, F32, True, 4)])
def test_pool_plan_takes_the_scalar_instance(c, dt, aligned, vec):
    plan = updown.pool_plan(2, 4, 6, 8, c, dt, aligned)
    assert plan.vec == vec
    assert plan.bx == c // vec


def test_pool_plan_raises_beyond_the_kernel_limits():
    with pytest.raises(ValueError, match="2\\^31"):
        updown.pool_plan(8, 128, 128, 128, 128, BF16, True)   # 2^31 exactly
    updown.pool_plan(8, 128, 128, 128, 127, BF16, True)
    with pytest.raises(ValueError, match="grid"):
        updown.pool_plan(1, 2, 2 * 65536, 2, 1, F32, True)


def _model(x, plan):
    """max_pool3d_2x_kernel's arithmetic, every thread of ``plan`` at once:
    each thread's eight loads of ``vec`` elements from the flat input, the
    NaN-keeping maximum, its store.  Returns the output and the number of
    times each output element was written."""
    b, _, sy, sz, c = x.shape
    vec, bx, by, gx, gy, gz = plan
    flat = x.reshape(-1)
    n_out = x.numel() // 8
    out = torch.zeros(n_out, dtype=x.dtype)
    writes = torch.zeros(n_out, dtype=torch.int64)
    zo, row = sz // 2, sz * c
    grid = torch.meshgrid(*(torch.arange(n) for n in (gx, gy, gz, by, bx)),
                          indexing="ij")
    bxi, oy, q, ty, tx = (t.reshape(-1) for t in grid)
    oz = bxi * by + ty
    live = oz < zo
    oy, q, oz, tx = oy[live], q[live], oz[live], tx[live]
    in0 = ((2 * q) * sy + 2 * oy) * row + 2 * oz * c
    out0 = (q * (sy // 2) + oy) * (zo * c) + oz * c
    lanes = torch.arange(vec)
    for step in range(math.ceil(c // vec / bx)):
        cv = tx + step * bx
        on = cv < c // vec
        taps = []
        for k in range(8):
            off = (in0 + ((k >> 2) * sy + (k >> 1 & 1)) * row + (k & 1) * c
                   + cv * vec)[on]
            assert bool((off % vec == 0).all())     # a whole 16-byte load
            taps.append(flat[off[:, None] + lanes])
        m = taps[0]
        for t in taps[1:]:
            m = torch.maximum(m, t)                 # NaN where either is
        dst = ((out0 + cv * vec)[on][:, None] + lanes).reshape(-1)
        out[dst] = m.reshape(-1)
        writes.index_add_(0, dst, torch.ones_like(dst))
    return out.reshape(b, x.shape[1] // 2, sy // 2, zo, c), writes


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape, aligned", [
    ((2, 4, 6, 8, 32), True), ((2, 4, 6, 8, 32), False),
    ((1, 2, 4, 6, 17), True), ((1, 6, 2, 4, 64), True),
    ((1, 2, 2, 2, 2048), True), ((2, 8, 8, 8, 128), True)])
def test_kernel_indexing_matches_plain(shape, aligned, dt):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(dt)
    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (3, 3), generator=g)
    flat[idx[0]], flat[idx[1]], flat[idx[2]] = math.nan, math.inf, -math.inf
    x[0, :2, :2, :2, 0] = math.nan                  # a window all NaN
    plan = updown.pool_plan(*shape, dt, aligned)
    got, writes = _model(x, plan)
    assert bool((writes == 1).all())
    ref = updown.max_pool3d_2x_plain(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert bool(ref.isnan().any())
