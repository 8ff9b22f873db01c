"""The launches of V2V's fused forward on slabs (volume-axis sharding), at
the flagship's 64^3 and batch 8, for every rank of 2 and of 4, modelled on
the CPU without computing anything: ``V2VModel._forward_fused_slabs`` runs
its level rule with a ``SlabGroup`` whose exchanges only shape their
outputs (no process group) and with K2, K3 and K4 replaced by recorders
that check their shape rules and return empty tensors on the ``meta``
device.

- Each launch's plan fits the card in both types (``conv3d_mma_plan``
  for the bfloat16 body and the float32 body's parts, ``pool_plan``,
  ``upsample_mma_plan``, ``upsample_f32_plan``), on the extended slabs,
  whose X extent is odd at a global face where the reach is odd.
- The level rule's slabs: with 2 ranks 32, 16, 8, 4 on the way down,
  the encoder pair at 4^3 and every deeper call whole; with 4 ranks 16, 8,
  4, the pair at 8^3 whole; the launches per forward are the unsharded
  forward's (47 K2, 5 K3, 5 K4).

The training graph (``V2VModel._forward_modules_slabs``, the module graph
on slabs) is modelled the same way on ``meta`` tensors at 64^3 and the
training batch of 5, forward and backward: the collectives run with a
group whose all_gather and all_reduce only shape their outputs, and each
step's exchanges, gathers and reductions are counted for every rank of 2
and of 4, with the slabs each block runs on.
"""

import pytest
import torch

from lt_tpu_torch.models.v2v import V2VModel
from lt_tpu_torch.ops.kernels import conv_mp, res3d
from lt_tpu_torch.ops.kernels.conv3d import conv3d_mma_plan, split_parts
from lt_tpu_torch.ops.kernels.updown import (pool_plan, upsample_f32_plan,
                                             upsample_mma_plan)
from lt_tpu_torch.models.batchnorm import BatchNorm
from lt_tpu_torch.parallel import spatial
from lt_tpu_torch.parallel.spatial import SlabGroup

S, B, C_IN, J = 64, 8, 32, 17
TRAIN_B = 5
META = torch.device("meta")


class _ShapeGroup(SlabGroup):
    """Rank ``rank`` of ``ranks`` with no process group: every rank's
    tensor of an all_gather is an empty one of this rank's shape, and an
    all_reduce leaves its tensor as it is, so that the exchanges, gathers
    and reductions (and their backwards) shape their outputs only."""

    def __init__(self, rank, ranks):
        self.group, self.rank, self.ranks, self.volume_size = (
            None, rank, ranks, S)
        self.reset_stats()

    def _gather(self, t):
        return [torch.empty_like(t) for _ in range(self.ranks)]

    def _reduce(self, t, op=None):
        pass


@pytest.fixture(scope="module")
def model():
    return V2VModel(C_IN, J, device="cpu")


def _launches(model, rank, ranks, monkeypatch):
    """Every K2 / K3 / K4 launch of one sharded forward of rank ``rank``:
    (kernel, (B, X, Y, Z, Cin), Cout or None, k or None)."""
    seen = []

    def conv(x, w, b, residual=None, relu=False, out_dtype=None):
        k, cin, cout = w.shape[-5], w.shape[-2], w.shape[-1]
        assert x.shape[-1] == cin and k % 2 == 1
        if residual is not None:
            assert tuple(residual.shape) == tuple(x.shape[:-1]) + (cout,)
        seen.append(("K2", tuple(x.shape), cout, k))
        return torch.empty(tuple(x.shape[:-1]) + (cout,), device=META)

    def pool(x):
        assert all(n % 2 == 0 for n in x.shape[1:4]), x.shape
        seen.append(("K4", tuple(x.shape), None, None))
        return torch.empty((x.shape[0],) + tuple(n // 2 for n in
                                                 x.shape[1:4])
                           + (x.shape[4],), device=META)

    def up(x, w8, b8, skip=None):
        out = ((x.shape[0],) + tuple(2 * n for n in x.shape[1:4])
               + (w8.shape[1] // 8,))
        assert skip is None or tuple(skip.shape) == out, (skip.shape, out)
        seen.append(("K3", tuple(x.shape), out[-1], None))
        return torch.empty(out, device=META)

    for mod in (res3d, conv_mp):
        monkeypatch.setattr(mod, "conv3d_fused", conv)
    monkeypatch.setattr(res3d, "max_pool3d_2x", pool)
    monkeypatch.setattr(res3d, "upsample3d_2x", up)
    g = _ShapeGroup(rank, ranks)
    x = torch.empty((B, S // ranks, S, S, C_IN), device=META)
    with torch.no_grad():
        out = model._forward_fused_slabs(x, g)
    assert tuple(out.shape) == (B, S // ranks, S, S, J)
    monkeypatch.undo()
    return seen, g.stats


@pytest.mark.parametrize("ranks", [2, 4])
def test_slab_launches_fit_their_plans(model, ranks, monkeypatch):
    for rank in range(ranks):
        seen, _ = _launches(model, rank, ranks, monkeypatch)
        counts = {k: sum(1 for s in seen if s[0] == k)
                  for k in ("K2", "K3", "K4")}
        assert counts == {"K2": 47, "K3": 5, "K4": 5}
        for kernel, (b, sx, sy, sz, cin), cout, k in seen:
            if kernel == "K2":
                conv3d_mma_plan(b, sx, sy, sz, cin, cout, k)
                conv3d_mma_plan(b, sx, sy, sz, cin, cout, k, split_parts(k))
            elif kernel == "K4":
                for dt in (torch.float32, torch.bfloat16):
                    pool_plan(b, sx, sy, sz, cin, dt, True)
            else:
                upsample_mma_plan(b, sx, sy, sz, cin, cout)
                upsample_f32_plan(b, sx, sy, sz, cin, cout)


# (extent, reach, halves) of each call's test of the level rule, in order,
# and whether it ran on slabs: the front conv, the front chain, the four
# encoder pairs (until one is too thin; then the rest of the way down runs
# whole without a test), then the five upsample-headed calls, outermost
# last.
LEVEL_RULE = {
    2: [(64, 3, False, True), (64, 8, True, True), (32, 4, True, True),
        (16, 4, True, True), (8, 4, True, True), (4, 4, True, False),
        (4, 2, True, True), (8, 2, True, True), (16, 2, True, True),
        (32, 2, True, True), (64, 2, True, True)],
    4: [(64, 3, False, True), (64, 8, True, True), (32, 4, True, True),
        (16, 4, True, True), (8, 4, True, False), (4, 2, True, False),
        (8, 2, True, True), (16, 2, True, True), (32, 2, True, True),
        (64, 2, True, True)]}


@pytest.mark.parametrize("ranks", [2, 4])
def test_slab_levels_are_the_rule(model, ranks, monkeypatch):
    """With 2 ranks the slabs are 32, 16, 8, 4 on the way down and the
    encoder pair at 4^3 (reach 4 over a slab of 2) runs whole, with every
    deeper call; with 4 ranks 16, 8, 4 and the pair at 8^3 whole.  On the
    way up every call out to a level whose slab holds its reach of 2 runs
    on slabs.  Rank 0 has one neighbour: its front conv's extended slab is
    the slab plus 3 planes (35 or 19, odd)."""
    tests = []
    fits = SlabGroup.fits

    def logged(self, extent, reach, halves=False):
        ok = fits(self, extent, reach, halves)
        tests.append((extent, reach, halves, ok))
        return ok

    monkeypatch.setattr(SlabGroup, "fits", logged)
    seen, stats = _launches(model, 0, ranks, monkeypatch)
    assert tests == LEVEL_RULE[ranks]
    assert stats["gathers"] == 1
    assert seen[0][0] == "K2" and seen[0][3] == 7
    assert seen[0][1][1] == S // ranks + 3


# ---------------------------------------------------------------------------
# The training graph on slabs (the module graph), forward and backward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meta_model():
    return V2VModel(C_IN, J, device="cpu").to(META).train()


def _training_step(model, rank, ranks):
    """One forward and backward of V2V's training graph on rank ``rank``'s
    slab of the training batch: the output's shape, the collectives'
    counts, and for each BatchNorm the X extent of its input and whether it
    took the group's statistics."""
    g = _ShapeGroup(rank, ranks)
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: seen.__setitem__(
            name, (a[0].shape[2], spatial.on_slabs() is not None)))
        for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    try:
        x = torch.empty((TRAIN_B, S // ranks, S, S, C_IN), device=META,
                        requires_grad=True)
        out = model._forward_modules_slabs(x, g)
        out.sum().backward()
    finally:
        for h in hooks:
            h.remove()
    assert tuple(x.grad.shape) == tuple(x.shape)
    return tuple(out.shape), dict(g.stats), seen


# Per step at 64^3, every rank alike: exchanges (one per k > 1 convolution
# of a split level: 41 in V2V; the backward as many), gathers (the volume
# once, before the first level that cannot be split; its backward one
# reduce-scatter), and the split BatchNorm layers' two sums each (mean,
# variance; 51 layers in V2V; the backward as many).  2 ranks: slabs of
# 32, 16, 8, 4, 2 and 1 planes, every level split (the 2^3 level's k = 3
# convolutions reach 1 <= 1 plane), nothing gathered; 4 ranks: slabs of
# 16, 8, 4, 2, 1, the pool from 4^3 (slabs of 1, odd) gathers, and the
# 2^3 level (encoder_res5, mid_res, decoder_res5: 6 convolutions and BN
# layers) and the upsample out of it (1 BN) run whole.
TRAIN_COLLECTIVES = {
    2: dict(exchanges=41, back_exchanges=41, gathers=0, back_gathers=0,
            reductions=102, back_reductions=102),
    4: dict(exchanges=35, back_exchanges=35, gathers=1, back_gathers=1,
            reductions=88, back_reductions=88)}
WHOLE_BN = {2: (), 4: ("encoder_decoder.encoder_res5.",
                       "encoder_decoder.mid_res.",
                       "encoder_decoder.decoder_res5.",
                       "encoder_decoder.decoder_upsample5.")}


@pytest.mark.parametrize("ranks", [2, 4])
def test_training_graph_collectives_per_step(meta_model, ranks):
    for rank in range(ranks):
        shape, stats, _ = _training_step(meta_model, rank, ranks)
        assert shape == (TRAIN_B, S // ranks, S, S, J)
        got = {k: stats[k] for k in TRAIN_COLLECTIVES[ranks]}
        assert got == TRAIN_COLLECTIVES[ranks], (rank, got)


@pytest.mark.parametrize("ranks", [2, 4])
def test_training_graph_levels(meta_model, ranks):
    """Every BatchNorm of a split level normalizes this rank's own planes
    (its input's X extent a level's over the ranks, never a halo-extended
    one) with the group's statistics; every one of a level run whole, the
    whole level with its own statistics."""
    levels = {S >> i for i in range(6)}
    for rank in range(ranks):
        _, _, seen = _training_step(meta_model, rank, ranks)
        assert len(seen) == 51 == sum(isinstance(m, BatchNorm)
                                      for m in meta_model.modules())
        for name, (extent, split) in seen.items():
            whole = name.startswith(WHOLE_BN[ranks])
            assert split != whole, name
            assert (extent if whole else extent * ranks) in levels, name
