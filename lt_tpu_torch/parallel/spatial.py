"""Volume-axis (spatial) sharding: one sample's volume split on its X axis
over the ranks of a process group.  The port's counterpart of
``lt_tpu/parallel/spatial.py`` (``volume_sharding``, ``constrain_volume``),
for the volumetric model's eval forward and training step on the fused
kernel path.

``lt_tpu`` annotates the (B, X, Y, Z, C) volume with a sharding and lets
GSPMD insert the halo exchanges each convolution needs at a slab's edges,
the all-reduces of the soft-argmax, the re-replication of the deep
hourglass levels that are too thin to split, and the backward of each.
The port has no GSPMD, so :class:`SlabGroup` does by hand what the
partitioner does there:

- rank r of n owns X planes [r X / n, (r + 1) X / n) of every level of
  extent X (:meth:`SlabGroup.slab`); n = gcd(volume size, world size) must
  be the whole group, since a rank cannot idle through a collective as
  ``lt_tpu``'s spare devices do;
- a call runs on the rank's slab extended by ``reach`` X planes from each
  interior neighbour (:meth:`SlabGroup.extend_x`, one ``all_gather`` of
  every rank's first and last planes), and nothing at the volume's two
  global faces, where the call's own zero padding is the whole volume's;
  :meth:`SlabGroup.crop_x` cuts the call's output back to the slab;
- :meth:`SlabGroup.gather_x` and :meth:`SlabGroup.take_slab` move between
  a slab and the whole volume of a level (``all_gather``; slicing);
- :meth:`SlabGroup.all_reduce` sums (or takes the maximum of) a tensor
  over the group.

The same collectives run over NCCL and over gloo (two ranks on one card)
on CUDA tensors, and over gloo on the CPU.

**Training: one convention for the gradient.**  Every collective is
differentiable and its backward is its exact adjoint, a collective too:
the exchange's backward adds each halo plane's cotangent into the
neighbour that owns the plane (nothing is sent at the global faces);
``gather_x``'s is a reduce-scatter (an ``all_reduce`` of the whole level's
cotangent, then the rank's planes); the sum's is a sum of the cotangents
over the group; ``crop_x`` and ``take_slab`` are slices, whose backward
pads with zeros.  The maximum is taken without a gradient (the
soft-argmax's shift, whose gradient is 0).  Each rank backpropagates its
copy of the replicated loss, unscaled: the group's backward is then the
gradient of n times the loss with respect to every rank's tensors, and
the parameter gradients, which the ranks hold as replicas, are
**averaged** over the group (:meth:`SlabGroup.average_grads`, in
``engine.steps.train_step``), which gives every rank the one-process
gradient and the same Adam step.  Replicated work (the backbone, the deep
levels V2V runs whole, the loss after the soft-argmax) is counted once by
this rule with no special case.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The SlabGroup whose slabs the module graph runs on (X = dim 2, NCDHW), set
# by models.v2v for a block of a level split over the group; the block's
# convolutions exchange halos and its BatchNorm takes the group's
# statistics (models/batchnorm.py).  None: the block holds whole planes.
_ON_SLABS = contextvars.ContextVar("lt_tpu_torch_on_slabs", default=None)


def on_slabs() -> Optional["SlabGroup"]:
    """The :class:`SlabGroup` whose slabs the current block runs on, or
    None (:func:`slabs_of`)."""
    return _ON_SLABS.get()


@contextlib.contextmanager
def slabs_of(group: Optional["SlabGroup"]):
    """Run the block inside on ``group``'s slabs (None: on whole planes)."""
    token = _ON_SLABS.set(group)
    try:
        yield
    finally:
        _ON_SLABS.reset(token)


class SlabGroup:
    """The ranks of ``group`` splitting one sample's volume of
    ``volume_size`` planes on X, and the exchanges between them.

    ``stats`` counts this rank's collectives since the last
    :meth:`reset_stats`: halo exchanges and the bytes of the neighbours'
    planes received (``halo_bytes``), gathers of a whole level and their
    bytes, the soft-argmax's reductions, and the backwards' exchanges,
    gathers and reductions (``back_*``)."""

    def __init__(self, group, volume_size: int):
        self.group = group
        self.ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.volume_size = volume_size
        n = math.gcd(volume_size, self.ranks)
        if n < self.ranks:
            raise ValueError(
                f"volume-axis sharding splits the volume over gcd(volume "
                f"size, world size) = gcd({volume_size}, {self.ranks}) = {n}"
                f" ranks, fewer than the {self.ranks} of the group: a rank "
                f"cannot idle through a collective (lt_tpu idles its spare "
                f"devices: ROADMAP A8 (e)); pick a world size that divides "
                f"model.volume_size")
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = dict(exchanges=0, halo_bytes=0, gathers=0,
                          gather_bytes=0, reductions=0, back_exchanges=0,
                          back_gathers=0, back_reductions=0)

    def slab(self, extent: int) -> Tuple[int, int]:
        """(x0, sx): this rank's X planes [x0, x0 + sx) of a level of
        ``extent`` planes."""
        if extent % self.ranks:
            raise ValueError(f"{extent} X planes do not split over "
                             f"{self.ranks} ranks")
        sx = extent // self.ranks
        return self.rank * sx, sx

    def fits(self, extent: int, reach: int, halves: bool = False) -> bool:
        """Whether a call of ``reach`` X planes runs on slabs at a level of
        ``extent`` planes: the halo comes from the immediate neighbours
        only (``reach`` at most the slab's width), and where the call
        ``halves`` the level (a pool, or an upsample read from its output's
        side) every 2-plane pair lies inside one slab (an even width)."""
        if extent % self.ranks:
            return False
        sx = extent // self.ranks
        return reach <= sx and not (halves and sx % 2)

    def exchange(self, pairs: Sequence[Tuple[torch.Tensor, int]],
                 dim: int = 1) -> List[torch.Tensor]:
        """Each (slab, reach) of ``pairs`` extended by ``reach`` X planes
        (``dim``) from each interior neighbour, in one ``all_gather`` of
        every rank's first and last ``reach`` planes of each slab.
        Differentiable: the backward sends each halo plane's cotangent to
        the neighbour that owns the plane, in one ``all_gather``."""
        if not any(reach for _, reach in pairs):
            return [t for t, _ in pairs]
        for t, reach in pairs:
            if not 0 <= reach <= t.shape[dim]:
                raise ValueError(f"reach {reach} beyond a slab of "
                                 f"{t.shape[dim]} planes")
            if t.dtype != pairs[0][0].dtype:
                raise TypeError("one exchange takes slabs of one type")
        reaches = tuple(r for _, r in pairs)
        return list(_Exchange.apply(self, reaches, dim,
                                    *(t for t, _ in pairs)))

    def _swap(self, halves: Sequence[Tuple[torch.Tensor, torch.Tensor]]
              ) -> List[Tuple[Optional[torch.Tensor],
                              Optional[torch.Tensor]]]:
        """One ``all_gather`` of each (first, last) pair of every rank: per
        pair, the (left neighbour's last, right neighbour's first) planes,
        None at a global face."""
        every = self._gather(torch.cat([torch.cat([a.reshape(-1),
                                                   b.reshape(-1)])
                                        for a, b in halves]))
        out, offset = [], 0
        for a, b in halves:
            na, nb = a.numel(), b.numel()
            left = right = None
            if self.rank > 0:
                left = every[self.rank - 1][offset + na:offset + na + nb] \
                    .reshape(b.shape)
            if self.rank < self.ranks - 1:
                right = every[self.rank + 1][offset:offset + na] \
                    .reshape(a.shape)
            out.append((left, right))
            offset += na + nb
        return out

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order (``all_gather``)."""
        every = [torch.empty_like(t) for _ in range(self.ranks)]
        dist.all_gather(every, t, group=self.group)
        return every

    def _reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        """``t`` reduced over the group in place (``all_reduce``)."""
        dist.all_reduce(t, op=op, group=self.group)

    def extend_x(self, slab: torch.Tensor, reach: int,
                 dim: int = 1) -> torch.Tensor:
        """``slab`` (B, sx, ...) extended by ``reach`` X planes from each
        interior neighbour (:meth:`exchange` of one slab)."""
        return self.exchange([(slab, reach)], dim)[0]

    def crop_x(self, extended: torch.Tensor, reach: int,
               dim: int = 1) -> torch.Tensor:
        """The slab's planes of a call's output on an extended slab: the
        ``reach`` planes at each interior side removed (contiguous)."""
        lo = reach if self.rank > 0 else 0
        hi = extended.shape[dim] - (reach if self.rank < self.ranks - 1
                                    else 0)
        return extended.narrow(dim, lo, hi - lo).contiguous()

    def gather_x(self, slab: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole volume of a level: every rank's slab, concatenated on
        ``dim`` in rank order, in every rank.  Differentiable: the backward
        is a reduce-scatter of the whole level's cotangent."""
        return _GatherX.apply(self, dim, slab)

    def take_slab(self, whole: torch.Tensor, reach: int = 0,
                  dim: int = 1) -> torch.Tensor:
        """This rank's X planes (``dim``) of a whole (replicated) level,
        extended by ``reach`` planes on each interior side, as
        :meth:`extend_x` extends the slab (contiguous)."""
        extent = whole.shape[dim]
        x0, sx = self.slab(extent)
        lo, hi = max(x0 - reach, 0), min(x0 + sx + reach, extent)
        return whole.narrow(dim, lo, hi - lo).contiguous()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced over the group, a new tensor (the soft-argmax's
        maximum and sums).  A sum is differentiable (its backward sums the
        cotangents); the maximum is taken without a gradient."""
        if op == dist.ReduceOp.SUM:
            return _SumOverGroup.apply(self, t)
        self.stats["reductions"] += 1
        out = t.detach().clone()
        self._reduce(out, op)
        return out

    def average_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Each parameter's gradient replaced by its mean over the group,
        in one ``all_reduce`` (a missing gradient counts as 0): the
        convention of this module, under which every rank then holds the
        one-process gradient."""
        params = list(params)
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        self._reduce(flat)
        flat /= self.ranks
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).clone()
            offset += n


class _Exchange(torch.autograd.Function):
    """:meth:`SlabGroup.exchange` and its adjoint."""

    @staticmethod
    def forward(ctx, g, reaches, dim, *slabs):
        ctx.g, ctx.reaches, ctx.dim = g, reaches, dim
        ctx.widths = [t.shape[dim] for t in slabs]
        got = g._swap([(t.narrow(dim, 0, r), t.narrow(dim, t.shape[dim] - r,
                                                     r))
                       for t, r in zip(slabs, reaches)])
        g.stats["exchanges"] += 1
        out = []
        for t, (left, right) in zip(slabs, got):
            parts = [p for p in (left, t, right) if p is not None]
            g.stats["halo_bytes"] += sum(
                p.numel() * p.element_size() for p in parts if p is not t)
            out.append(torch.cat(parts, dim))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        g, dim = ctx.g, ctx.dim
        inner = g.rank > 0, g.rank < g.ranks - 1
        halves, owned = [], []
        for ge, r, sx in zip(grads, ctx.reaches, ctx.widths):
            lo = r if inner[0] else 0
            own = ge.narrow(dim, lo, sx)
            zero = torch.zeros_like(own.narrow(dim, 0, r))
            halves.append((ge.narrow(dim, 0, r) if inner[0] else zero,
                           ge.narrow(dim, lo + sx, r) if inner[1] else zero))
            owned.append(own)
        got = g._swap(halves)
        g.stats["back_exchanges"] += 1
        out = []
        for own, r, (left, right) in zip(owned, ctx.reaches, got):
            own = own.clone()
            sx = own.shape[dim]
            # The left neighbour's right halo is this slab's first planes,
            # the right neighbour's left halo its last ones (they overlap
            # where sx < 2 r: both add).
            if left is not None:
                own.narrow(dim, 0, r).add_(left)
            if right is not None:
                own.narrow(dim, sx - r, r).add_(right)
            out.append(own)
        return (None, None, None) + tuple(out)


class _GatherX(torch.autograd.Function):
    """:meth:`SlabGroup.gather_x` and its adjoint, a reduce-scatter
    (``all_reduce`` of the whole cotangent, then this rank's planes: gloo
    has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, g, dim, slab):
        ctx.g, ctx.dim, ctx.sx = g, dim, slab.shape[dim]
        slab = slab.contiguous()
        every = g._gather(slab)
        g.stats["gathers"] += 1
        g.stats["gather_bytes"] += (g.ranks - 1) * slab.numel() \
            * slab.element_size()
        return torch.cat(every, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.g
        grad = grad.clone(memory_format=torch.contiguous_format)
        g._reduce(grad)
        g.stats["back_gathers"] += 1
        return (None, None,
                grad.narrow(ctx.dim, g.rank * ctx.sx, ctx.sx).contiguous())


class _SumOverGroup(torch.autograd.Function):
    """:meth:`SlabGroup.all_reduce`'s sum and its adjoint, the sum of the
    cotangents over the group."""

    @staticmethod
    def forward(ctx, g, t):
        ctx.g = g
        out = t.clone()
        g._reduce(out)
        g.stats["reductions"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        ctx.g._reduce(grad)
        ctx.g.stats["back_reductions"] += 1
        return None, grad


def slab_group(group, volume_size: int):
    """A :class:`SlabGroup` of ``group`` (a process group, or None for no
    sharding), or None where the group has one rank: as ``lt_tpu``'s key
    does nothing on one device, the model is then the unsharded one."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return SlabGroup(group, volume_size)
