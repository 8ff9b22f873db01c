"""Volume-axis (spatial) sharding: one sample's volume split on its X axis
over the ranks of a process group.  The port's counterpart of
``lt_tpu/parallel/spatial.py`` (``volume_sharding``, ``constrain_volume``),
for the volumetric model's eval forward on the fused kernel path.

``lt_tpu`` annotates the (B, X, Y, Z, C) volume with a sharding and lets
GSPMD insert the halo exchanges each convolution needs at a slab's edges,
the all-reduces of the soft-argmax, and the re-replication of the deep
hourglass levels that are too thin to split.  The port has no GSPMD, so
:class:`SlabGroup` does by hand what the partitioner does there:

- rank r of n owns X planes [r X / n, (r + 1) X / n) of every level of
  extent X (:meth:`SlabGroup.slab`); n = gcd(volume size, world size) must
  be the whole group, since a rank cannot idle through a collective as
  ``lt_tpu``'s spare devices do;
- a kernel call runs on the rank's slab extended by ``reach`` X planes
  from each interior neighbour (:meth:`SlabGroup.extend_x`, one
  ``all_gather`` of every rank's first and last planes), and nothing at the
  volume's two global faces, where the kernels' own zero padding is the
  whole volume's; :meth:`SlabGroup.crop_x` cuts the call's output back to
  the slab;
- :meth:`SlabGroup.gather_x` and :meth:`SlabGroup.take_slab` move between
  a slab and the whole volume of a level (``all_gather``; slicing).

The same collectives run over NCCL and over gloo (two ranks on one card)
on CUDA tensors, and over gloo on the CPU.  Training on slabs is not
ported (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

#: Where the parts of volume-axis sharding that are not ported are queued.
NOT_PORTED = "ROADMAP Queue A item 8 (volume-axis sharding: training)"


class SlabGroup:
    """The ranks of ``group`` splitting one sample's volume of
    ``volume_size`` planes on X, and the exchanges between them.

    ``stats`` counts this rank's collectives since the last
    :meth:`reset_stats`: halo exchanges and the bytes of the neighbours'
    planes received (``halo_bytes``), gathers of a whole level and their
    bytes, and the soft-argmax's reductions."""

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
                f"cannot idle through a collective; pick a world size that "
                f"divides model.volume_size")
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = dict(exchanges=0, halo_bytes=0, gathers=0,
                          gather_bytes=0, reductions=0)

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

    def exchange(self, pairs: Sequence[Tuple[torch.Tensor, int]]
                 ) -> List[torch.Tensor]:
        """Each (slab, reach) of ``pairs`` extended by ``reach`` X planes
        (dim 1) from each interior neighbour, in one ``all_gather`` of
        every rank's first and last ``reach`` planes of each slab."""
        if not any(reach for _, reach in pairs):
            return [t for t, _ in pairs]
        for t, reach in pairs:
            if not 0 <= reach <= t.shape[1]:
                raise ValueError(f"reach {reach} beyond a slab of "
                                 f"{t.shape[1]} planes")
            if t.dtype != pairs[0][0].dtype:
                raise TypeError("one exchange takes slabs of one type")
        edges = [torch.cat([t[:, :r], t[:, t.shape[1] - r:]], 1).reshape(-1)
                 for t, r in pairs]
        mine = torch.cat(edges)
        every = [torch.empty_like(mine) for _ in range(self.ranks)]
        dist.all_gather(every, mine, group=self.group)
        self.stats["exchanges"] += 1
        out, offset = [], 0
        for (t, r), edge in zip(pairs, edges):
            shape = (t.shape[0], 2 * r) + tuple(t.shape[2:])
            parts = [t]
            if self.rank > 0:         # the left neighbour's last planes
                left = every[self.rank - 1][offset:offset + edge.numel()]
                parts.insert(0, left.reshape(shape)[:, r:])
            if self.rank < self.ranks - 1:   # the right one's first planes
                right = every[self.rank + 1][offset:offset + edge.numel()]
                parts.append(right.reshape(shape)[:, :r])
            self.stats["halo_bytes"] += sum(
                p.numel() * p.element_size() for p in parts if p is not t)
            out.append(torch.cat(parts, 1))
            offset += edge.numel()
        return out

    def extend_x(self, slab: torch.Tensor, reach: int) -> torch.Tensor:
        """``slab`` (B, sx, ...) extended by ``reach`` X planes from each
        interior neighbour (:meth:`exchange` of one slab)."""
        return self.exchange([(slab, reach)])[0]

    def crop_x(self, extended: torch.Tensor, reach: int) -> torch.Tensor:
        """The slab's planes of a call's output on an extended slab: the
        ``reach`` planes at each interior side removed (contiguous)."""
        lo = reach if self.rank > 0 else 0
        hi = extended.shape[1] - (reach if self.rank < self.ranks - 1
                                  else 0)
        return extended[:, lo:hi].contiguous()

    def gather_x(self, slab: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole volume of a level: every rank's slab, concatenated on
        ``dim`` in rank order, in every rank."""
        slab = slab.contiguous()
        every = [torch.empty_like(slab) for _ in range(self.ranks)]
        dist.all_gather(every, slab, group=self.group)
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += (self.ranks - 1) * slab.numel() \
            * slab.element_size()
        return torch.cat(every, dim)

    def take_slab(self, whole: torch.Tensor, reach: int = 0) -> torch.Tensor:
        """This rank's X planes (dim 1) of a whole (replicated) level,
        extended by ``reach`` planes on each interior side, as
        :meth:`extend_x` extends the slab (contiguous)."""
        extent = whole.shape[1]
        x0, sx = self.slab(extent)
        lo, hi = max(x0 - reach, 0), min(x0 + sx + reach, extent)
        return whole[:, lo:hi].contiguous()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced in place over the group (the soft-argmax's
        maximum and sums)."""
        dist.all_reduce(t, op=op, group=self.group)
        self.stats["reductions"] += 1
        return t


def slab_group(group, volume_size: int):
    """A :class:`SlabGroup` of ``group`` (a process group, or None for no
    sharding), or None where the group has one rank: as ``lt_tpu``'s key
    does nothing on one device, the model is then the unsharded one."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return SlabGroup(group, volume_size)
