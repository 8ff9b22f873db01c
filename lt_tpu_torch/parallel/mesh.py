"""Data parallelism over processes: the port's counterpart of
``lt_tpu/parallel/mesh.py``.

``lt_tpu`` lays the leading (batch) axis of every batch over a 1-D device
mesh ('data'), replicates the parameters, and lets XLA insert the gradient
all-reduce; BatchNorm statistics, losses and metrics are then taken over
the global batch.  The port runs one process per GPU, launched by
``torchrun`` (its env:// variables, :func:`is_distributed_env`), and keeps
those semantics:

- ``opt.batch_size`` is the global batch; rank r holds its rows
  [r b, (r + 1) b), b = batch / world size (:func:`shard_batch`, and
  ``data.batch.BatchIterator(rank=, world_size=)``, which loads only them);
- the model is wrapped in ``DistributedDataParallel`` (:func:`data_parallel`)
  and its BatchNorm layers reduce over the group
  (``models.batchnorm.BatchNorm.process_group``);
- the losses' normalizers are global sums (:func:`all_sum`), and eval
  gathers each rank's rows (:func:`gather_rows`).

Both collectives are ``all_reduce``, which NCCL and gloo take for CUDA
tensors (gloo's ``all_gather`` takes them too: ``parallel/spatial.py``).
The master (rank 0) writes logs and checkpoints (:func:`is_master`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.batchnorm import BatchNorm

#: The variables ``torchrun`` (env:// rendezvous) exports to each process.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def is_distributed_env() -> bool:
    """True in a process that ``torchrun`` launched (all of
    :data:`TORCHRUN_ENV` set)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize_distributed(device="cuda") -> torch.device:
    """Join the launch's process group and return this rank's device.

    Under ``torchrun``: NCCL for ``cuda`` with rank r on
    ``cuda:LOCAL_RANK``, gloo for ``cpu``.  In a plain single process, or
    where a group exists already, it joins nothing and returns ``device``
    (on ``cuda:LOCAL_RANK`` in the second case)."""
    dev = resolve_device(device)
    if not is_distributed_env():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def world_size(group=None) -> int:
    """Ranks in ``group`` (default: the whole launch); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without one."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_master() -> bool:
    """True on the rank that writes logs and checkpoints (rank 0)."""
    return rank() == 0


def broadcast_object(value):
    """The master's ``value`` (any picklable object), in every rank."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank of the launch (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


def data_parallel(model: torch.nn.Module,
                  device: torch.device) -> DistributedDataParallel:
    """``model`` wrapped for data parallelism over the launch's ranks.

    Its BatchNorm layers take their training statistics over the group
    (where it has more than one rank).  Buffers are not broadcast at each
    forward: the global statistics keep them equal on every rank.  The
    frozen ``backbone.final_layer`` (``requires_grad=False``) stays out of
    the gradient reduction."""
    if world_size() > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = dist.group.WORLD
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def data_group(model: torch.nn.Module):
    """The group over which ``model``'s batch is split: that of a
    :func:`data_parallel` model of more than one rank, else None."""
    if isinstance(model, DistributedDataParallel) and world_size(
            model.process_group) > 1:
        return model.process_group
    return None


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper (names
    without ``module.``)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's contiguous rows of each array or tensor of a global
    batch (``lt_tpu``'s ``batch_sharding`` of the leading axis)."""
    w, r = world_size(group), rank(group)
    out = {}
    for k, v in batch.items():
        if len(v) % w:
            raise ValueError(f"{k}: {len(v)} rows do not split over {w} "
                             f"ranks")
        n = len(v) // w
        out[k] = v[r * n:(r + 1) * n]
    return out


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, in every rank (no
    gradient); ``t`` itself where ``group`` is None."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``t`` stacked in rank order, in every rank:
    an ``all_reduce`` of a zero buffer that holds this rank's rows (exact:
    each element is one rank's value plus zeros)."""
    if group is None:
        return t
    n, r = t.shape[0], rank(group)
    out = t.new_zeros((world_size(group) * n,) + tuple(t.shape[1:]))
    out[r * n:(r + 1) * n] = t
    dist.all_reduce(out, group=group)
    return out

