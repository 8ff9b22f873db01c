"""Parallelism for the port (``lt_tpu/parallel``'s counterpart): data
parallelism, one process per GPU under ``torchrun`` with ``lt_tpu``'s
global-batch semantics (``mesh.py``), and volume-axis (spatial) sharding
of one sample's volume over the ranks for the volumetric model's eval
forward and training step (``spatial.py``)."""

from lt_tpu_torch.parallel.spatial import SlabGroup, slab_group

__all__ = ["SlabGroup", "slab_group"]
