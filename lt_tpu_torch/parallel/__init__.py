"""Data parallelism for the port (``lt_tpu/parallel``'s counterpart):
one process per GPU under ``torchrun``, ``lt_tpu``'s global-batch
semantics.  ``lt_tpu``'s volume-axis sharding (``parallel/spatial.py``)
has no counterpart yet."""
