"""lt_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of ``lt_tpu``.

The package mirrors ``lt_tpu``'s modules and layouts (NHWC images, NDHWC
volumes) so each piece can be held against the JAX reference.  It imports
``torch`` and numpy only.  Every kernel that ``lt_tpu`` wrote in Pallas is a
hand-written CUDA kernel here (``lt_tpu_torch.ops.kernels``); its plain
PyTorch version runs only for tensors that lie on the CPU.

Entry points take ``device`` (default ``"cuda"``).  Without CUDA they raise
unless the caller asked for ``"cpu"``: nothing silently falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it names CUDA and no GPU
    is present.  The CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def compute_context(x: torch.Tensor, compute_dtype: torch.dtype):
    """The context in which PyTorch's own convolutions run in
    ``compute_dtype`` on ``x``'s device: ``torch.autocast`` for bfloat16,
    nothing for float32."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)
