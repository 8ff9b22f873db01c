"""The port stands alone and never hides the device.

- No file of ``lt_tpu_torch/`` or ``chip_smoke.py`` imports ``jax``,
  ``flax`` or ``lt_tpu`` (AST scan).
- Without CUDA the default device raises instead of running on the CPU.
"""

import ast
import pathlib

import pytest
import torch

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lt_tpu")
PORT_FILES = sorted((ROOT / "lt_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_lt_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        VolumetricTriangulationNet(num_layers=18, volume_size=16)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_check_shapes_before_either_path():
    """A wrapper's shape checks apply to CPU tensors too."""
    from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from lt_tpu_torch.ops.kernels.updown import max_pool3d_2x

    with pytest.raises(ValueError):
        max_pool3d_2x(torch.zeros(1, 3, 2, 2, 4))
    with pytest.raises(ValueError):
        conv3d_fused(torch.zeros(1, 4, 4, 4, 8), torch.zeros(2, 2, 2, 8, 8),
                     torch.zeros(8))
