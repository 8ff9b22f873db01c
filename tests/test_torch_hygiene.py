"""The port stands alone and never hides the device.

- No file of ``lt_tpu_torch/`` or ``chip_smoke.py`` imports ``jax``,
  ``flax``, ``optax``, ``orbax`` or ``lt_tpu`` (AST scan).
- No module of the port reads an environment switch (``lt_tpu`` selects
  its kernel paths with ``LT_TPU_*`` variables; the port takes arguments):
  the only read is ``CUDA_HOME`` in the kernels' build.
- Without CUDA the default device raises instead of running on the CPU.
"""

import ast
import pathlib

import pytest
import torch

from lt_tpu_torch import resolve_device
from lt_tpu_torch.engine.factory import make_model
from lt_tpu_torch.engine.train import run
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.utils.cfg import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNTH_YAML = str(pathlib.Path(__file__).resolve().parents[1] / "experiments"
                 / "synthetic" / "vol_tiny_2stage.yaml")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lt_tpu")
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


def _environment_reads(path: pathlib.Path):
    """Names read from the environment: ``os.environ[...]``, ``.get(...)``
    and ``os.getenv(...)`` (the string argument, or '?' if not a literal)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        hit = None
        if isinstance(node, ast.Subscript) and ast.unparse(
                node.value) == "os.environ":
            hit = node.slice
        elif isinstance(node, ast.Call) and ast.unparse(node.func) in (
                "os.environ.get", "os.getenv", "os.environ.setdefault"):
            hit = node.args[0] if node.args else None
        elif isinstance(node, ast.Attribute) and ast.unparse(
                node) == "os.environ" and not isinstance(
                getattr(node, "ctx", None), ast.Load):
            hit = node
        if hit is not None:
            yield hit.value if isinstance(hit, ast.Constant) else "?"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment_switch(path):
    allowed = {"CUDA_HOME"} if path.name == "_build.py" else set()
    reads = set(_environment_reads(path))
    assert reads <= allowed, f"{path.relative_to(ROOT)} reads {reads}"


def test_new_kernel_modules_are_part_of_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"res3d_q4.py", "res3d_folded.py", "conv_mp.py", "conv3d.py",
            "sample.py"} <= names
    csrc = {p.stem for p in (ROOT / "lt_tpu_torch" / "ops" / "kernels"
                             / "csrc").glob("*.cu")}
    from lt_tpu_torch.ops.kernels import _build
    assert csrc == set(_build.SOURCES)


def test_data_modules_are_part_of_the_port():
    """The data layer's modules (datasets, batching, images, the native
    pipeline's bindings) are in the scan above, and the native library is
    built outside the package."""
    port = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"lt_tpu_torch/{m}" for m in (
        "data/human36m.py", "data/cmu_panoptic.py", "data/batch.py",
        "utils/img.py", "native/__init__.py")} <= port
    from lt_tpu_torch import native
    assert native.lib_path().parent == ROOT / "build" / "native"


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        VolumetricTriangulationNet(num_layers=18, volume_size=16)
    config = load_config(SYNTH_YAML)
    with pytest.raises(RuntimeError, match="cuda"):
        make_model(config)
    with pytest.raises(RuntimeError, match="cuda"):
        run(SYNTH_YAML, str(tmp_path))
    assert not any(tmp_path.iterdir())       # raised before any output
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
