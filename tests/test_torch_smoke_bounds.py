"""The operation count behind ``chip_smoke.py``'s bound for K2, on the CPU.

A 'same' convolution with zero padding needs a product only for the taps
that land inside the volume; ``chip_smoke.conv_flops`` counts those in
closed form.  Here it is held to a direct count: ``F.conv3d`` of an
all-ones volume with all-ones weights gives, at each output voxel, the
number of taps inside.
"""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("k, dims", [
    (7, (64, 64, 64)), (3, (64, 64, 64)), (3, (2, 2, 2)), (7, (4, 4, 4)),
    (3, (5, 6, 7)), (7, (1, 3, 5)), (1, (3, 3, 3))])
def test_conv_flops_counts_the_taps_inside_the_volume(k, dims):
    b, cin, cout = 2, 3, 5
    ones = torch.ones((1, 1) + dims, dtype=torch.float64)
    taps = F.conv3d(ones, torch.ones((1, 1, k, k, k), dtype=torch.float64),
                    padding=(k - 1) // 2).sum().item()
    assert chip_smoke.conv_flops(b, dims, k, cin, cout) == (
        2.0 * b * taps * cin * cout)


def test_conv_flops_leaves_out_the_padding():
    # k=7 at 64^3: per axis 64 * 7 - 2 * (1 + 2 + 3) = 436 of the 448
    # (output, tap) pairs land inside, so the dense count is 8.5 % high.
    assert chip_smoke.conv_flops(1, (64,) * 3, 7, 1, 1) == 2.0 * 436 ** 3
    assert chip_smoke.conv_flops(1, (64,) * 3, 1, 1, 1) == 2.0 * 64 ** 3


@pytest.mark.parametrize("itemsize, want_ms", [(4, 0.1191), (2, 0.0596)])
def test_pool_bytes_at_the_flagship(itemsize, want_ms):
    """K4's bytes bound summed over the flagship forward's five pools at
    batch 8 (64^3 x 32, 32^3 x 64, 16^3 x 128, 8^3 x 128, 4^3 x 128): the
    input read once, an eighth of it written, at 3.35 TB/s."""
    shapes = [(64, 32), (32, 64), (16, 128), (8, 128), (4, 128)]
    ms = sum(chip_smoke.bound(chip_smoke.pool_bytes(8 * s ** 3 * c,
                                                    itemsize), 0.0)[0]
             for s, c in shapes)
    assert round(ms, 4) == want_ms


def test_graph_capture_leaves_the_launch_counts():
    """A CUDA graph's capture calls each wrapper once per captured launch,
    and each call counts; launches_kept restores the counts, also when the
    capture raises."""
    from lt_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    _build.LAUNCHES["max_pool3d_2x"] = 5

    def captured_launch():      # what a wrapper does inside a capture
        _build.LAUNCHES["max_pool3d_2x"] += 1
        _build.LAUNCHES["upsample3d_2x"] += 1

    with chip_smoke.launches_kept():
        for _ in range(200):
            captured_launch()
    assert _build.LAUNCHES["max_pool3d_2x"] == 5
    assert _build.LAUNCHES["upsample3d_2x"] == 0
    with pytest.raises(RuntimeError):
        with chip_smoke.launches_kept():
            captured_launch()
            raise RuntimeError("capture failed")
    assert _build.LAUNCHES["upsample3d_2x"] == 0
    _build.reset_launches()


@pytest.mark.parametrize("est_ms, n", [(0.125, 40), (0.0001, 200), (10.0, 2),
                                       (0.0, 200)])
def test_graph_n_holds_the_budget(est_ms, n):
    assert chip_smoke.graph_n(est_ms) == n
