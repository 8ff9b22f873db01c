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
