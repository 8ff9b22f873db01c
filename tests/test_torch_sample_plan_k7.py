"""K7 (``csrc/sample_views.cu``) modelled brick by brick in plain PyTorch
on the CPU, against its plain version and the K5 model: the 36 cases of
``tests/test_torch_sample_plan.py``'s models that take most of its time,
in a file of their own so that ``--dist loadfile`` can run them on
another worker.  The models and scenes are that file's.
"""

import pytest
import torch

from lt_tpu_torch.ops.kernels import sample
from tests.test_torch_sample_plan import (_edges_nonfinite, _k5_model,
                                          _k7_model, _scene)


@pytest.mark.parametrize("in_dtype, out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("s", [7, 10, 13])
@pytest.mark.parametrize("c", [40, 17, 8])
def test_k7_model_of_its_bricks_is_the_plain_sample(c, s, in_dtype,
                                                     out_dtype):
    """Voxels-major rows, brick by brick: equal to sample_views_plain on
    _scene's edge views (one bfloat16 ulp of the largest value where the
    output is bfloat16: the two round once, from float32 sums in another
    order) and to the K5 model transposed (bit for bit, rounded once);
    with NaN and infinities on the maps' edges, the plain version's NaN
    and infinities."""
    feats, m = _scene(s, seed=s, c=c)
    feats = feats.to(in_dtype)
    got = _k7_model(feats, m, s, out_dtype)
    assert got.dtype == out_dtype
    ref = sample.sample_views_plain(feats, m, s, out_dtype)
    atol = (2.0 ** -7 * ref.abs().max().item() if out_dtype == torch.bfloat16
            else 1e-6)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)
    assert torch.equal(got, _k5_model(feats, m, s).transpose(1, 2)
                       .to(out_dtype))
    assert bool((got[1] == 0).all()) and bool((got[3] == 0).all())
    _edges_nonfinite(feats, m, s, lambda f: _k7_model(f, m, s, out_dtype),
                     lambda f: sample.sample_views_plain(f, m, s,
                                                         out_dtype))
