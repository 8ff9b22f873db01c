"""K2 in float32 on the tensor cores, on the CPU: the split into bfloat16
parts that ``csrc/conv3d_mma_f32.cu`` computes.

- The split: ``conv3d.split_bf16`` (its plain version here) gives
  hi = bf16(x), lo = bf16(x - hi), bit for bit as ``lt_tpu``'s float32
  Pallas unprojection splits its operands
  (``lt_tpu/ops/pallas/unproject.py:306-309``, in JAX), with hi + lo
  within 2^-16 relative of x, on normal, tiny, huge and negative inputs
  (and within half a bfloat16 subnormal step below float32's normal
  range, where lo loses its bits); three parts within 2^-24.
- The convolution: ``conv3d.conv3d_split`` on the CPU is the kernel's
  arithmetic in plain torch: float32 ``F.conv3d`` over the bfloat16-valued
  parts, x_i * w_j for i + j < parts (each product exact in float32), then
  bias, residual and ReLU: six terms of three parts for k <= 3, three of
  two for k = 7 (``conv3d.split_parts``).  Held to K2's float32
  contract, relative 1e-4 of max |plain| (PERF.md section 2), against
  ``conv3d_fused_plain`` (true float32) for k = 1, 3, 7 at the flagship's
  channel pairs, and against ``lt_tpu``'s float32 ``conv3d_same`` (the
  Pallas kernel in interpret mode) for k = 3.  Measured (the test prints
  it): three terms 2.6e-6 to 3.8e-6, six 1.1e-7 to 1.8e-6, float32's own
  summation order (held to 3.5e-6, and below three terms on the same
  case).  One term alone (hi*hi) is far off and fails the contract.
- Weights split once: ``conv3d_fused`` takes the parts of float32
  weights, which ``V2VModel`` packs (on the card) once per weight
  version; both V2V kernel paths run on them within K2's contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lt_tpu.ops.pallas import conv3d as j_conv3d
from lt_tpu_torch.models.v2v import V2VModel
from lt_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                             conv3d_fused_plain,
                                             conv3d_split, conv3d_split_plain,
                                             pointwise, split_bf16,
                                             split_parts)

REL = 1e-4
# Six products of three parts: float32's own rounding over the sums (up to
# 3456 terms here, sqrt(3456) * 2^-24 = 3.5e-6), on either side.
SIX_TERMS = 3.5e-6
BF16 = torch.bfloat16

# (k, Cin, Cout): the flagship V2V's K2 channel pairs.
CASES = [(7, 32, 16), (3, 16, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64),
         (3, 64, 128), (3, 128, 128), (1, 16, 32), (1, 32, 64),
         (1, 64, 128), (1, 32, 17)]


def _inputs(k, cin, cout, seed=0, shape=(2, 6, 5, 7)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(k, k, k, cin, cout) * (k ** 3 * cin) ** -0.5).astype(
        np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    r = rng.randn(*shape, cout).astype(np.float32)
    return x, w, b, r


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("k, cin, cout", CASES)
def test_three_term_conv_holds_the_float32_contract(k, cin, cout):
    x, w, b, r = _inputs(k, cin, cout)
    tx, tw, tb, tr = map(torch.from_numpy, (x, w, b, r))
    parts = split_parts(k)
    got = conv3d_split(split_bf16(tx, parts), split_bf16(tw, parts), tb, tr,
                       relu=True)
    assert got.dtype == torch.float32
    ref = conv3d_fused_plain(tx, tw, tb, tr, relu=True)
    err = _rel(got, ref)
    limit = REL if parts == 2 else SIX_TERMS
    print(f"k={k} {cin}->{cout}: {parts} parts vs float32 {err:.2e} "
          f"(limit {limit})")
    assert err <= limit, err
    assert err > 0.0                # the terms are bfloat16, not float32
    if parts == 3:      # two parts hold the contract too, further off
        two = _rel(conv3d_split_plain(split_bf16(tx, 2), split_bf16(tw, 2),
                                      tb, tr, relu=True), ref)
        print(f"  2 parts {two:.2e}")
        assert err < two <= REL
    if k == 3:
        jref = j_conv3d.conv3d_same(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), relu=True,
                                    residual=jnp.asarray(r), interpret=True)
        jerr = _rel(got, jref)
        print(f"  vs lt_tpu conv3d_same (float32, interpret) {jerr:.2e}")
        assert jerr <= REL, jerr


@pytest.mark.parametrize("out_dtype", [torch.float32, BF16])
def test_three_term_conv_without_residual_and_relu(out_dtype):
    x, w, b, _ = _inputs(3, 32, 32, seed=1)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = conv3d_split(split_bf16(tx, 3), split_bf16(tw, 3), tb,
                       out_dtype=out_dtype)
    ref = conv3d_fused_plain(tx, tw, tb, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    # bfloat16 output: the one rounding of the result, two ulps at most.
    assert _rel(got.float(), ref.float()) <= (REL if out_dtype ==
                                              torch.float32 else 1.6e-2)


def test_one_term_is_not_enough():
    """hi*hi alone (bfloat16 operands, float32 sum) misses the contract
    by far: the split's lo terms are what holds it."""
    x, w, b, r = _inputs(3, 32, 32, seed=2)
    tx, tw, tb, tr = map(torch.from_numpy, (x, w, b, r))
    ref = conv3d_fused_plain(tx, tw, tb, tr, relu=True)
    hi_only = conv3d_fused_plain(tx.to(BF16).float(), tw.to(BF16).float(),
                                 tb, tr, relu=True)
    three = conv3d_split_plain(split_bf16(tx), split_bf16(tw), tb, tr,
                               relu=True)
    assert _rel(hi_only, ref) > 10 * REL
    assert _rel(hi_only, ref) > 20 * _rel(three, ref)


def _values(kind, rng):
    v = rng.randn(4096).astype(np.float32)
    return {"normal": v,
            "tiny": (v + np.sign(v)) * np.float32(1e-30),
            "huge": np.concatenate([v * np.float32(1e30),
                                    np.float32([3.3e38, -3.38e38, 1e38])]),
            "negative": -np.abs(v),
            "subnormal": v * np.float32(1e-40)}[kind]


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "negative",
                                  "subnormal"])
def test_split_is_lt_tpus_split_and_within_2_to_the_minus_16(kind):
    v = _values(kind, np.random.RandomState(3)).astype(np.float32)
    parts = split_bf16(torch.from_numpy(v))
    assert parts.dtype == BF16 and tuple(parts.shape) == (2, v.size)
    hi, lo = parts.float().numpy().astype(np.float64)
    # lt_tpu's split (unproject.py:306-307), in JAX, wherever v - hi is a
    # normal float32: XLA's CPU backend flushes subnormal results to zero,
    # which the card and PyTorch do not.
    j_hi = jnp.asarray(v).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(v) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    normal = np.abs(v) >= 2.0 ** -110
    assert normal.any() == (kind != "subnormal")
    np.testing.assert_array_equal(hi[normal], np.asarray(j_hi, np.float64)[
        normal])
    np.testing.assert_array_equal(lo[normal], np.asarray(j_lo, np.float64)[
        normal])
    assert np.isfinite(hi).all() and np.isfinite(lo).all()
    # Both parts are bfloat16 values: eight significant bits.
    for part in (hi, lo):
        m, _ = np.frexp(part)
        assert (m * 256 == np.round(m * 256)).all()
    err = np.abs(v.astype(np.float64) - (hi + lo))
    assert (err[normal] <= 2.0 ** -16 * np.abs(v[normal])).all()
    # Near and below float32's normal range lo is a bfloat16 subnormal,
    # whose step is 2^-133: there the bound is half of it.
    assert (err <= np.maximum(2.0 ** -16 * np.abs(v), 2.0 ** -134)).all()


def test_three_parts_are_within_2_to_the_minus_24():
    v = _values("normal", np.random.RandomState(4)).astype(np.float64)
    parts = split_bf16(torch.from_numpy(v.astype(np.float32)), 3)
    assert tuple(parts.shape) == (3, v.size)
    total = parts.double().sum(0).numpy()
    v32 = v.astype(np.float32).astype(np.float64)
    assert (np.abs(v32 - total) <= 2.0 ** -24 * np.abs(v32)).all()
    np.testing.assert_array_equal(parts[:2].float().numpy(),
                                  split_bf16(torch.from_numpy(
                                      v32.astype(np.float32))).float().numpy())


def test_split_refuses_other_types_and_counts():
    with pytest.raises(TypeError, match="float32"):
        split_bf16(torch.zeros(4, dtype=BF16))
    with pytest.raises(ValueError, match="2 or 3"):
        split_bf16(torch.zeros(4), 4)
    with pytest.raises(ValueError, match="parts"):
        conv3d_split(split_bf16(torch.zeros(1, 2, 2, 2, 4)),
                     split_bf16(torch.zeros(1, 1, 1, 4, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="parts"):
        conv3d_split(split_bf16(torch.zeros(1, 2, 2, 2, 4), 3),
                     split_bf16(torch.zeros(7, 7, 7, 4, 4), 3),
                     torch.zeros(4))


@pytest.mark.parametrize("k, cin, cout", [(7, 32, 16), (3, 16, 32),
                                          (1, 32, 17)])
def test_conv3d_fused_takes_the_parts_of_float32_weights(k, cin, cout):
    """Weights given as their parts (as V2V packs them) compute what
    conv3d_split computes from x's parts and theirs; a (Cin, Cout) weight's
    parts become a 1x1x1 kernel's through ``pointwise``."""
    x, w, b, r = map(torch.from_numpy, _inputs(k, cin, cout, seed=5))
    parts = split_parts(k)
    ws = split_bf16(w, parts)
    got = conv3d_fused(x, ws, b, r, relu=True)
    want = conv3d_split_plain(split_bf16(x, parts), ws, b, r, relu=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert _rel(got, conv3d_fused_plain(x, w, b, r, relu=True)) <= REL
    if k == 1:
        w2 = w.reshape(cin, cout)
        assert torch.equal(pointwise(split_bf16(w2, parts)), ws)
        assert tuple(pointwise(w2).shape) == (1, 1, 1, cin, cout)
    with pytest.raises(TypeError, match="float32 x"):
        conv3d_fused(x.to(BF16), ws, b)
    with pytest.raises(TypeError, match="bfloat16 parts"):
        conv3d_fused(x, ws.float(), b)


def _tensors(tree):
    if isinstance(tree, dict):
        return {f"{k}/{n}": t for k, v in tree.items()
                for n, t in _tensors(v).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{n}": t for i, v in enumerate(tree)
                for n, t in _tensors(v).items()}
    return {"": tree} if torch.is_tensor(tree) else {}


def test_v2v_splits_its_float32_weights_only_on_the_card():
    """V2V's packing replaces every K2 weight of a float32 tree by its
    parts (on the card; on the CPU the tree stays float32): the k=7 front
    conv in two parts, the others in three, the upsample taps and the
    biases untouched."""
    from lt_tpu_torch.models import v2v

    model = V2VModel(32, 17, device="cpu")
    tree = model.packed_params()
    assert all(t.dtype == torch.float32 for t in _tensors(tree).values())
    split = _tensors(v2v._split_conv_weights(tree))
    whole = _tensors(tree)
    assert split.keys() == whole.keys()
    parted = {n for n, t in split.items() if t.dtype == BF16}
    # The k=7 front, the 23 Res3D blocks' two convolutions (front chain,
    # skip_res1-5, encoder, mid, decoder, back_res; skip_res1 packed for
    # each path), the 3 projections, the 3-layer tail.
    assert len(parted) == 1 + 2 * 23 - 1 + 3
    for n, t in split.items():
        w = whole[n]
        if n in parted:
            parts = 2 if w.dim() == 5 and w.shape[0] == 7 else 3
            assert tuple(t.shape) == (parts, *w.shape)
            assert torch.equal(t, split_bf16(w, parts))
        else:
            assert t is w and (w.dim() == 1 or n.startswith(
                "decoder_upsample"))


@pytest.mark.parametrize("use_kernels", ["fused", "conv"])
def test_v2v_runs_on_the_parts_of_its_weights(use_kernels):
    """Both kernel paths, fed the packed parts as on the card, hold the
    float32 module graph to K2's contract on the CPU (every K2 call then
    goes through conv3d_split)."""
    from lt_tpu_torch.models import v2v

    model = V2VModel(32, 17, use_kernels=use_kernels, device="cpu", seed=4)
    plain = V2VModel(32, 17, use_kernels=False, device="cpu", seed=4)
    split = v2v._split_conv_weights(model.packed_params())
    model.packed_params = lambda: split
    x = torch.from_numpy(np.random.RandomState(6).randn(
        1, 32, 32, 32, 32).astype(np.float32))
    with torch.no_grad():
        got, ref = model(x), plain(x)
    err = _rel(got, ref)
    print(f"{use_kernels} on the parts vs the module graph: {err:.2e}")
    assert got.dtype == torch.float32 and 0.0 < err <= REL
