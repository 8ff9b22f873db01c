#!/usr/bin/env python3
"""Smoke run of lt_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels of the port from ``lt_tpu_torch/ops/kernels/csrc``
(ten sources, eleven kernels) and holds each against its plain PyTorch
version.  K2 runs on the tensor cores in two instances of one body:
``conv3d_mma`` for bfloat16 inputs, ``conv3d_mma_f32`` (after
``split_bf16`` of its input) for float32 inputs, as six (k <= 3) or three
(k = 7) bfloat16 products; K3 has ``upsample3d_2x`` (CUDA cores) for float32 and
``upsample3d_2x_mma`` (tensor cores) for bfloat16.  Every bfloat16 path
must launch only the bfloat16 bodies, every float32 path only the float32
ones.  K1's replay line also times its other launch plan (feature windows
staged in shared memory or not), K4's its scalar instance (on a base off 16
bytes), each held to the plain version as well; K3's and K4's launches,
a few microseconds each at the small levels, are timed also as CUDA graphs
(``graph_ms``), which the host's launch loop cannot keep fed.  A phase
plants NaN and infinities in K1-K8's inputs (for the samplers also on the
maps' edges, which taps off the map read with weight 0, with a masked
view for K1, +inf for K1's softmax, and for the scatters K6 and K8 in the
gradient of voxels with taps off the map) and holds each kernel to its
plain version's NaN, the float32 K2 to true float32 (``nan_checks``).
Then it drives
the port's paths at the flagship width (ResNet-152, 384^2 images, 4 views,
64^3 volume, softmax aggregation, 17 joints, seeded random weights): the
eval forward through K1-K4 (requests at batch 8) in float32 and in the
bfloat16 configuration, in the fused and in the per-conv V2V
configuration; the entry points that have no caller on those paths
(``conv3d_same``, ``res3d_block_mp`` / ``_q4`` / ``_folded``,
``sample_views_affine`` through K7 and K8) at the flagship shapes (K7 in
three type pairs, K8 for float32 and bfloat16 g, each K8 also with direct
atomics only, K7 held bit for bit to K5 and to its own float32 output
rounded); and the training step of
experiments/human36m/train/human36m_vol_softmax.yaml (batch 5, float32)
through K1 and, in its backward, K5 and K6; before it, K5 and K6 at its
shapes (K6 also with direct atomics only), K5 held to K7 and to K1's 'sum'
of each view bit for bit; then K5's and K6's bfloat16 instances at those
shapes (K5 bfloat16 -> bfloat16 and float32 -> bfloat16, bit for bit K7's;
K6 on a bfloat16 g) and the same step with ``bf16: true``, its kernel and
plain paths each held to the plain float32 step, K1, K5 and K6 once a
step in bfloat16.  It also runs the committed trained RN-18
fixture in float32 and bfloat16, and trains the synthetic config for one
epoch through the CLI's ``run``, then resumes it.  Then the algebraic and
RANSAC families, which launch no kernel of the port (``lt_tpu`` computes
them with XLA only): AlgebraicTriangulationNet at the flagship width in
float32 and bfloat16 and RANSACTriangulationNet in float32 (batch 8,
seeded random weights; the DLT's and RANSAC's launches and device time),
both on the trained RN-18 backbone fixture (card vs CPU, bfloat16 vs
float32), the training step of
experiments/human36m/train/human36m_alg.yaml (batch 8, float32 and
``bf16: true``) and one CLI epoch of experiments/synthetic/alg_tiny.yaml
with its resume.  Last, the
dataset configs through the CLI's ``run``: human36m_vol_softmax.yaml
--eval at its width (val batch 20, float32) on a Human3.6M tree it
writes from a seed (1000^2 JPEGs, the reference's labels ``.npy``, a
whole-model ``.pth`` the port saves with DDP's names), and one batch of
cmu_vol_softmax.yaml on a CMU Panoptic tree: the decoder, K1-K4 launched
as in the flagship forward and no plain version, keypoints equal to a
direct forward, that forward held to the plain path at the run's own
shapes (batch 20, 17 or 19 joints), metric.json's breakdown, and the
loader's rate beside the request's.

    python3 chip_smoke.py [--batch N]

Run from the repository root.  Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result.  Its last three lines
are the kernels JSON, the ``nvidia-smi`` name / power-limit line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 on the CUDA
# cores (the kernels that use no tensor cores) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Dense bfloat16 on the tensor cores: the peak of conv3d_mma,
# conv3d_mma_f32 (six or three bfloat16 products per float32 one) and
# upsample3d_2x_mma, and what a tensor-core redesign of the other kernels
# would be held to.
PEAK_BF16_TC_FLOPS = 989e12
# The flagship configuration (bench.py's shapes): ResNet-152 backbone at
# 384^2 (96^2 heatmaps), a 64^3 volume, 4 views, 17 joints.
FLAGSHIP = {"layers": 152, "image": 384, "heatmap": 96, "volume": 64}
REL_TOL = 1e-4          # kernel vs plain: max |diff| <= REL_TOL * max |plain|
KP_TOL_MM = 0.1         # kernel path vs plain path keypoints
# bfloat16 kernels vs their plain versions, which round where the kernel
# rounds: two bfloat16 ulps (2 * 2^-7) of max |plain|.
REL_TOL_BF16 = 1.6e-2
# bfloat16 kernel path vs the plain bfloat16 path (the module graph under
# autocast).  The two round in other places: the kernels fold BatchNorm into
# bfloat16 weights, the module graph rounds each convolution's output before
# its BatchNorm.  At random weights 1.0 mm does not hold: the paths are 1.85
# mm apart (largest coordinate, recorded on the card), and the plain path
# itself moves by 1.67 mm when its images change by one bfloat16 ulp (the
# run prints that spread).  The limit is twice the largest difference
# recorded (PERF.md, section 6).
KP_TOL_BF16_MM = 4.0
# The trained fixture in bfloat16 vs its float32 keypoints, per joint (mm):
# the CPU test's band (tests/test_torch_bf16.py), around lt_tpu's measured
# mean 1.33 / max 11.7 mm.
FIX_BF16_MEAN_MM = 3.0
FIX_BF16_MAX_MM = 15.0
REQUESTS = 3            # flagship forwards answered on the kernel path
# The kernels whose replayed launches are also timed as a CUDA graph
# (graph_ms): launches of a few microseconds, which the host's launch loop
# cannot keep fed.  Their rows' ``ms`` is the graph time, ``loop_ms`` the
# loop's.
GRAPH_TIMED = ("max_pool3d_2x", "upsample3d_2x", "upsample3d_2x_mma")
# Compared bit for bit with their plain versions.
BIT_EXACT = ("split_bf16", "max_pool3d_2x")
GRAPH_BUDGET_MS = 5.0   # device time one captured graph holds, about
GRAPH_MAX_CALLS = 200   # calls one captured graph holds, at most
GRAPH_REPLAYS = 5       # replays of the graph between the two events
TRAIN_YAML = "experiments/human36m/train/human36m_vol_softmax.yaml"
ALG_TRAIN_YAML = "experiments/human36m/train/human36m_alg.yaml"
ALG_TINY_YAML = "experiments/synthetic/alg_tiny.yaml"
ALG_TINY_STEPS = 16     # alg_tiny.yaml: 64 training poses at batch 4
ALG_KP2D_PX = 1e-3      # [alg] 2D keypoints vs a float64 soft-argmax
# [alg] 3D keypoints vs the float64 numpy DLT: lt_tpu's own limit for that
# comparison (tests/test_geometry.py:130-142).
ALG_KP3D_MM = 0.5
# Random weights put some points hundreds of metres out, where the float32
# DLT's homogeneous coordinate is tiny and its error grows with the
# distance (on the CPU, RN-18 / RN-50: at most 0.054 mm within 10 m, 1.1e-4
# of the distance beyond; lt_tpu's float32 Jacobi shares this): ALG_KP3D_MM
# holds within ALG_NEAR_MM of the rig's centre (its cameras are 4 m out),
# ALG_FAR_REL of the distance beyond.
ALG_NEAR_MM = 10000.0
ALG_FAR_REL = 1e-3
RANSAC_PLANT_MM = 1.0   # [ransac] planted points with an outlier view
ALG_FIX_F32_MM = 0.1    # [alg fixture] float32 on the card vs the CPU
# [alg fixture] bfloat16 vs float32.  The volumetric fixture's band (mean
# FIX_BF16_MEAN_MM, max FIX_BF16_MAX_MM per joint) does not hold for
# lt_tpu's own algebraic and RANSAC models on this backbone: on the CPU
# lt_tpu's bfloat16 keypoints lie mean 5.57 / max 49.5 mm (algebraic) and
# 4.75 / 215 mm (RANSAC, where an argmax that moves one heatmap pixel moves
# a joint by a hundred mm or more) from its float32 ones
# (tests/test_torch_alg_train.py::test_fixture_bfloat16_band_of_lt_tpu).
# The algebraic model is held per joint to about twice lt_tpu's band;
# both are held to the dataset's rel MPJPE within FIX_BF16_MEAN_MM of
# float32's.
FIX_ALG_BF16_MEAN_MM = 12.0
FIX_ALG_BF16_MAX_MM = 100.0
SYNTH_YAML = "experiments/synthetic/vol_tiny_2stage.yaml"
TRAIN_BATCH = 5         # the flagship training config's batch
TRAIN_STEPS = 3         # timed flagship training steps
# Timed bfloat16 training steps (flagship and algebraic): a step takes a
# fifth to a half of the float32 one's time and varies more between
# steps (host launch gaps under autocast).
BF16_TRAIN_STEPS = 7
LOSS_TOL = 1e-5         # kernel-path vs plain-path training loss, relative
# Kernel-path vs plain-path gradients of the training step: max |diff| over
# each tensor's max.  The two paths differ only in the unprojection's
# rounding (~1e-7 of the volume), but at random weights the step amplifies
# rounding: on the CPU the port's and lt_tpu's float64 steps agree to 1e-10
# while float32 moves the gradients by 5e-3 (tests/test_torch_train.py).  So
# REL_TOL is out of reach of float32 here; the kernel path is held to a
# fixed limit twice the largest difference recorded on the card (1.5e-2,
# PERF.md), and its backward alone to REL_TOL at the flagship shapes in the
# [train entry points] phase.
STEP_GRAD_TOL = 3e-2
GRAD_MODULES = ("process_features", "backbone.deconv_layers",
                "volume_net.front_layers")
EVAL_KERNELS = {"float32": ("unproject_agg", "split_bf16", "conv3d_mma_f32",
                             "upsample3d_2x", "max_pool3d_2x"),
                "bfloat16": ("unproject_agg", "conv3d_mma",
                             "upsample3d_2x_mma", "max_pool3d_2x")}
# K2's and K3's body for each activation type; the other never launches
# there.  In float32 every K2 launch follows split_bf16 of its input.
K2 = {"float32": "conv3d_mma_f32", "bfloat16": "conv3d_mma"}
K3 = {"float32": "upsample3d_2x", "bfloat16": "upsample3d_2x_mma"}
K2_PER_FORWARD = 47     # K2 launches per flagship V2V forward, both configs
K3_PER_FORWARD = 5      # K3 launches per flagship V2V forward
TRAIN_KERNELS = ("unproject_agg", "sample_views_t", "sample_views_grad_t")
# [train fixture bf16]: the bfloat16 kernel path's mean distance from the
# plain float32 step (loss; relative L2 of each of GRAD_MODULES' gradients)
# over the plain bfloat16 path's, at most (tests/test_torch_bf16_train.py's
# rule for the port against lt_tpu), over FIX_BF16_ROTATIONS rotations.
BF16_STEP_RATIO = 1.5
FIX_BF16_ROTATIONS = 16
# The C arguments that carry each training kernel's element types.
TRAIN_DTYPE_ARGS = {"unproject_agg": (14,), "sample_views_t": (10, 11),
                    "sample_views_grad_t": (10,)}
ALT_KERNELS = ("split_bf16", "conv3d_mma_f32", "conv3d_mma", "sample_views",
               "sample_views_grad")
# The peak each kernel's bound is taken against (default PEAK_F32_FLOPS).
PEAK_OF = {"conv3d_mma": PEAK_BF16_TC_FLOPS,
           "conv3d_mma_f32": PEAK_BF16_TC_FLOPS,
           "upsample3d_2x_mma": PEAK_BF16_TC_FLOPS}
# bfloat16 tensor-core products per float32 product in the bound of the
# float32 K2 (conv3d_mma_f32): the fewest that compute a float32
# convolution within K2's contract, hi*hi + hi*lo + lo*hi of two parts.
# The body itself sums split_products(k) of them.
F32_PRODUCTS = 3


def split_products(k: int) -> int:
    """bfloat16 products per float32 one that conv3d_mma_f32 sums: those
    of the parts x_i * w_j with i + j < p, p = conv3d.split_parts(k)."""
    from lt_tpu_torch.ops.kernels import conv3d

    p = conv3d.split_parts(k)
    return p * (p + 1) // 2


# The C argument that carries a launch's activation type (default: the
# last one); split_bf16 takes float32 only.
DTYPE_ARG = {"conv3d_mma": 13, "conv3d_mma_f32": 13, "upsample3d_2x": 11,
             "upsample3d_2x_mma": 11, "unproject_agg": 14, "split_bf16": None,
             "max_pool3d_2x": 7}

# The TPU kernels (pallas_call sites) each CUDA kernel replaces.
_K2_SITES = ("lt_tpu/ops/pallas/conv_mp.py:237, :442, "
             "lt_tpu/ops/pallas/res3d.py:742, :950, :1180, "
             "lt_tpu/ops/pallas/conv3d.py:205, "
             "lt_tpu/ops/pallas/res3d_q4.py:245, "
             "lt_tpu/ops/pallas/res3d_folded.py:302")
_K3_SITES = ("lt_tpu/ops/pallas/updown.py:376, :330, "
             "lt_tpu/ops/pallas/res3d.py:1180")
REPLACES = {
    "unproject_agg": "lt_tpu/ops/pallas/unproject.py:427",
    "conv3d_mma": _K2_SITES,
    "conv3d_mma_f32": _K2_SITES,
    "split_bf16": _K2_SITES,
    "upsample3d_2x": _K3_SITES,
    "upsample3d_2x_mma": _K3_SITES,
    "max_pool3d_2x": "lt_tpu/ops/pallas/updown.py:185, :143, "
                     "lt_tpu/ops/pallas/res3d.py:742, :950",
    "sample_views_t": "lt_tpu/ops/pallas/unproject.py:653",
    "sample_views_grad_t": "lt_tpu/ops/pallas/unproject.py:1029",
    "sample_views": "lt_tpu/ops/pallas/unproject.py:548, :581",
    "sample_views_grad": "lt_tpu/ops/pallas/unproject.py:906",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _ms(t) -> str:
    return "n/a" if t is None else f"{t:.3f} ms"


def cuda_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean device time of ``fn`` (CUDA events, after one warm-up call),
    with as many repeats as fit in about ``budget_ms`` (1 to 20)."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = start.elapsed_time(end)
    n = int(max(1, min(20, budget_ms // max(est, 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def launches_kept():
    """Leave every kernel's launch count as it was on entry: capturing a
    CUDA graph calls each wrapper once per captured launch (which counts
    it) and launches nothing then."""
    from lt_tpu_torch.ops.kernels import _build

    saved = dict(_build.LAUNCHES)
    try:
        yield
    finally:
        _build.LAUNCHES.update(saved)


def graph_n(est_ms: float, budget_ms: float = GRAPH_BUDGET_MS) -> int:
    """Calls of ``est_ms`` each that one captured graph holds: about
    ``budget_ms`` of work, 2 to GRAPH_MAX_CALLS."""
    return int(max(2, min(GRAPH_MAX_CALLS, budget_ms // max(est_ms, 1e-3))))


@functools.lru_cache(maxsize=None)
def _capture_stream():
    """The one stream every graph is warmed up and captured on: a cuBLAS
    call on a new stream allocates a workspace that lives as long as the
    process, and would add to the training step's peak memory later."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn) -> float:
    """Mean device time of ``fn`` without host gaps between launches: n
    calls (:func:`graph_n`) captured once as a CUDA graph, replayed
    GRAPH_REPLAYS times between two CUDA events, the span over the calls.
    The capture leaves the launch counts as they were
    (:func:`launches_kept`)."""
    import torch

    n = graph_n(cuda_ms(fn, 0.0))
    graph = torch.cuda.CUDAGraph()
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with launches_kept():
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (GRAPH_REPLAYS * n)


def unaligned(x):
    """A contiguous copy of ``x`` whose base lies one element past a
    16-byte boundary: a kernel with a vector and a scalar instance takes
    the scalar one there."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err, err / max(scale, 1e-30)


def check(name, got, ref, tol=REL_TOL):
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if got.dtype != ref.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype} != {ref.dtype}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err, rel = rel_err(got.float(), ref.float())
    if rel > tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} (rel {rel:.3e})"
                             f" > rel {tol}")
    return err, rel


def conv_flops(b: int, dims, k: int, cin: int, cout: int) -> float:
    """Operations of a 'same' convolution with kernel k over a (b, *dims,
    cin) volume: two per multiply-add, counting only the taps that land
    inside the volume (zero padding needs no product).  Along an axis of
    size s, the (output, tap offset d) pairs inside number
    sum_{|d| <= (k-1)/2} max(0, s - |d|)."""
    h = (k - 1) // 2
    inside = math.prod(sum(max(0, s - abs(d)) for d in range(-h, h + 1))
                       for s in dims)
    return 2.0 * b * inside * cin * cout


def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms (TF32 off), for the
    float32 comparisons of a model's kernel path with its plain path (the
    timed requests run with the defaults): the backbone's ConvTranspose2d
    runs as cuDNN's backward-data, whose default algorithm sums with
    atomics, so that identical forwards differ: the flagship's volumes of
    three identical requests sat 7.9e-5 and 1.14e-4 of their max from the
    plain path's on an H100, over REL_TOL, while K1-K4 are
    bit-reproducible."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def pool_bytes(numel: int, itemsize: int) -> float:
    """Bytes MaxPool3d(2) must move: its input read once, its output (an
    eighth of it) written once."""
    return itemsize * numel * 9 / 8


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Replaying the main path's launches: one case per distinct launch shape
# ---------------------------------------------------------------------------


class Case:
    """One distinct launch of a kernel on the main path: random inputs of
    its shapes, the kernel, its plain version, the library call, and the
    bytes / flops the function needs (``flops``: on the kernel's peak, so
    F32_PRODUCTS times the convolution's for conv3d_mma_f32; ``f32_flops``:
    the function's own, for the CUDA-core bound)."""

    def __init__(self, run, plain, library, nbytes, flops, f32_flops=None):
        self.run, self.plain, self.library = run, plain, library
        self.nbytes, self.flops = nbytes, flops
        self.f32_flops = flops if f32_flops is None else f32_flops
        self.emulation = None
        # Other launch plans of the same kernel, timed beside it: label ->
        # function computing the same values.
        self.variants = {}


def make_case(name, args, geometry, dev, gen):
    import torch
    import torch.nn.functional as F

    from lt_tpu_torch.ops.kernels import conv3d, unproject, updown

    dt = _dtype_of(name, args)
    f = dt.itemsize            # bytes per activation / weight element

    def randn(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    if name in ("conv3d_mma", "conv3d_mma_f32"):
        _, _, _, res_ptr, _, b, sx, sy, sz, cin, cout, k, relu = args[:13]
        out_dt = torch.bfloat16 if args[14] else torch.float32
        x = randn(b, sx, sy, sz, cin)
        w = randn(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5)
        bias = randn(cout, scale=0.1, dtype=torch.float32)
        res = randn(b, sx, sy, sz, cout) if res_ptr else None
        w_lib = w.permute(4, 3, 0, 1, 2).contiguous()
        b_lib = bias.to(dt)
        vox = b * sx * sy * sz
        nbytes = (f * (x.numel() + w.numel()
                       + (vox * cout if res is not None else 0))
                  + 4 * cout + out_dt.itemsize * vox * cout)
        ops = conv_flops(b, (sx, sy, sz), k, cin, cout)
        if name == "conv3d_mma":
            run = lambda: conv3d.conv3d_fused(x, w, bias, res, bool(relu),
                                              out_dt)
        else:       # the launch alone: its input's split is split_bf16's
            parts = conv3d.split_parts(k)
            xs, ws = (conv3d.split_bf16(t, parts) for t in (x, w))
            # Bounded as the float32 function: its float32 operands' bytes
            # (not the parts'), F32_PRODUCTS products per float32 one.
            run = lambda: conv3d.conv3d_split(xs, ws, bias, res,
                                              bool(relu), out_dt)
        case = Case(
            run,
            lambda: conv3d.conv3d_fused_plain(x, w, bias, res, bool(relu),
                                              out_dt),
            lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w_lib, b_lib,
                             padding=(k - 1) // 2),
            nbytes, ops * (F32_PRODUCTS if name == "conv3d_mma_f32" else 1),
            ops)
        if name == "conv3d_mma_f32":
            # The same products summed in float32 F.conv3d: what the
            # kernel's own (tensor-core) accumulation adds to the split's
            # error.
            case.emulation = lambda: conv3d.conv3d_split_plain(
                xs, ws, bias, res, bool(relu), out_dt)
        return case
    if name == "split_bf16":
        n, parts = args[2:4]
        v = randn(n)
        # No one PyTorch call computes the parts (the plain version is a
        # cast and a subtraction per part).  One subtraction per part.
        return Case(lambda: conv3d.split_bf16(v, parts),
                    lambda: conv3d.split_bf16_plain(v, parts), None,
                    (4.0 + 2 * parts) * n, float(parts * n))
    if name in ("upsample3d_2x", "upsample3d_2x_mma"):
        _, _, _, skip_ptr, _, b, sx, sy, sz, cin, cout, _ = args[:12]
        x = randn(b, sx, sy, sz, cin)
        w8 = randn(cin, 8 * cout, scale=cin ** -0.5)
        b8 = randn(cout, scale=0.1, dtype=torch.float32).repeat(8)
        skip = randn(b, 2 * sx, 2 * sy, 2 * sz, cout) if skip_ptr else None
        w_lib = w8.reshape(cin, 2, 2, 2, cout).permute(0, 4, 1, 2, 3)
        w_lib = w_lib.contiguous()
        b_lib = b8[:cout].to(dt)
        out_n = b * 8 * sx * sy * sz * cout

        def library():
            y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w_lib,
                                   b_lib, stride=2).relu_()
            return y if skip is None else y.add_(skip.permute(0, 4, 1, 2, 3))

        return Case(
            lambda: updown.upsample3d_2x(x, w8, b8, skip),
            lambda: updown.upsample3d_2x_plain(x, w8, b8, skip), library,
            f * (x.numel() + w8.numel() + out_n
                 * (2 if skip is not None else 1)) + 4 * b8.numel(),
            2.0 * out_n * cin)
    if name == "max_pool3d_2x":
        b, sx, sy, sz, c = args[2:7]
        x = randn(b, sx, sy, sz, c)
        case = Case(
            lambda: updown.max_pool3d_2x(x),
            lambda: updown.max_pool3d_2x_plain(x),
            lambda: F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2),
            pool_bytes(x.numel(), f), 7.0 * x.numel() / 8)
        if args[8] > 1:     # the scalar instance too, on a base off 16 bytes
            xs = unaligned(x)
            case.variants["scalar instance"] = lambda: updown.max_pool3d_2x(
                xs)
        return case
    if name == "unproject_agg":
        _, _, _, conf_ptr, _, b, v, h, w, c, s, method = args[:12]
        names = {0: "softmax", 1: "sum", 2: "max", 3: "conf"}
        feats = randn(b, v, h, w, c)
        m = geometry(b)
        mask = torch.ones(b, v, device=dev)
        conf = (randn(b, v, c, dtype=torch.float32).abs() if conf_ptr
                else None)
        n = b * s ** 3

        def run(plan=None):
            return unproject.unproject_agg(feats, m, mask, conf,
                                           names[method], s, plan)

        # Ops counted as if every voxel's 4 taps were in the map for every
        # view (the most the data could need); the bytes bound is larger.
        case = Case(
            run,
            lambda: unproject.unproject_agg_plain(feats, m, mask, conf,
                                                  names[method], s),
            None, f * (feats.numel() + n * c) + 4 * (m.numel() + mask.numel()),
            n * v * (30.0 + 8.0 * c + 4.0 * c))
        # The same kernel with and without staged windows (the default
        # plan's choice for this type is the line's own time).
        budget = unproject.AGG_WINDOW
        other = 0 if unproject.unproject_plan(c, s, f).window else budget
        case.variants["windows" if other else "no windows"] = (
            functools.partial(run, unproject.unproject_plan(c, s, f, other)))
        px = unproject.brick_windows(m, s, h, w)[1]
        log(f"  unproject_agg windows at this geometry (4x8x8 bricks, plain "
            f"PyTorch): pixels p50 {px.double().median().item():.0f} max "
            f"{px.max().item()}, {int((px > budget).sum())} of {px.numel()}"
            f" (brick, view) pairs over the {budget}-pixel budget")
        return case
    raise KeyError(name)


# The port's counterparts of the TPU entry points on the main path, and the
# module whose namespace the model calls them through.
ENTRY_POINTS = {
    "unproject_heatmaps_affine": "lt_tpu_torch.models.triangulation",
    "conv3d_mp": "lt_tpu_torch.models.v2v",
    "res3d_chain_fused": "lt_tpu_torch.models.v2v",
    "res3d_block_fused": "lt_tpu_torch.models.v2v",
    "upsample_res3d_fused": "lt_tpu_torch.models.v2v",
}


def record_launches(fn):
    """Run ``fn`` and return every kernel launch it made as
    (entry point, kernel name, C arguments)."""
    import importlib

    from lt_tpu_torch.ops.kernels import _build

    calls, active, saved = [], [], []
    orig = _build.launch

    def recording(kernel, device, argtypes, *args):
        calls.append((active[-1] if active else None, kernel, args))
        return orig(kernel, device, argtypes, *args)

    def tagged(entry, f):
        def g(*a, **k):
            active.append(entry)
            try:
                return f(*a, **k)
            finally:
                active.pop()
        return g

    for entry, modname in ENTRY_POINTS.items():
        mod = importlib.import_module(modname)
        saved.append((mod, entry, getattr(mod, entry)))
        setattr(mod, entry, tagged(entry, getattr(mod, entry)))
    _build.launch = recording
    try:
        fn()
    finally:
        _build.launch = orig
        for mod, entry, f in saved:
            setattr(mod, entry, f)
    return calls


def _dtype_of(name, args):
    """The activation type of a recorded launch: its C dtype argument
    (DTYPE_ARG; K2 has the input's before the output's, then its plan)."""
    import torch

    i = DTYPE_ARG.get(name, -1)
    return torch.bfloat16 if i is not None and args[i] else torch.float32


def _acc(table, key, mult, err, rel, ms, loop_ms, plain_ms, lib_ms, case,
         peak):
    """Add ``mult`` launches of ``case`` to ``table[key]``.  The bound of
    several launches is the sum of each launch's bound (each is its own
    pass over its bytes), on ``peak`` and on the tensor cores."""
    acc = table.setdefault(key, dict(
        launches=0, max_abs_err=0.0, max_rel_err=0.0, ms=0.0, loop_ms=0.0,
        plain_ms=0.0, library_ms=None, nbytes=0.0, flops=0.0,
        tc_bound_ms=0.0, f32_bound_ms=0.0, bound_ms=0.0,
        bound_by={"bytes": 0.0, "operations": 0.0}))
    acc["launches"] += mult
    acc["max_abs_err"] = max(acc["max_abs_err"], err)
    acc["max_rel_err"] = max(acc["max_rel_err"], rel)
    acc["ms"] += mult * ms
    acc["loop_ms"] += mult * loop_ms
    acc["plain_ms"] += mult * plain_ms
    if lib_ms is not None:
        acc["library_ms"] = (acc["library_ms"] or 0.0) + mult * lib_ms
    acc["nbytes"] += mult * case.nbytes
    acc["flops"] += mult * case.flops
    acc["tc_bound_ms"] += mult * bound(case.nbytes, case.flops,
                                       PEAK_BF16_TC_FLOPS)[0]
    acc["f32_bound_ms"] += mult * bound(case.nbytes, case.f32_flops)[0]
    b_ms, b_by = bound(case.nbytes, case.flops, peak)
    acc["bound_ms"] += mult * b_ms
    acc["bound_by"][b_by] += mult * b_ms


def replay(calls, geometry, dev):
    """Hold every distinct main-path launch against its plain version and
    time kernel, plain and library; sum over one forward's launches by
    kernel and by the entry point that issued them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    per_kernel, per_entry, distinct = {}, {}, {}
    for entry, name, args in calls:
        key = (entry, name) + tuple(bool(a) if i in _PTR_SLOTS[name] else a
                                    for i, a in enumerate(args))
        distinct.setdefault(key, [entry, name, args, 0])[3] += 1
    for entry, name, args, mult in distinct.values():
        case = make_case(name, args, geometry, dev, gen)
        tol = (0.0 if name in BIT_EXACT else
               REL_TOL if _dtype_of(name, args) == torch.float32
               else REL_TOL_BF16)
        timer = graph_ms if name in GRAPH_TIMED else cuda_ms
        got, ref = case.run(), case.plain()
        err, rel = check(f"{name}{_shape_str(name, args)}", got, ref, tol)
        variants = ""
        for label, fn in case.variants.items():
            rel_v = check(f"{name} {label}", fn(), ref, tol)[1]
            variants += f"  [{label}: {timer(fn):.4f} ms, rel {rel_v:.3e}]"
        del ref
        emu = ""
        if case.emulation is not None:
            emu = (f"  (rel {rel_err(got, case.emulation())[1]:.3e} from its "
                   f"products summed in float32)")
        del got
        loop_ms = cuda_ms(case.run)
        ms = timer(case.run)
        plain_ms = timer(case.plain)
        lib_ms = None if case.library is None else timer(case.library)
        graphed = (f" as a graph (loop {loop_ms:.4f} ms)"
                   if name in GRAPH_TIMED else "")
        b_ms, _ = bound(case.nbytes, case.flops,
                        PEAK_OF.get(name, PEAK_F32_FLOPS))
        tc = ""
        if PEAK_OF.get(name) == PEAK_BF16_TC_FLOPS:
            tc = (f"  {case.flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f}"
                  f" % of the tensor-core bound")
        if name == "conv3d_mma_f32":
            own = split_products(args[11]) * case.f32_flops
            tc += (f" ({F32_PRODUCTS} products per float32 one; this body "
                   f"sums {split_products(args[11])}: "
                   f"{own / ms / 1e9:.1f} TFLOP/s, bound at them "
                   f"{bound(case.nbytes, own, PEAK_BF16_TC_FLOPS)[0]:.4f} ms;"
                   f" {case.f32_flops / ms / 1e9:.1f} float32 TFLOP/s, "
                   f"CUDA-core bound "
                   f"{bound(case.nbytes, case.f32_flops)[0]:.4f} ms)")
        log(f"  {entry}: {name}{_shape_str(name, args)} x{mult}: "
            f"max_abs_err {err:.3e} rel {rel:.3e}  kernel {ms:.4f} ms"
            f"{graphed}  plain "
            f"{plain_ms:.4f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
            f"{b_ms:.4f} ms{tc}{emu}{variants}")
        for table, k in ((per_kernel, name), (per_entry, entry)):
            _acc(table, k, mult, err, rel, ms, loop_ms, plain_ms, lib_ms,
                 case, PEAK_OF.get(name, PEAK_F32_FLOPS))
        del case
        torch.cuda.empty_cache()
    return per_kernel, per_entry


# Argument slots that are pointers (kept as present / absent in the key).
_PTR_SLOTS = {"conv3d_mma": range(5), "conv3d_mma_f32": range(5),
              "split_bf16": range(2), "upsample3d_2x": range(5),
              "upsample3d_2x_mma": range(5), "max_pool3d_2x": range(2),
              "unproject_agg": range(5)}


def _shape_str(name, args):
    ints = [a for i, a in enumerate(args) if i not in _PTR_SLOTS[name]]
    if name in ("conv3d_mma", "conv3d_mma_f32"):  # shapes, then the plan
        nt, ck, bx, by, bz, nh, smem, grid = ints[10:18]
        parts = f" parts={ints[18]}" if name == "conv3d_mma_f32" else ""
        return (f"({','.join(map(str, ints[:10]))}) plan nt={nt} ck={ck} "
                f"brick={bx}x{by}x{bz} halo_buffers={nh} smem={smem} B "
                f"grid={grid}{parts}")
    if name == "upsample3d_2x_mma":
        nt, kp, per, nsplit, smem, grid = ints[7:]
        return (f"({','.join(map(str, ints[:7]))}) plan nt={nt} kp={kp} "
                f"steps_per_block={per} n_split={nsplit} smem={smem} B "
                f"grid={grid}")
    if name == "upsample3d_2x":
        kp, per, nsplit, smem, grid = ints[7:]
        return (f"({','.join(map(str, ints[:7]))}) plan kp={kp} "
                f"steps_per_block={per} n_split={nsplit} smem={smem} B "
                f"grid={grid}")
    if name == "max_pool3d_2x":
        vec, bx, by, gx, gy, gz = ints[6:]
        return (f"({','.join(map(str, ints[:6]))}) "
                f"{'vector' if vec > 1 else 'scalar'} instance plan "
                f"vec={vec} block={bx}x{by} grid={gx}x{gy}x{gz}")
    if name == "unproject_agg":
        window, smem, grid, chunks = ints[10:]
        return (f"({','.join(map(str, ints[:7]))}) plan window={window} px "
                f"smem={smem} B grid={grid}x{ints[0]}x{chunks}")
    return "(" + ",".join(f"{a:g}" if isinstance(a, float) else str(a)
                          for a in ints) + ")"


# ---------------------------------------------------------------------------
# Entry-point checks: the seven TPU entry points' port counterparts
# ---------------------------------------------------------------------------


def entry_point_checks(batch, geometry, dev, dt=None, tol=REL_TOL):
    """Rows 1-7 at the flagship shapes in type ``dt`` (default float32):
    each port entry point against the composition of plain versions."""
    import torch

    from lt_tpu_torch.ops.kernels import conv_mp, res3d, unproject, updown
    from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused_plain

    gen = torch.Generator(device=dev).manual_seed(2)

    dt = dt or torch.float32

    def randn(*shape, scale=1.0, dtype=None):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype or dt)

    def fb(c):
        """A float32 bias."""
        return randn(c, scale=0.1, dtype=torch.float32)

    def conv_w(k, cin, cout):
        return randn(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5)

    def block(cin, c, proj=False):
        blk = [conv_w(3, cin, c), fb(c), conv_w(3, c, c),
               fb(c)]
        if proj:
            blk.append((randn(cin, c, scale=cin ** -0.5), fb(c)))
        return blk

    def tail(c, out):
        return [(randn(c, c, scale=c ** -0.5), fb(c), True),
                (randn(c, c, scale=c ** -0.5), fb(c), True),
                (randn(c, out, scale=c ** -0.5), fb(out),
                 False)]

    def pw(x, w, b, relu=False):
        return conv3d_fused_plain(x, w.reshape(1, 1, 1, *w.shape), b,
                                  relu=relu)

    def p_block(x, blk):
        y = conv3d_fused_plain(x, blk[0], blk[1], relu=True)
        s = x if len(blk) == 4 else pw(x, *blk[4])
        return conv3d_fused_plain(y, blk[2], blk[3], residual=s, relu=True)

    def p_tail(x, t):
        for w, b, r in t:
            x = pw(x, w, b, r)
        return x

    def p_chain(x, blocks, emit):
        pooled = None
        for i, blk in enumerate(blocks):
            if emit and i == len(blocks) - 1:
                pooled = updown.max_pool3d_2x_plain(x)
            x = p_block(x, blk)
        return (x, pooled) if emit else x

    def run(label, kernel_fn, plain_fn):
        got, ref = kernel_fn(), plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [check(label, g, r, tol) for g, r in zip(got, ref)]
        torch.cuda.synchronize()
        ms, plain_ms = cuda_ms(kernel_fn, 100), cuda_ms(plain_fn, 100)
        log(f"  {label}: max_abs_err {max(e for e, _ in errs):.3e} rel "
            f"{max(r for _, r in errs):.3e}  kernel {ms:.3f} ms  plain "
            f"{plain_ms:.3f} ms")

    b, s, hm = batch, FLAGSHIP["volume"], FLAGSHIP["heatmap"]
    h = s // 2
    feats = randn(b, 4, hm, hm, 32)
    m = geometry(b)
    conf = randn(b, 4, 32, dtype=torch.float32).abs()
    for method in ("softmax", "sum", "max", "conf"):
        for masked in (False, True):
            mask = torch.ones(b, 4, device=dev)
            if masked:
                mask[:, 1] = 0.0
            vc = conf if method == "conf" else None
            run(f"unproject_agg {method} mask={masked}",
                lambda: unproject.unproject_agg(feats, m, mask, vc, method, s),
                lambda: unproject.unproject_agg_plain(feats, m, mask, vc,
                                                      method, s))
    del feats

    x16 = randn(b, s, s, s, 16)
    x32 = randn(b, s, s, s, 32)
    w7, b7 = conv_w(7, 32, 16), fb(16)
    run(f"conv3d_mp k7 32->16 @{s}^3",
        lambda: conv_mp.conv3d_mp(x32, w7, b7, relu=True),
        lambda: conv3d_fused_plain(x32, w7, b7, relu=True))
    front = [block(16, 32, proj=True), block(32, 32), block(32, 32),
             block(32, 32)]
    run(f"res3d_chain_fused front (proj 16->32 + 3) emit_pooled @{s}^3",
        lambda: res3d.res3d_chain_fused(x16, front, emit_pooled=True),
        lambda: p_chain(x16, front, True))
    del x16, front
    h32 = randn(b, h, h, h, 32)
    pair = [block(32, 64, proj=True), block(64, 64)]
    run(f"res3d_chain_fused enc pair (proj 32->64 + 1) emit_pooled @{h}^3",
        lambda: res3d.res3d_chain_fused(h32, pair, emit_pooled=True),
        lambda: p_chain(h32, pair, True))
    deep = randn(b, 2, 2, 2, 128)
    blk = block(128, 128)
    run("res3d_block_fused identity 128 @2^3",
        lambda: res3d.res3d_block_fused(deep, *blk),
        lambda: p_block(deep, blk))
    pblk = block(32, 64, proj=True)
    run(f"res3d_block_fused projection 32->64 @{h}^3",
        lambda: res3d.res3d_block_fused(h32, *pblk[:4], skip_proj=pblk[4]),
        lambda: p_block(h32, pblk))
    t = tail(32, 17)
    blk32 = block(32, 32)
    run(f"res3d_block_fused tail 32->32->32->17 @{h}^3",
        lambda: res3d.res3d_block_fused(h32, *blk32, tail=t),
        lambda: p_tail(p_block(h32, blk32), t))
    h64 = randn(b, h, h, h, 64)
    blk64 = block(64, 64)
    run(f"res3d_block_fused emit_pooled 64 @{h}^3",
        lambda: res3d.res3d_block_fused(h64, *blk64, emit_pooled=True),
        lambda: (p_block(h64, blk64), updown.max_pool3d_2x_plain(h64)))
    w8 = randn(64, 8 * 32, scale=64 ** -0.5)
    b8 = fb(32).repeat(8)
    run(f"upsample_res3d_fused {h}^3x64 -> {s}^3x32 + back_res + tail",
        lambda: res3d.upsample_res3d_fused(h64, w8, b8, x32, [blk32], tail=t),
        lambda: p_tail(p_block(
            updown.upsample3d_2x_plain(h64, w8, b8, x32), blk32), t))
    run(f"max_pool3d_2x {s}^3x32",
        lambda: updown.max_pool3d_2x(x32),
        lambda: updown.max_pool3d_2x_plain(x32))
    run(f"upsample3d_2x {h}^3x64 -> {s}^3x32 + skip",
        lambda: updown.upsample3d_2x(h64, w8, b8, skip=x32),
        lambda: updown.upsample3d_2x_plain(h64, w8, b8, skip=x32))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# NaN and infinities: each kernel keeps them where its plain version does
# ---------------------------------------------------------------------------


def plant(x, gen, count=4):
    """``x`` with NaN, +inf and -inf each at ``count`` random elements (in
    place; returns x)."""
    import torch

    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (3, count), generator=gen,
                        device=x.device)
    for row, v in zip(idx, (math.nan, math.inf, -math.inf)):
        flat[row] = v
    return x


def nonfinite_diff(name, got, ref, tol):
    """Kernel vs plain on inputs with NaN or inf planted (``check`` refuses
    non-finite outputs): NaN exactly where the plain version has NaN, its
    infinities the same, its finite values finite and within ``tol`` of the
    largest finite |plain| (0: bit for bit), and at least one NaN reached.
    Logs the counts; returns ``name`` if the case fails, else None."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        log(f"  {name}: {tuple(got.shape)} {got.dtype} != "
            f"{tuple(ref.shape)} {ref.dtype} -> FAIL")
        return name
    g, r = got.float(), ref.float()
    want_nan = r.isnan()
    nan_g = g.isnan()
    dropped = int((want_nan & ~nan_g).sum())
    added = int((nan_g & ~want_nan).sum())
    inf_r = r.isinf() & ~want_nan
    inf_bad = int((inf_r & (g != r)).sum())
    fin = r.isfinite() & ~want_nan
    both = fin & g.isfinite()
    err = (g[both] - r[both]).abs().max().item() if both.any() else 0.0
    scale = r[fin].abs().max().item() if fin.any() else 0.0
    rel = err / max(scale, 1e-30)
    ok = (not (dropped or added or inf_bad) and rel <= tol
          and bool(want_nan.any()))
    log(f"  {name}: NaN {int(want_nan.sum())} (kernel drops {dropped}, adds "
        f"{added}), inf {int(inf_r.sum())} (kernel differs at {inf_bad}), "
        f"finite {int(fin.sum())}, rel err {rel:.3e} (limit {tol}) -> "
        f"{'ok' if ok else 'FAIL'}")
    return None if ok else name


def offmap_voxels(m, s, h, w):
    """(BV, S^3) bool: the voxels in front of their camera (w > 0) that
    have a bilinear tap off the (h, w) map, as ltk_voxel_taps picks
    them."""
    import torch

    from lt_tpu_torch.ops.kernels import sample

    uvw = sample._project(m, s)
    z = uvw[..., 2]
    z_safe = torch.where(z == 0.0, torch.ones_like(z), z)
    x0 = torch.floor(uvw[..., 0] / z_safe * ((w - 1) / w))
    y0 = torch.floor(uvw[..., 1] / z_safe * ((h - 1) / h))
    return (z > 0) & ((x0 < 0) | (x0 + 1 > w - 1) | (y0 < 0)
                      | (y0 + 1 > h - 1))


def nan_checks(batch, geometry, dev):
    """NaN and inf planted in the inputs of K1-K8, each kernel held to its
    plain version by :func:`nonfinite_diff`: K4 bit for bit at the
    flagship's five pool shapes, both instances and types; K3 and K2 (the
    per-conv ``conv3d_same``, the k = 7 front conv and the fused
    ``res3d_block_fused``) in both types, float32 K2 to true float32; K1's
    four aggregations with NaN features inside the maps and with NaN and
    infinities on their edges, also with a masked view, and its softmax of
    +inf features; K5 and K7 with NaN and infinities on the edges (K5 also
    bfloat16 -> bfloat16); K6 and K8 with NaN and infinities in g at voxels
    with taps off the map, for float32 and bfloat16 g.
    Raises after the phase, naming every case that failed."""
    import torch

    from lt_tpu_torch.ops.kernels import (conv3d, res3d, sample, unproject,
                                          updown)

    gen = torch.Generator(device=dev).manual_seed(6)
    failed = []

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def run(label, kernel_fn, plain_fn, tol):
        got = kernel_fn()
        with deterministic_cudnn():
            ref = plain_fn()
        failed.append(nonfinite_diff(label, got, ref, tol))

    s = FLAGSHIP["volume"]
    for dt, tol in ((torch.float32, REL_TOL), (torch.bfloat16, REL_TOL_BF16)):
        name = str(dt).replace("torch.", "")
        for side, c in ((s, 32), (s // 2, 64), (s // 4, 128), (s // 8, 128),
                        (s // 16, 128)):
            x = plant(randn(batch, side, side, side, c, dtype=dt), gen)
            x[0, :2, :2, :2, 0] = math.nan          # a window all NaN
            x[0, 2:4, :2, :2, 1] = -math.inf        # a window all -inf
            for label, xi in (("vector", x), ("scalar", unaligned(x))):
                run(f"max_pool3d_2x {side}^3x{c} x{batch} {name} {label} "
                    f"instance", lambda: updown.max_pool3d_2x(xi),
                    lambda: updown.max_pool3d_2x_plain(xi), 0.0)
            del x, xi
        for shape, cout, skip in (((2, 8, 8, 8, 128), 128, True),
                                  ((1, 4, 4, 4, 64), 17, False)):
            cin = shape[-1]
            x = plant(randn(*shape, dtype=dt), gen)
            w8 = randn(cin, 8 * cout, scale=cin ** -0.5, dtype=dt)
            b8 = randn(8 * cout, scale=0.1)
            sk = (plant(randn(shape[0], *(2 * d for d in shape[1:4]), cout,
                              dtype=dt), gen) if skip else None)
            run(f"upsample3d_2x {shape} -> {cout} skip={skip} {name}",
                lambda: updown.upsample3d_2x(x, w8, b8, sk),
                lambda: updown.upsample3d_2x_plain(x, w8, b8, sk), tol)
        # K2: in float32 an infinity's bfloat16 parts are (0, 0, inf) (or
        # (0, inf)), and x's last part meets only w's first, so that K2 has
        # true float32's NaN and infinities (the residual is added in
        # float32).
        f32 = dt == torch.float32
        x = plant(randn(2, 16, 16, 16, 32, dtype=dt), gen)
        res = plant(randn(2, 16, 16, 16, 32, dtype=dt), gen)
        w = randn(3, 3, 3, 32, 32, scale=(27 * 32) ** -0.5, dtype=dt)
        bias = randn(32, scale=0.1)
        run(f"conv3d_same 32->32 relu + residual {name}",
            lambda: conv3d.conv3d_same(x, w, bias, relu=True, residual=res),
            lambda: conv3d.conv3d_fused_plain(x, w, bias, res, True), tol)
        xk7 = plant(randn(2, 16, 16, 16, 32, dtype=dt), gen)
        wk7 = randn(7, 7, 7, 32, 16, scale=(343 * 32) ** -0.5, dtype=dt)
        run(f"conv3d_fused k=7 32->16 relu {name} (the front conv's "
            f"{'two-part ' if f32 else ''}instance)",
            lambda: conv3d.conv3d_fused(xk7, wk7, bias[:16], relu=True),
            lambda: conv3d.conv3d_fused_plain(xk7, wk7, bias[:16],
                                              relu=True), tol)
        del xk7, wk7
        x = plant(randn(2, 8, 8, 8, 64, dtype=dt), gen)
        blk = [randn(3, 3, 3, 64, 64, scale=(27 * 64) ** -0.5, dtype=dt),
               randn(64, scale=0.1),
               randn(3, 3, 3, 64, 64, scale=(27 * 64) ** -0.5, dtype=dt),
               randn(64, scale=0.1)]

        def p_block(v):
            y = conv3d.conv3d_fused_plain(v, blk[0], blk[1], relu=True)
            return conv3d.conv3d_fused_plain(y, blk[2], blk[3], residual=v,
                                             relu=True)

        run(f"res3d_block_fused identity 64 @8^3 {name}",
            lambda: res3d.res3d_block_fused(x, *blk), lambda: p_block(x),
            tol if f32 else 2 * tol)
        # K1, K5 and K7: NaN in a patch of each map's interior, then NaN,
        # +inf and -inf on the maps' edges (row 0, the last column, the last
        # row), which the flagship's taps off the map read at their clamped
        # pixels with weight 0 (inf * 0 = NaN, as lt_tpu's sampler), and
        # +inf features inside the maps, whose softmax over views is NaN.
        hm = FLAGSHIP["heatmap"]
        m = geometry(2)
        mask = torch.ones(2, 4, device=dev)
        conf = randn(2, 4, 32).abs()
        interior = randn(2, 4, hm, hm, 32, dtype=dt)
        interior[:, :, hm // 2 - 4:hm // 2 + 4, hm // 2 - 4:hm // 2 + 4,
                 ::3] = math.nan
        edges = randn(2, 4, hm, hm, 32, dtype=dt)
        edges[:, :, 0, :, 0::3] = math.nan
        edges[:, :, :, -1, 1::3] = math.inf
        edges[:, :, -1, :, 2::3] = -math.inf
        pos_inf = randn(2, 4, hm, hm, 32, dtype=dt)
        pos_inf[:, :, hm // 2 - 8:hm // 2 + 8, hm // 2 - 8:hm // 2 + 8,
                1::3] = math.inf
        k1_cases = [(f"{method} NaN features", interior, method)
                    for method in ("softmax", "sum", "max", "conf")]
        k1_cases += [(f"{method} NaN / +-inf on the map edges", edges,
                      method) for method in ("softmax", "sum", "max", "conf")]
        k1_cases.append(("softmax +inf features", pos_inf, "softmax"))
        for label, feats, method in k1_cases:
            vc = conf if method == "conf" else None
            run(f"unproject_agg {label} {name}",
                lambda: unproject.unproject_agg(feats, m, mask, vc, method,
                                                s),
                lambda: unproject.unproject_agg_plain(feats, m, mask, vc,
                                                      method, s), tol)
        # A masked view (view 2 of sample 1) with NaN and infinities on its
        # edges: 'conf' samples it and weighs it by 0 (NaN reaches the
        # voxel, as lt_tpu's aggregation has it); the others leave it out.
        masked = mask.clone()
        masked[1, 2] = 0.0
        for method in ("conf", "softmax", "sum", "max"):
            vc = conf if method == "conf" else None
            run(f"unproject_agg {method} with a masked view, NaN / +-inf on "
                f"its edges {name}",
                lambda: unproject.unproject_agg(edges, m, masked, vc, method,
                                                s),
                lambda: unproject.unproject_agg_plain(edges, m, masked, vc,
                                                      method, s), tol)
        fv, mv = edges.reshape(8, hm, hm, 32), m.reshape(8, 3, 4)
        run(f"sample_views NaN / +-inf on the map edges {name} -> {name}",
            lambda: sample.sample_views(fv, mv, s, dt),
            lambda: sample.sample_views_plain(fv, mv, s, dt), tol)
        f32v = fv.float()
        run(f"sample_views_t NaN / +-inf on the map edges (the {name} "
            f"edges widened to float32)",
            lambda: sample.sample_views_t(f32v, mv, s),
            lambda: sample.sample_views_t_plain(f32v, mv, s), REL_TOL)
        if not f32:
            run(f"sample_views_t NaN / +-inf on the map edges {name} -> "
                f"{name}",
                lambda: sample.sample_views_t(fv, mv, s, out_dtype=dt),
                lambda: sample.sample_views_t_plain(fv, mv, s, dt), tol)
        del interior, edges, pos_inf, fv, f32v
        torch.cuda.empty_cache()
    # K6 and K8: NaN, +inf and -inf in g at voxels with a tap off the map
    # reach dF at the taps' clamped pixels (0 * g), as in the plain
    # versions and lt_tpu's autodiff; behind the camera nothing.
    bv, hm = 4 * TRAIN_BATCH, FLAGSHIP["heatmap"]
    mt = geometry(TRAIN_BATCH).reshape(bv, 3, 4).contiguous()
    shape = (bv, hm, hm, 32)
    g = randn(bv, s ** 3, 32)
    off = offmap_voxels(mt, s, hm, hm)
    for vi in range(bv):
        idx = torch.nonzero(off[vi])[:, 0]
        for i, val in enumerate((math.nan, math.inf, -math.inf)):
            g[vi, idx[i::97][:8], i::3] = val
    log(f"  K6 / K8 cotangents: {int(off.sum())} voxels in front of their "
        f"camera with a tap off the map, {int((~g.isfinite()).sum())} "
        f"values planted")
    for label, gv in (("float32", g), ("bfloat16", g.to(torch.bfloat16))):
        run(f"sample_views_grad NaN / +-inf g off the map ({label} g)",
            lambda: sample.sample_views_grad(gv, mt, shape, s),
            lambda: sample.sample_views_grad_plain(gv, mt, shape, s), REL_TOL)
    gt = g.transpose(1, 2).contiguous()
    for label, gv in (("float32", gt), ("bfloat16", gt.to(torch.bfloat16))):
        run(f"sample_views_grad_t NaN / +-inf g off the map ({label} g)",
            lambda: sample.sample_views_grad_t(gv, mt, shape, s),
            lambda: sample.sample_views_grad_t_plain(gv, mt, shape, s),
            REL_TOL)
    del g, gt, gv, off
    torch.cuda.empty_cache()
    failed = [f for f in failed if f]
    if failed:
        raise AssertionError(f"non-finite inputs: {len(failed)} cases "
                             f"differ from the plain version: {failed}")


# ---------------------------------------------------------------------------
# Training: K5 / K6, the flagship step, the CLI
# ---------------------------------------------------------------------------


def _library_grid(m, s, hm):
    """``F.grid_sample``'s (BV, 1, N, 2) grid of the projected voxels, those
    at w <= 0 moved off the map."""
    import torch

    from lt_tpu_torch.ops.kernels import sample

    uvw = sample._project(m, s)
    w = uvw[..., 2]
    gx = 2.0 * uvw[..., 0] / (w * hm) - 1.0
    gy = 2.0 * uvw[..., 1] / (w * hm) - 1.0
    off_map = torch.full_like(gx, -3.0)[..., None]
    grid = torch.stack([gx, gy], -1).where((w > 0)[..., None], off_map)
    return grid[:, None].contiguous()


def _sampling_inputs(geometry, dev, seed):
    """Features, matrices and the ``F.grid_sample`` yardstick at the
    flagship training shapes (20 views of 96^2 x 32 into 64^3).

    Returns (feats (BV, H, W, C), m (BV, 3, 4), library forward, library
    input gradient taking a (BV, C, 1, N)-shaped cotangent).  The library
    grid is the projected one with voxels at w <= 0 moved off the map."""
    import torch
    import torch.nn.functional as F

    b, s, hm, c = TRAIN_BATCH, FLAGSHIP["volume"], FLAGSHIP["heatmap"], 32
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((b * 4, hm, hm, c), generator=gen, device=dev)
    m = geometry(b).reshape(b * 4, 3, 4).contiguous()
    grid = _library_grid(m, s, hm)
    f_nchw = feats.permute(0, 3, 1, 2).contiguous().requires_grad_()
    lib_out = F.grid_sample(f_nchw, grid, align_corners=True)

    def lib_fwd():
        return F.grid_sample(f_nchw.detach(), grid, align_corners=True)

    def lib_grad(g_lib):
        return torch.autograd.grad(lib_out, f_nchw, g_lib, retain_graph=True)

    return feats, m, gen, lib_fwd, lib_grad


def scatter_plans(kernel, c, s):
    """label -> launch plan of a scatter (K6 or K8): the default budget,
    then direct atomics only."""
    from lt_tpu_torch.ops.kernels import sample

    w = sample.K6_WINDOW
    return {f"pre-reduced in shared memory ({w} px, default)":
            sample.sample_plan(kernel, c, s, w),
            "direct atomics (0 px)": sample.sample_plan(kernel, c, s, 0)}


def _agg_gradient_check(x5, m5, gen, dtype, tol):
    """The fused aggregation's backward (K5, the softmax VJP, K6; in
    bfloat16 as lt_tpu's _agg_bwd) against autograd of the plain
    aggregation on the same ``dtype`` features and cotangent."""
    import torch

    from lt_tpu_torch.ops.kernels import unproject

    b, _, _, _, c = x5.shape
    s = FLAGSHIP["volume"]
    mask = torch.ones(b, 4, device=x5.device)
    cot = torch.randn((b, s ** 3, c), generator=gen,
                      device=x5.device).to(dtype)
    grads = []
    for kernel in (True, False):
        x = x5.detach().to(dtype).clone().requires_grad_()
        out = (unproject.sample_views_agg(x, m5, mask, "softmax", s) if kernel
               else unproject.unproject_agg_plain(x, m5, mask, None,
                                                  "softmax", s))
        (out.float() * cot.float()).sum().backward()
        grads.append(x.grad)
    err, rel = check(f"sample_views_agg {dtype} gradient", *grads, tol)
    log(f"  sample_views_agg softmax gradient in {str(dtype)[6:]} (K1, K5, "
        f"VJP, K6) vs plain autograd: max_abs_err {err:.3e} rel {rel:.3e} "
        f"(limit {tol})")


def train_entry_points(geometry, dev):
    """[train entry points] and [train entry points bf16]: K5 and K6 at the
    flagship training shapes against their plain versions, in float32 at
    REL_TOL and in their bfloat16 instances at [alt entry points]'
    tolerances for K7 / K8 in the same types (K5 into bfloat16, from
    bfloat16 and from float32 features, REL_TOL_BF16; K6 on a bfloat16 g,
    whose dF is float32, REL_TOL and within 1e-5 of K6 on the widened g).
    K6 beside its other launch plan (direct atomics only).  Bit for bit:
    K5 = K7 transposed in each type pair, and = each view's K1 'sum' in
    float32.  The fused aggregation's backward against plain autograd in
    both types.  Kernel, plain and library times (F.grid_sample and its
    input gradient; in bfloat16 on bfloat16 features) and the bound.
    Returns {kernel: {types: row}}."""
    import torch
    import torch.nn.functional as F

    from lt_tpu_torch.ops.kernels import sample, unproject

    t0 = time.perf_counter()
    b, s, hm, c = TRAIN_BATCH, FLAGSHIP["volume"], FLAGSHIP["heatmap"], 32
    bv, n = b * 4, s ** 3
    bf16 = torch.bfloat16
    log(f"[train entry points] K5 / K6 at batch {b}, 4 views, {hm}^2 x {c} "
        f"-> {s}^3, tolerance rel {REL_TOL}")
    feats, m, gen, lib_fwd, lib_grad = _sampling_inputs(geometry, dev, 3)
    shape = tuple(feats.shape)
    f16 = feats.to(bf16)
    f16_nchw = f16.permute(0, 3, 1, 2).contiguous().requires_grad_()
    grid16 = _library_grid(m, s, hm).to(bf16)
    lib16 = F.grid_sample(f16_nchw, grid16, align_corners=True)
    g = torch.randn((bv, c, n), generator=gen, device=dev)
    g16 = g.to(bf16)

    # K5's sample equals K7's transposed, in each type pair, and each
    # view's K1 'sum' in float32, bit for bit: one function of taps, one
    # ltk_tap order.
    for x, out in ((feats, torch.float32), (f16, bf16), (feats, bf16)):
        if not torch.equal(sample.sample_views_t(x, m, s, out_dtype=out),
                           sample.sample_views(x, m, s, out)
                           .transpose(1, 2)):
            raise AssertionError(f"sample_views_t {x.dtype} -> {out} != "
                                 f"sample_views transposed")
    k5 = sample.sample_views_t(feats, m, s)
    x5, m5 = feats.reshape(b, 4, hm, hm, c), m.reshape(b, 4, 3, 4)
    for view in range(4):
        mask = torch.zeros(b, 4, device=dev)
        mask[:, view] = 1.0
        one = unproject.unproject_agg(x5, m5, mask, None, "sum", s)
        if not torch.equal(one, k5.reshape(b, 4, c, n)[:, view]
                           .transpose(1, 2)):
            raise AssertionError(f"unproject_agg 'sum' of view {view} != "
                                 f"sample_views_t")
    log("  sample_views_t == sample_views transposed (float32, bfloat16 -> "
        "bfloat16, float32 -> bfloat16) and == unproject_agg 'sum' of each "
        "view: bit for bit")
    del k5, one
    _agg_gradient_check(x5, m5, gen, torch.float32, REL_TOL)
    _agg_gradient_check(x5, m5, gen, bf16, REL_TOL_BF16)
    torch.cuda.empty_cache()

    k5_plan = {"taps from device memory (default)":
               sample.sample_plan("sample_views_t", c, s)}
    k6_plans = scatter_plans("sample_views_grad_t", c, s)
    cases = [("sample_views_t", "float32", k5_plan,
              lambda plan: sample.sample_views_t(feats, m, s, plan),
              lambda: sample.sample_views_t_plain(feats, m, s), lib_fwd,
              4.0 * (feats.numel() + m.numel() + bv * c * n), REL_TOL,
              None),
             ("sample_views_grad_t", "float32", k6_plans,
              lambda plan: sample.sample_views_grad_t(g, m, shape, s, plan),
              lambda: sample.sample_views_grad_t_plain(g, m, shape, s),
              lambda: lib_grad(g[:, :, None]),
              4.0 * (g.numel() + m.numel() + feats.numel()), REL_TOL, None)]
    cases += [("sample_views_t", f"{tname} -> bfloat16", k5_plan,
               lambda plan, x=x: sample.sample_views_t(x, m, s, plan, bf16),
               lambda x=x: sample.sample_views_t_plain(x, m, s, bf16),
               library, x.element_size() * x.numel() + 4.0 * m.numel()
               + 2.0 * bv * c * n, REL_TOL_BF16, None)
              for tname, x, library in (
                  ("bfloat16", f16, lambda: F.grid_sample(
                      f16_nchw.detach(), grid16, align_corners=True)),
                  ("float32", feats, lib_fwd))]
    cases.append((
        "sample_views_grad_t", "g bfloat16", k6_plans,
        lambda plan: sample.sample_views_grad_t(g16, m, shape, s, plan),
        lambda: sample.sample_views_grad_t_plain(g16, m, shape, s),
        lambda: torch.autograd.grad(lib16, f16_nchw, g16[:, :, None],
                                    retain_graph=True),
        2.0 * g16.numel() + 4.0 * (m.numel() + feats.numel()), REL_TOL,
        lambda: sample.sample_views_grad_t(g16.float(), m, shape, s)))
    # Operations counted as if all four taps of every voxel were in the map
    # (projection ~30, then 2 per tap and channel); the bytes bound is ten
    # times larger and decides either way.
    ops = bv * n * (30.0 + 8.0 * c)
    rows = {"sample_views_t": {}, "sample_views_grad_t": {}}
    for name, types, plans, run, plain, library, nbytes, tol, wide in cases:
        if types != "float32" and not any(
                t != "float32" for r in rows.values() for t in r):
            log(f"[train entry points bf16] K5 bfloat16 -> bfloat16 and "
                f"float32 -> bfloat16, K6 on a bfloat16 g, the same shapes; "
                f"tolerance rel {REL_TOL_BF16} (bfloat16 output), {REL_TOL} "
                f"(K6's float32 dF)")
        ref = plain()
        widened = wide() if wide else None
        b_ms, b_by = bound(nbytes, ops)
        times = {}
        for label, plan in plans.items():
            got = run(plan)
            err, rel = check(f"{name} {types} {label}", got, ref, tol)
            if widened is not None:
                check(f"{name} {types} {label} vs the widened g", got,
                      widened, 1e-5)
            del got
            times[label] = (cuda_ms(functools.partial(run, plan)), err, rel)
        del ref, widened
        torch.cuda.synchronize()
        plain_ms, lib_ms = cuda_ms(plain), cuda_ms(library)
        (ms, err, rel), *_ = times.values()
        log(f"  {name}({bv},{hm},{hm},{c},S={s}) {types}: plain "
            f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound {b_ms:.4f} "
            f"ms ({b_by})")
        for label, (t, e, r) in times.items():
            log(f"    {label} (plan {plans[label]}): kernel {t:.4f} ms, "
                f"{100 * b_ms / t:.1f} % of the bound, {lib_ms / t:.2f}x "
                f"the library; max_abs_err {e:.3e} rel {r:.3e}")
        rows[name][types] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if len(times) > 1 and types != "float32":
            rows[name][types]["plans"] = {k: t for k, (t, _, _) in
                                          times.items()}
    del feats, f16, f16_nchw, lib16, g, g16, cases, lib_fwd, lib_grad
    torch.cuda.empty_cache()
    log(f"  the phases took {time.perf_counter() - t0:.1f} s")
    return rows


def alt_entry_points(batch, geometry, dev):
    """The TPU entry points with no caller on the model paths, at the
    flagship shapes: ``conv3d_same`` and the three ``res3d_block_*`` at
    64^3 (float32 and bfloat16), ``sample_views_affine`` forward and
    backward (K7, K8) at the training shapes.  Each is held to its plain
    version and must launch its kernel.  Returns (launches by kernel, the
    K7 / K8 rows)."""
    import torch
    import torch.nn.functional as F

    from lt_tpu_torch.ops.kernels import (_build, conv3d, conv_mp,
                                          res3d_folded, res3d_q4, sample)
    from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    b, s = batch, FLAGSHIP["volume"]
    vox = b * s ** 3
    totals = dict.fromkeys(_build.KERNELS, 0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def run(label, kernels, fn, plain, library, nbytes, flops, tol):
        """One entry point: check, count its launches, time, bound."""
        kernels = (kernels,) if isinstance(kernels, str) else kernels
        _build.reset_launches()
        got = fn()
        made = {k: v for k, v in _build.LAUNCHES.items() if v}
        if set(made) != set(kernels):
            raise AssertionError(f"{label}: launched {made}, want "
                                 f"{kernels}")
        for k, v in made.items():
            totals[k] += v
        kernel, n_launch = "+".join(made), sum(made.values())
        err, rel = check(label, got, plain(), tol)
        del got
        torch.cuda.synchronize()
        ms, plain_ms = cuda_ms(fn, 100), cuda_ms(plain, 100)
        lib_ms = cuda_ms(library, 100)
        # The tensor-core K2 bodies: bounded on the tensor cores' peak, the
        # float32 one with F32_PRODUCTS products per float32 one; the
        # CUDA-core bound of the function's own operations beside it.
        peak = max(PEAK_OF.get(k, PEAK_F32_FLOPS) for k in made)
        b_ms, b_by = bound(nbytes, flops * (F32_PRODUCTS if "conv3d_mma_f32"
                                            in made else 1), peak)
        cc_ms, _ = bound(nbytes, flops)
        log(f"  {label}: {n_launch} launches of {kernel}, max_abs_err "
            f"{err:.3e} rel {rel:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound {b_ms:.4f} "
            f"ms ({b_by}; on the CUDA cores {cc_ms:.4f} ms)")
        torch.cuda.empty_cache()
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    def lib_conv(x, w, bias):
        """F.conv3d on the NCDHW view, cuDNN in x's type."""
        k = w.shape[0]
        return F.conv3d(x.permute(0, 4, 1, 2, 3),
                        w.permute(4, 3, 0, 1, 2), bias.to(x.dtype),
                        padding=(k - 1) // 2)

    def pw(w):
        return w.reshape(1, 1, 1, *w.shape)

    for dt, tol in ((torch.float32, REL_TOL), (torch.bfloat16, REL_TOL_BF16)):
        name = str(dt).replace("torch.", "")
        f32 = dt == torch.float32
        k2 = (K2[name], "split_bf16") if f32 else K2[name]
        f = dt.itemsize

        def cw(k, cin, cout):
            return randn(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5,
                         dtype=dt)

        def fb(c):
            return randn(c, scale=0.1)

        x32 = randn(b, s, s, s, 32, dtype=dt)
        x16 = randn(b, s, s, s, 16, dtype=dt)
        w, bias = cw(3, 32, 32), fb(32)
        w_lib = w.permute(4, 3, 0, 1, 2).contiguous()
        c3 = conv_flops(b, (s, s, s), 3, 32, 32)   # one k=3 32->32 conv
        for residual in (None, x32):
            run(f"conv3d_same 32->32 @{s}^3 x{b} {name} residual="
                f"{residual is not None}", k2,
                lambda: conv3d.conv3d_same(x32, w, bias, relu=True,
                                           residual=residual),
                lambda: conv3d_fused_plain(x32, w, bias, residual, True),
                lambda: F.conv3d(x32.permute(0, 4, 1, 2, 3), w_lib,
                                 bias.to(dt), padding=1),
                f * (vox * 32 * (3 if residual is not None else 2)
                     + w.numel()) + 4 * 32, c3, tol)

        # Res3D blocks: two k=3 convs, a 1x1x1 projection or a per-voxel
        # tail; bytes as one fused pass (input read once, output written
        # once), the bound the TPU's whole-block kernels aim at.
        proj = (cw(3, 16, 32), fb(32), cw(3, 32, 32), fb(32))
        ws, bs = randn(16, 32, scale=0.25, dtype=dt), fb(32)
        same = (cw(3, 32, 32), fb(32), cw(3, 32, 32), fb(32))
        tail = [(randn(32, 32, scale=32 ** -0.5, dtype=dt), fb(32), True),
                (randn(32, 32, scale=32 ** -0.5, dtype=dt), fb(32), True),
                (randn(32, 17, scale=32 ** -0.5, dtype=dt), fb(17), False)]

        def plain_block(x, prm, skip=None, tl=()):
            y = conv3d_fused_plain(x, prm[0], prm[1], relu=True)
            sk = x if skip is None else conv3d_fused_plain(x, pw(skip[0]),
                                                           skip[1])
            y = conv3d_fused_plain(y, prm[2], prm[3], residual=sk, relu=True)
            for wt, bt, relu in tl:
                y = conv3d_fused_plain(y, pw(wt), bt, relu=relu)
            return y

        def lib_block(x, prm, skip=None, tl=()):
            y = lib_conv(lib_conv(x, prm[0], prm[1]).permute(0, 2, 3, 4, 1),
                         prm[2], prm[3])
            if skip is not None:
                lib_conv(x, pw(skip[0]), skip[1])
            for wt, bt, _ in tl:
                y = lib_conv(y.permute(0, 2, 3, 4, 1), pw(wt), bt)
            return y

        def weights(prm, skip=None, tl=()):
            return (sum(t.numel() for t in prm[::2])
                    + (skip[0].numel() if skip else 0)
                    + sum(t[0].numel() for t in tl))

        proj_flops = (conv_flops(b, (s, s, s), 3, 16, 32) + c3
                      + 2.0 * vox * 16 * 32)
        tail_flops = 2 * c3 + 2.0 * vox * (2 * 32 * 32 + 32 * 17)
        block_tol = tol if dt == torch.float32 else 2 * tol
        for sp in (2, 4):
            run(f"res3d_block_mp s={sp} 16->32 projection @{s}^3 x{b} {name}",
                k2,
                lambda: conv_mp.res3d_block_mp(x16, *proj, skip_proj=(ws, bs),
                                               s=sp),
                lambda: plain_block(x16, proj, (ws, bs)),
                lambda: lib_block(x16, proj, (ws, bs)),
                f * (vox * (16 + 32) + weights(proj, (ws, bs))) + 4 * 96,
                proj_flops, block_tol)
        run(f"res3d_block_q4 32 + tail 32->32->32->17 @{s}^3 x{b} {name}",
            k2,
            lambda: res3d_q4.res3d_block_q4(x32, *same, tail=tail),
            lambda: plain_block(x32, same, tl=tail),
            lambda: lib_block(x32, same, tl=tail),
            f * (vox * (32 + 17) + weights(same, tl=tail)) + 4 * 145,
            tail_flops, block_tol)
        run(f"res3d_block_folded 32 @{s}^3 x{b} {name}", k2,
            lambda: res3d_folded.res3d_block_folded(x32, *same),
            lambda: plain_block(x32, same),
            lambda: lib_block(x32, same),
            f * (vox * 64 + weights(same)) + 4 * 64,
            2 * c3, block_tol)
        del x32, x16, w, w_lib, proj, same, tail
        torch.cuda.empty_cache()

    # sample_views_affine: forward K7 in three type pairs, backward K8 for
    # float32 and bfloat16 g, at the training shapes.
    hm, c, n = FLAGSHIP["heatmap"], 32, s ** 3
    feats, m, gen5, lib_fwd, lib_grad = _sampling_inputs(geometry, dev, 5)
    bv = feats.shape[0]
    shape = tuple(feats.shape)
    f16 = feats.to(torch.bfloat16)
    f16_nchw = f16.permute(0, 3, 1, 2).contiguous()
    grid16 = _library_grid(m, s, hm).to(torch.bfloat16)
    ops = bv * n * (30.0 + 8.0 * c)
    f32, bf16 = torch.float32, torch.bfloat16

    def tname(dt):
        return str(dt).replace("torch.", "")

    # K7's bits: float32 features, and bfloat16 ones widened, give K5's
    # sample transposed; a bfloat16 output is the float32 one rounded once.
    k7 = sample.sample_views(feats, m, s)
    if not torch.equal(k7, sample.sample_views_t(feats, m, s)
                       .transpose(1, 2)):
        raise AssertionError("sample_views != sample_views_t transposed")
    if not torch.equal(sample.sample_views(f16, m, s), sample.sample_views_t(
            f16.float(), m, s).transpose(1, 2)):
        raise AssertionError("sample_views of bfloat16 features != "
                             "sample_views_t of the widened ones transposed")
    if not torch.equal(sample.sample_views(feats, m, s, bf16), k7.to(bf16)):
        raise AssertionError("sample_views' bfloat16 output != its float32 "
                             "output rounded")
    log("  sample_views == sample_views_t transposed (float32 features, and "
        "bfloat16 ones widened), its bfloat16 output == its float32 output "
        "rounded: bit for bit")
    del k7
    torch.cuda.empty_cache()
    k7_rows = {}
    # The library: F.grid_sample on the same features (float32 -> float32;
    # bfloat16 in, bfloat16 out, for bfloat16 features).
    for x, tout, library in (
            (feats, f32, lib_fwd), (feats, bf16, lib_fwd),
            (f16, f32, lambda: F.grid_sample(f16_nchw, grid16,
                                             align_corners=True))):
        label = f"{tname(x.dtype)} -> {tname(tout)}"
        k7_rows[label] = run(
            f"sample_views_affine forward ({bv},{hm},{hm},{c},S={s}) {label}",
            "sample_views",
            lambda x=x, tout=tout: sample.sample_views_affine(x, m, s, tout),
            lambda x=x, tout=tout: sample.sample_views_plain(x, m, s, tout),
            library, x.element_size() * x.numel() + 4.0 * m.numel()
            + tout.itemsize * bv * n * c, ops,
            REL_TOL if x.dtype == tout == f32 else REL_TOL_BF16)
    rows = {"sample_views": k7_rows.pop("float32 -> float32")}
    rows["sample_views"]["types"] = k7_rows

    # K8 for float32 and bfloat16 g: the backward through autograd, then the
    # kernel alone on each plan, against the plain scatter and K6 on the
    # transposed (widened) cotangent.
    g32 = torch.randn((bv, n, c), generator=gen5, device=dev)
    k6 = sample.sample_views_grad_t(g32.transpose(1, 2).contiguous(), m,
                                    shape, s)
    k8_rows = {}
    for tg in (f32, bf16):
        g = g32.to(tg)
        if tg == bf16:
            k6 = sample.sample_views_grad_t(
                g.float().transpose(1, 2).contiguous(), m, shape, s)

        def backward(g=g, tg=tg):
            x = feats.detach().requires_grad_()
            sample.sample_views_affine(x, m, s, tg).backward(g)
            return x.grad

        def plain(g=g):
            return sample.sample_views_grad_plain(g, m, shape, s)

        # The library: grid_sample's input gradient of the float32 graph on
        # the (widened) cotangent, dF in float32 as K8's.
        r = run(f"sample_views_affine backward ({bv},{n},{c}) -> "
                f"({bv},{hm},{hm},{c}) g {tname(tg)}",
                ("sample_views", "sample_views_grad"), backward, plain,
                lambda g=g: lib_grad(g.float().transpose(1, 2)[:, :, None]),
                g.element_size() * g.numel() + 4.0 * (m.numel()
                                                      + feats.numel()),
                ops, REL_TOL)
        ref = plain()
        r["plans"] = {}
        for label, plan in scatter_plans("sample_views_grad", c, s).items():
            got = sample.sample_views_grad(g, m, shape, s, plan)
            err, rel = check(f"sample_views_grad g {tname(tg)} {label}", got,
                             ref)
            _, rel6 = check(f"sample_views_grad g {tname(tg)} {label} vs "
                            f"sample_views_grad_t", got, k6, 1e-5)
            del got
            t = cuda_ms(lambda plan=plan: sample.sample_views_grad(
                g, m, shape, s, plan))
            log(f"    sample_views_grad alone, g {tname(tg)}, {label} (plan "
                f"{plan}): kernel {t:.4f} ms, {100 * r['bound_ms'] / t:.1f} "
                f"% of the bound, {r['library_ms'] / t:.2f}x the library; "
                f"max_abs_err {err:.3e} rel {rel:.3e}, rel {rel6:.3e} from "
                f"sample_views_grad_t")
            if not r["plans"]:      # the default: the kernel's own row
                r.update(ms=t, max_abs_err=err)
            r["plans"][label] = t
        k8_rows[f"g {tname(tg)}"] = r
        del g, ref
        torch.cuda.empty_cache()
    rows["sample_views_grad"] = k8_rows.pop("g float32")
    rows["sample_views_grad"]["types"] = k8_rows
    del feats, f16, f16_nchw, grid16, g32, k6, lib_fwd, lib_grad
    torch.cuda.empty_cache()
    return totals, rows


def _loss_and_grads(model, batch, config, criterion):
    """One training forward and backward of ``model`` on ``batch``: (the
    loss, the gradients of GRAD_MODULES' parameters less the biases that
    feed a BatchNorm, whose gradient is 0 in exact arithmetic)."""
    from lt_tpu_torch.engine import steps
    from lt_tpu_torch.models.batchnorm import bn_fed_biases

    model.train()
    model.zero_grad(set_to_none=True)
    out = steps.model_outputs(model, batch, config)
    total, _ = steps.compute_losses(criterion, config, out, batch)
    total.backward()
    skip = bn_fed_biases(model)
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()
             if k.startswith(GRAD_MODULES) and k not in skip}
    return total.item(), grads


def _grad_l2(grads, ref, prefix):
    """Relative L2 distance of ``grads`` from ``ref`` over the tensors
    under ``prefix``."""
    names = [k for k in ref if k.startswith(prefix)]
    return (sum(float((grads[k] - ref[k]).double().square().sum())
                for k in names)
            / sum(float(ref[k].double().square().sum())
                  for k in names)) ** 0.5


def _timed_steps(model, optimizer, criterion, config, batch,
                 n=TRAIN_STEPS):
    """``n`` optimizer steps after the launch counts were set to 0:
    (median ms, all ms, losses, launches, peak GiB since the counts were
    set to 0)."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import steps
    from lt_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(steps.train_step(model, optimizer, criterion, config,
                                       batch)["total_loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return float(np.median(times)), times, losses, launches, peak


def train_flagship(dev):
    """The flagship training step: kernel path vs plain path from the same
    weights and rotations, then TRAIN_STEPS timed optimizer steps on the
    kernel path.  Returns the kernel launches of those steps and (ms,
    peak GiB)."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import factory, steps
    from lt_tpu_torch.utils import cfg
    from lt_tpu_torch.utils.example import example_train_batch

    b = TRAIN_BATCH
    config = cfg.load_config(str(ROOT / TRAIN_YAML),
                             {"model.backbone.init_weights": False})
    log(f"[train flagship] {TRAIN_YAML}: RN-{config.model.backbone.num_layers}"
        f" {config.image_shape[0]}^2 x4 views, {config.model.volume_size}^3,"
        f" {config.model.volume_aggregation_method}, batch {b}, f32, seed 0, "
        f"random weights (the pretrained backbone is not in the repository)")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in example_train_batch(
        b, config.image_shape[0], 17, seed=3).items()}
    criterion = factory.make_criterion(config)

    model = factory.make_model(config, device=dev, seed=0)
    plain = factory.make_model(config, device=dev, use_kernels=False, seed=0)
    plain.load_state_dict(model.state_dict())
    loss_k, grads_k = _loss_and_grads(model, batch, config, criterion)
    loss_p, grads_p = _loss_and_grads(plain, batch, config, criterion)
    del plain
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  loss kernel {loss_k:.7f} plain {loss_p:.7f} rel {loss_rel:.3e}")
    if loss_rel > LOSS_TOL:
        raise AssertionError(f"training loss: kernel path {loss_k} vs plain "
                             f"{loss_p} (rel {loss_rel:.3e} > {LOSS_TOL})")
    for prefix in GRAD_MODULES:
        names = [k for k in grads_p if k.startswith(prefix)]
        worst = max(rel_err(grads_k[k], grads_p[k])[1] for k in names)
        l2 = _grad_l2(grads_k, grads_p, prefix)
        log(f"  gradients of {prefix}: kernel vs plain max rel err "
            f"{worst:.3e} (limit {STEP_GRAD_TOL}), relative L2 {l2:.3e}")
        if worst > STEP_GRAD_TOL:
            raise AssertionError(f"{prefix} gradients: rel {worst:.3e} > "
                                 f"{STEP_GRAD_TOL}")

    optimizer = factory.make_optimizer(config, model)
    steps.train_step(model, optimizer, criterion, config, batch)  # warm-up
    ms, times, losses, launches, peak = _timed_steps(
        model, optimizer, criterion, config, batch)
    log(f"  launches over {TRAIN_STEPS} steps: {launches}")
    for k in TRAIN_KERNELS:
        if launches[k] != TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN_STEPS} training steps, want one "
                                 f"per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    log(f"  train step ms (median of {TRAIN_STEPS}): {ms:.1f}  all: "
        f"{[round(t, 1) for t in times]}  samples/s: {b / ms * 1e3:.2f}  "
        f"peak memory {peak:.2f} GiB  losses {[round(x, 4) for x in losses]}")
    del model, optimizer, batch
    torch.cuda.empty_cache()
    return launches, (ms, peak)


def train_flagship_bf16(dev, smi, f32):
    """[train flagship bf16]: TRAIN_YAML with bf16: true at its batch, seed
    0, random weights.  A recorded step launches K1, K5 and K6 once each,
    with bfloat16 element types (their C type arguments), and no other
    kernel; then BF16_TRAIN_STEPS timed steps: finite losses, ms,
    samples/s and peak memory beside the float32 step's ``f32`` (ms, GiB)
    of this run.  (The bfloat16 step's distance from float32 is held on
    the trained fixture, [train fixture bf16]: at random weights both
    paths lie 0.5-1.4 from float32.)  Returns the timed steps'
    launches."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import factory, steps
    from lt_tpu_torch.utils import cfg
    from lt_tpu_torch.utils.example import example_train_batch

    t0 = time.perf_counter()
    b = TRAIN_BATCH
    config = cfg.load_config(str(ROOT / TRAIN_YAML), {
        "model.backbone.init_weights": False, "bf16": True})
    log(f"[train flagship bf16] {TRAIN_YAML} + bf16: true, batch {b}, seed "
        f"0, random weights")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in example_train_batch(
        b, config.image_shape[0], 17, seed=3).items()}
    criterion = factory.make_criterion(config)
    model = factory.make_model(config, device=dev, seed=0)
    optimizer = factory.make_optimizer(config, model)
    calls = record_launches(lambda: steps.train_step(     # the warm-up step
        model, optimizer, criterion, config, batch))
    for k, idx in TRAIN_DTYPE_ARGS.items():
        found = [args for _, name, args in calls if name == k]
        if len(found) != 1 or not all(found[0][i] == 1 for i in idx):
            raise AssertionError(f"[train flagship bf16] {k}: launches "
                                 f"{len(found)}, type arguments "
                                 f"{[[a[i] for i in idx] for a in found]}, "
                                 f"want one launch in bfloat16")
    if any(name not in TRAIN_KERNELS for _, name, _ in calls):
        raise AssertionError(f"[train flagship bf16] other kernels launched: "
                             f"{sorted({n for _, n, _ in calls})}")
    log(f"  the recorded step: {', '.join(TRAIN_KERNELS)} one launch each, "
        f"bfloat16 (type arguments {TRAIN_DTYPE_ARGS})")
    ms, times, losses, launches, peak = _timed_steps(
        model, optimizer, criterion, config, batch, BF16_TRAIN_STEPS)
    for k in TRAIN_KERNELS:
        if launches[k] != BF16_TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{BF16_TRAIN_STEPS} bfloat16 training "
                                 f"steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite bfloat16 training loss: {losses}")
    log(f"  bf16 train step ms (median of {BF16_TRAIN_STEPS}): {ms:.1f}  "
        f"all: {[round(t, 1) for t in times]}  samples/s: "
        f"{b / ms * 1e3:.2f}  peak memory {peak:.2f} GiB  losses "
        f"{[round(x, 4) for x in losses]}; float32 in this run {f32[0]:.1f} "
        f"ms, {b / f32[0] * 1e3:.2f} samples/s, {f32[1]:.2f} GiB; on {smi}; "
        f"the phase took {time.perf_counter() - t0:.1f} s")
    del model, optimizer, batch
    torch.cuda.empty_cache()
    return launches


def _fixture_train_batch(dev):
    """The trained fixture's training batch: two poses of the synthetic set
    (128^2, 4 views), as tests/test_torch_bf16_train.py builds it."""
    import numpy as np
    import torch

    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset

    ds = SyntheticMultiViewDataset(n_samples=2, n_views=4, image_size=128)
    val = [ds[i] for i in range(2)]
    kp = np.stack([x["keypoints_3d"] for x in val]).astype(np.float32)
    batch = {"images": np.stack([np.stack(x["images"]) for x in val]),
             "proj_matrices": np.stack([np.stack(x["proj_matrices"])
                                        for x in val]),
             "keypoints_3d": kp, "keypoints_validity": kp[..., 3:].copy(),
             "view_mask": np.ones((2, 4), np.float32)}
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in batch.items()}


def _fixture_unprojection(model, batch, config):
    """The inputs the kernel path's fused aggregation gets in one training
    forward of ``model``: (features, m, view_mask, grid size)."""
    from lt_tpu_torch.engine import steps
    from lt_tpu_torch.ops.kernels import unproject

    seen = []
    agg = unproject.sample_views_agg

    def spy(features, m, view_mask, method, grid_size):
        seen.append((features.detach(), m.detach(), view_mask.detach(),
                     grid_size))
        return agg(features, m, view_mask, method, grid_size)

    unproject.sample_views_agg = spy
    try:
        steps.model_outputs(model, batch, config)
    finally:
        unproject.sample_views_agg = agg
    return seen[0]


def train_fixture_bf16(dev):
    """[train fixture bf16]: the bfloat16 training step on the committed
    trained fixture (SYNTH_YAML, vol_rn18_synth.npz: RN-18, 128^2, 4 views,
    32^3, batch 2), where rounding is not amplified a million-fold as at
    random weights.  For each of FIX_BF16_ROTATIONS pairs of cuboid
    rotations (seeded): the plain float32 step (use_kernels=False) as the
    reference, the kernel path and the plain path in bfloat16.  The means
    over the rotations of each distance (the loss, relative; each of
    GRAD_MODULES' gradients, relative L2): the kernel path's at most
    BF16_STEP_RATIO times the plain path's.  One step's distance is one
    draw of a wide distribution (on an H100 each path's process_features
    gradient lay 0.07-0.40 from float32 across the 16 rotations, the
    kernel path the further in 7), so the rule holds means.  The kernel path
    launches K1, K5 and K6 once a step.  Then, on the fixture's own
    features: K1's bfloat16 volume and the fused backward's dF for a
    bfloat16 cotangent against their plain versions on the CPU
    (REL_TOL_BF16)."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import factory
    from lt_tpu_torch.ops.kernels import _build, unproject
    from lt_tpu_torch.utils import cfg
    from lt_tpu_torch.utils.weights import (load_npz_variables,
                                            volumetric_state_dict)

    t0 = time.perf_counter()
    over = {"model.init_weights": False, "model.backbone.init_weights": False}
    configs = {dt: cfg.load_config(str(ROOT / SYNTH_YAML),
                                   {**over, "bf16": dt == "bfloat16"})
               for dt in ("float32", "bfloat16")}
    state = volumetric_state_dict(load_npz_variables(
        str(ROOT / "tests" / "fixtures" / "vol_rn18_synth.npz")), 18)
    paths = {"plain float32": ("float32", False),
             "kernel bfloat16": ("bfloat16", "fused"),
             "plain bfloat16": ("bfloat16", False)}
    models = {label: factory.make_model(configs[dt], device=dev,
                                        use_kernels=kernels)
              for label, (dt, kernels) in paths.items()}
    criterion = factory.make_criterion(configs["float32"])
    batch = _fixture_train_batch(dev)
    rotations = np.random.RandomState(0).uniform(
        0.0, 2.0 * np.pi, (FIX_BF16_ROTATIONS, 2)).astype(np.float32)
    log(f"[train fixture bf16] {SYNTH_YAML} on vol_rn18_synth.npz, batch 2, "
        f"{FIX_BF16_ROTATIONS} rotation pairs (seed 0): the kernel path and "
        f"the plain path in bfloat16 against the plain float32 step")
    what = ("loss",) + GRAD_MODULES
    dist = {"kernel bfloat16": [], "plain bfloat16": []}
    _build.reset_launches()
    for rot in rotations:
        batch["rotation_thetas"] = torch.from_numpy(rot).to(dev)
        res = {}
        for label, model in models.items():
            model.load_state_dict(state)      # the fixture's statistics too
            res[label] = _loss_and_grads(model, batch,
                                         configs[paths[label][0]], criterion)
        loss32, grads32 = res.pop("plain float32")
        for label, (loss, grads) in res.items():
            if not (np.isfinite(loss) and all(bool(g.isfinite().all())
                                              for g in grads.values())):
                raise AssertionError(f"[train fixture bf16] {label}: "
                                     f"non-finite loss or gradients")
            dist[label].append([abs(loss - loss32) / abs(loss32)] + [
                _grad_l2(grads, grads32, prefix) for prefix in GRAD_MODULES])
    launches = {k: _build.LAUNCHES[k] for k in TRAIN_KERNELS}
    if any(n != FIX_BF16_ROTATIONS for n in launches.values()):
        raise AssertionError(f"[train fixture bf16] launches {launches} in "
                             f"{FIX_BF16_ROTATIONS} kernel-path steps")
    for i, name in enumerate(what):
        k, p = (np.asarray(dist[label])[:, i] for label in
                ("kernel bfloat16", "plain bfloat16"))
        log(f"  {name}: mean distance from the plain float32 step, kernel "
            f"path {k.mean():.4e}, plain path {p.mean():.4e} (ratio "
            f"{k.mean() / p.mean():.3f}, limit {BF16_STEP_RATIO}); per "
            f"rotation kernel {np.round(k, 4).tolist()} plain "
            f"{np.round(p, 4).tolist()}")
        if k.mean() > BF16_STEP_RATIO * p.mean():
            raise AssertionError(f"[train fixture bf16] {name}: the kernel "
                                 f"path's mean {k.mean():.4e} from float32, "
                                 f"the plain path's {p.mean():.4e}")

    # K1 and the fused backward on the fixture's own features, card
    # against the CPU's plain versions.
    model = models["kernel bfloat16"]
    model.load_state_dict(state)
    features, m, view_mask, s = _fixture_unprojection(
        model, batch, configs["bfloat16"])
    cot = torch.randn((features.shape[0], s ** 3, features.shape[-1]),
                      generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    got = []
    for d in (dev, torch.device("cpu")):
        x = features.to(d).clone().requires_grad_()
        out = unproject.sample_views_agg(x, m.to(d), view_mask.to(d),
                                         "softmax", s)
        out.backward(cot.to(d))
        got.append((out.detach().cpu(), x.grad.cpu()))
    for i, name in enumerate(("K1 volume", "fused backward dF")):
        err, rel = check(f"[train fixture bf16] {name}", got[0][i],
                         got[1][i], REL_TOL_BF16)
        log(f"  {name} on the fixture's features, card vs the CPU's plain "
            f"versions: max_abs_err {err:.3e} rel {rel:.3e} (limit "
            f"{REL_TOL_BF16})")
    del models, model, features, got
    torch.cuda.empty_cache()
    log(f"  the phase took {time.perf_counter() - t0:.1f} s")


def train_cli(dev):
    """lt_tpu_torch.engine.train.run on the synthetic config: one epoch
    (finite losses, a checkpoint), then a resumed run that continues."""
    import tempfile

    import numpy as np

    from lt_tpu_torch.engine import checkpoint as ckpt
    from lt_tpu_torch.engine.train import run

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as logdir:
        t0 = time.perf_counter()
        metric = run(str(ROOT / SYNTH_YAML), logdir + "/a", max_epochs=1,
                     device=dev)
        secs = time.perf_counter() - t0
        exp = next(Path(logdir, "a").iterdir())
        lines = [json.loads(x) for x in open(exp / "metrics.jsonl")]
        train = [x["total_loss"] for x in lines if x["tag"] == "train"]
        if len(train) != 8 or not np.isfinite(train + [metric]).all():
            raise AssertionError(f"CLI epoch: {len(train)} train records, "
                                 f"losses {train}, metric {metric}")
        latest = ckpt.latest_epoch_dir(str(exp / "checkpoints"))
        if latest is None or not (Path(latest) / ckpt.STATE_FILE).is_file():
            raise AssertionError("CLI epoch wrote no checkpoint")
        run(str(ROOT / SYNTH_YAML), logdir + "/b", max_epochs=2,
            resume_dir=str(exp), device=dev)
        exp_b = next(Path(logdir, "b").iterdir())
        steps_b = [json.loads(x)["step"] for x in open(exp_b / "metrics.jsonl")
                   if json.loads(x)["tag"] == "train"]
        if steps_b != list(range(8, 16)):
            raise AssertionError(f"resumed run's steps {steps_b}, want 8-15")
        log(f"[train cli] {SYNTH_YAML}: epoch 0 in {secs:.1f} s, train "
            f"total_loss {train[0]:.3f} -> {train[-1]:.3f}, val MPJPE rel "
            f"{metric:.2f} mm, checkpoint {Path(latest).name}; resumed at "
            f"step {steps_b[0]} and ran epoch 1")


# ---------------------------------------------------------------------------
# The algebraic and RANSAC families (no kernel of the port on their path)
# ---------------------------------------------------------------------------


def device_kernels(fn):
    """(kernel launches, summed device ms) of one call of ``fn`` as
    ``torch.profiler`` records them, or (None, None) where it records no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        return None, None
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def _no_kernel_launched(what):
    """Raise if any kernel of the port was launched since the counts were
    last set to 0: the algebraic and RANSAC paths have none."""
    from lt_tpu_torch.ops.kernels import _build

    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"{what} launched kernels of the port: "
                             f"{launched}")


def _timed_requests(net, images, proj, n):
    """``n`` requests after one warm-up: (outputs, host ms of each)."""
    import torch

    net(images, proj)
    times, outs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(net(images, proj))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return outs, times


def _finite(what, out, shapes):
    for name, shape in shapes.items():
        t = getattr(out, name)
        if tuple(t.shape) != shape or not bool(t.isfinite().all()):
            raise AssertionError(f"{what} {name}: {tuple(t.shape)} (want "
                                 f"{shape}), finite "
                                 f"{bool(t.isfinite().all())}")


def alg_flagship(dev, smi, images, proj):
    """[alg]: AlgebraicTriangulationNet at the flagship width (RN-152,
    384^2, 4 views, 17 joints, confidences), seeded random weights, in
    float32 (TF32 off) and bf16: true, REQUESTS timed requests each after
    the launch counts were set to 0: shapes, finite outputs, no kernel of
    the port launched; 2D keypoints within ALG_KP2D_PX of a float64
    soft-argmax of the request's own heatmaps, 3D keypoints within
    ALG_KP3D_MM of the float64 numpy DLT of its own 2D keypoints and
    confidences; the DLT's launches and device time."""
    import numpy as np
    import torch

    from lt_tpu_torch.models.triangulation import AlgebraicTriangulationNet
    from lt_tpu_torch.ops import geometry
    from lt_tpu_torch.ops.kernels import _build

    b, v = images.shape[:2]
    fl = FLAGSHIP
    f32 = AlgebraicTriangulationNet(num_joints=17, num_layers=fl["layers"],
                                    device=dev, seed=0)
    raw = {}
    f32.backbone.final_layer.register_forward_hook(
        lambda mod, args, out: raw.__setitem__("heatmaps", out))
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        net = f32
        if dt == torch.bfloat16:
            net = AlgebraicTriangulationNet(
                num_joints=17, num_layers=fl["layers"], device=dev,
                compute_dtype=dt)
            net.load_state_dict(f32.state_dict())
            net.backbone.final_layer.register_forward_hook(
                lambda mod, args, out: raw.__setitem__("heatmaps", out))
        _build.reset_launches()
        outs, times = _timed_requests(net, images, proj, REQUESTS)
        _no_kernel_launched(f"the algebraic model ({name})")
        out = outs[-1]
        _finite(f"[alg] {name}", out, {
            "keypoints_3d": (b, 17, 3), "keypoints_2d": (b, v, 17, 2),
            "heatmaps": (b, v, 17, fl["heatmap"], fl["heatmap"]),
            "confidences": (b, v, 17)})
        ms = float(np.median(times))
        log(f"[alg] AlgebraicTriangulationNet RN-{fl['layers']} "
            f"{fl['image']}^2 x{v} views, 17 joints, confidences, {name}, "
            f"batch {b}, seed 0, on {smi}: request ms (median of "
            f"{REQUESTS}) {ms:.1f}  all {[round(t, 1) for t in times]}  "
            f"frames/s {b / ms * 1e3:.2f}; kernels of the port launched: 0")
        # 2D: the float64 soft-argmax of the last request's heatmaps, the
        # backbone's times the multiplier as the model forms them in
        # float32, as lt_tpu does (random weights give logits up to ~1000,
        # where that product's rounding alone moves a keypoint by more
        # than ALG_KP2D_PX: printed as "exact product").
        heat = raw["heatmaps"].float()
        idx = torch.arange(fl["heatmap"], dtype=torch.float64, device=dev)

        def soft_argmax64(logits):
            p = torch.softmax(logits.reshape(b, v, 17, -1), -1).reshape(
                b, v, 17, fl["heatmap"], fl["heatmap"])
            xy = torch.stack([(p.sum(-2) * idx).sum(-1),
                              (p.sum(-1) * idx).sum(-1)], -1)
            return (out.keypoints_2d.double()
                    - xy * (fl["image"] / fl["heatmap"])).abs().max().item()

        err2d = soft_argmax64((heat * 100.0).double())
        err2d_exact = soft_argmax64(heat.double() * 100.0)
        # 3D: the numpy DLT (float64 SVD) of each point, its views' rows
        # weighted by the confidences (each view's matrix scaled).
        kp2d = out.keypoints_2d.double().cpu().numpy()
        conf = out.confidences.double().cpu().numpy()
        pm = proj.double().cpu().numpy()
        ref3d = np.array([[geometry.triangulate_point_dlt_np(
            conf[i, :, j, None, None] * pm[i], kp2d[i, :, j])
            for j in range(17)] for i in range(b)])
        err3d = np.abs(out.keypoints_3d.double().cpu().numpy()
                       - ref3d).max(-1)
        dist = np.linalg.norm(ref3d, axis=-1)
        near = dist < ALG_NEAR_MM
        near_err = err3d[near].max() if near.any() else math.inf
        far_rel = (err3d / dist)[~near].max() if (~near).any() else 0.0
        log(f"  keypoints_2d max |model - float64 soft-argmax| {err2d:.3e} "
            f"px (limit {ALG_KP2D_PX}; of the exact product "
            f"{err2d_exact:.3e} px, heatmaps up to "
            f"{heat.abs().max().item():.2f}); keypoints_3d vs the float64 numpy "
            f"DLT: {int(near.sum())} of {near.size} points within "
            f"{ALG_NEAR_MM:.0f} mm of the rig's centre, max {near_err:.3e} "
            f"mm (limit {ALG_KP3D_MM}); the rest (up to {dist.max():.0f} "
            f"mm) max {far_rel:.3e} of their distance (limit "
            f"{ALG_FAR_REL})")
        if (err2d > ALG_KP2D_PX or not near_err <= ALG_KP3D_MM
                or far_rel > ALG_FAR_REL):
            raise AssertionError(f"[alg] {name}: 2D {err2d:.3e} px, 3D "
                                 f"{near_err:.3e} mm, far {far_rel:.3e}")
        del outs, out
    # The DLT alone on the last request's keypoints and confidences.
    kp2d, conf = f32(images, proj)[1:4:2]

    def dlt():
        return geometry.triangulate_batch_dlt(proj, kp2d, conf)

    n, busy = device_kernels(dlt)
    log(f"  DLT (8-sweep Jacobi, {b} x 17 points, eager): "
        f"{_ms(cuda_ms(dlt))} a request on CUDA events; torch.profiler: "
        f"{n if n is not None else 'not measured'} kernel launches, "
        f"{_ms(busy)} of device time, on {smi}")
    del f32, net
    torch.cuda.empty_cache()


def ransac_flagship(dev, smi, images, proj):
    """[ransac]: RANSACTriangulationNet with direct optimization at the
    flagship width, batch 8, float32: REQUESTS timed requests, shapes and
    finite outputs, no kernel of the port launched; the RANSAC stage's
    device time beside the backbone's; then a planted case on the flagship
    rig (8 x 17 points within 400 mm, view 2 moved 200 px): every point
    back within RANSAC_PLANT_MM."""
    import numpy as np
    import torch

    from lt_tpu_torch.models.triangulation import (RANSACTriangulationNet,
                                                   ransac_triangulate)
    from lt_tpu_torch.ops import geometry
    from lt_tpu_torch.ops.kernels import _build

    b, v = images.shape[:2]
    fl = FLAGSHIP
    net = RANSACTriangulationNet(num_joints=17, num_layers=fl["layers"],
                                 direct_optimization=True, device=dev,
                                 seed=0)
    _build.reset_launches()
    outs, times = _timed_requests(net, images, proj, REQUESTS)
    _no_kernel_launched("the RANSAC model")
    out = outs[-1]
    _finite("[ransac]", out, {"keypoints_3d": (b, 17, 3),
                              "keypoints_2d": (b, v, 17, 2),
                              "confidences": (b, v, 17)})
    ms = float(np.median(times))
    flat = images.reshape((b * v,) + images.shape[2:]).permute(0, 3, 1, 2)
    with torch.no_grad():
        backbone_ms = cuda_ms(lambda: net.backbone(flat))
    pts = out.keypoints_2d.transpose(1, 2)
    pm = proj[:, None].expand(b, 17, v, 3, 4)

    def stage():
        return ransac_triangulate(pm, pts, direct_optimization=True)

    n, busy = device_kernels(stage)
    log(f"[ransac] RANSACTriangulationNet RN-{fl['layers']} {fl['image']}^2"
        f" x{v} views, 17 joints, direct optimization, float32, batch {b}, "
        f"seed 0, on {smi}: request ms (median of {REQUESTS}) {ms:.1f}  all "
        f"{[round(t, 1) for t in times]}  frames/s {b / ms * 1e3:.2f}; "
        f"backbone {backbone_ms:.3f} ms, RANSAC stage {_ms(cuda_ms(stage))} "
        f"on CUDA events (torch.profiler: "
        f"{n if n is not None else 'not measured'} kernel launches, "
        f"{_ms(busy)} of device time); kernels of the port launched: 0")
    # The planted case.
    gen = np.random.RandomState(5)
    pts3d = torch.from_numpy(gen.uniform(-400, 400, (b, 17, 3)).astype(
        np.float32)).to(dev)
    planted = geometry.project_points(proj, pts3d[:, None])  # (B, V, J, 2)
    planted[:, 2] += 200.0
    rec = ransac_triangulate(pm, planted.transpose(1, 2),
                             direct_optimization=True)
    err = (rec - pts3d).abs().max().item()
    log(f"  planted: {b} x 17 points within 400 mm, view 2 moved 200 px: "
        f"recovered within {err:.3e} mm (limit {RANSAC_PLANT_MM})")
    if not err <= RANSAC_PLANT_MM:
        raise AssertionError(f"[ransac] planted points {err:.3e} mm off")
    del net, outs, out
    torch.cuda.empty_cache()


def alg_fixture(dev, smi):
    """[alg fixture]: the trained RN-18 backbone fixture in the algebraic
    model without confidences and in RANSAC, on 8 validation poses of the
    port's synthetic data (128^2): float32 on the card within
    ALG_FIX_F32_MM of the same model on the CPU; bfloat16 against float32:
    the rel MPJPE within FIX_BF16_MEAN_MM, and the algebraic model's
    per-joint distances within FIX_ALG_BF16_MEAN_MM / FIX_ALG_BF16_MAX_MM
    (mean / max)."""
    import numpy as np
    import torch

    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
    from lt_tpu_torch.models.triangulation import (AlgebraicTriangulationNet,
                                                   RANSACTriangulationNet)
    from lt_tpu_torch.ops.kernels import _build
    from lt_tpu_torch.utils.weights import load_backbone_npz

    fix = str(ROOT / "tests" / "fixtures" / "backbone_rn18_synth.npz")
    ds = SyntheticMultiViewDataset(n_samples=8, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    val = [ds[i] for i in range(len(ds))]
    images = torch.from_numpy(np.stack([np.stack(s["images"]) for s in val])
                              .astype(np.float32))
    proj = torch.from_numpy(np.stack([np.stack(s["proj_matrices"])
                                      for s in val]).astype(np.float32))
    families = {"alg": lambda **kw: AlgebraicTriangulationNet(
        num_joints=17, num_layers=18, use_confidences=False, **kw),
        "ransac": lambda **kw: RANSACTriangulationNet(
            num_joints=17, num_layers=18, **kw)}
    for family, build in families.items():
        kps = {}
        for where, dt in (("cpu", torch.float32), ("cuda", torch.float32),
                          ("cuda", torch.bfloat16)):
            net = build(device=dev if where == "cuda" else "cpu",
                        compute_dtype=dt)
            load_backbone_npz(net, fix, 18)
            on = dev if where == "cuda" else "cpu"
            _build.reset_launches()
            with deterministic_cudnn():
                kps[where, dt] = net(images.to(on),
                                     proj.to(on)).keypoints_3d.cpu()
            _no_kernel_launched(f"[alg fixture] {family}")
            del net
        f32 = kps["cuda", torch.float32]
        err = (f32 - kps["cpu", torch.float32]).abs().max().item()
        d = (kps["cuda", torch.bfloat16] - f32).norm(dim=-1).flatten()
        mpjpe = {k: ds.evaluate(v.numpy())[0] for k, v in kps.items()}
        dm = abs(mpjpe["cuda", torch.bfloat16] - mpjpe["cuda", torch.float32])
        per_joint = (f"limits {FIX_ALG_BF16_MEAN_MM} / {FIX_ALG_BF16_MAX_MM}"
                     if family == "alg" else "not held: hard argmax")
        log(f"[alg fixture] {family} on backbone_rn18_synth.npz, 8 "
            f"validation poses, 128^2, on {smi}: float32 card vs CPU "
            f"{err:.3e} mm (limit {ALG_FIX_F32_MM}); bfloat16 vs float32 "
            f"mean {d.mean().item():.3f} p95 {d.quantile(0.95).item():.3f} "
            f"max {d.max().item():.3f} mm ({per_joint}); rel MPJPE float32 "
            f"{mpjpe['cuda', torch.float32]:.2f} mm, bfloat16 "
            f"{mpjpe['cuda', torch.bfloat16]:.2f} mm (difference limit "
            f"{FIX_BF16_MEAN_MM})")
        bad = (err > ALG_FIX_F32_MM or not bool(d.isfinite().all())
               or dm > FIX_BF16_MEAN_MM)
        if family == "alg":
            bad |= (d.mean().item() > FIX_ALG_BF16_MEAN_MM
                    or d.max().item() > FIX_ALG_BF16_MAX_MM)
        if bad:
            raise AssertionError(f"[alg fixture] {family} outside its limits")
    torch.cuda.empty_cache()


def alg_train(dev, smi):
    """[alg train]: the training step of ALG_TRAIN_YAML (alg_train_step),
    then ALG_TINY_YAML one epoch through the CLI's ``run`` and a resume.
    Returns the step's (ms, peak GiB)."""
    import tempfile

    import numpy as np

    from lt_tpu_torch.engine import checkpoint as ckpt
    from lt_tpu_torch.engine.train import run

    f32 = alg_train_step(dev, smi)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as logdir:
        t0 = time.perf_counter()
        metric = run(str(ROOT / ALG_TINY_YAML), logdir + "/a", max_epochs=1,
                     device=dev)
        secs = time.perf_counter() - t0
        exp = next(Path(logdir, "a").iterdir())
        train = [json.loads(x)["total_loss"] for x in open(
            exp / "metrics.jsonl") if json.loads(x)["tag"] == "train"]
        latest = ckpt.latest_epoch_dir(str(exp / "checkpoints"))
        if (len(train) != ALG_TINY_STEPS
                or not np.isfinite(train + [metric]).all() or latest is None):
            raise AssertionError(f"[alg train] CLI epoch: {len(train)} "
                                 f"records, metric {metric}, checkpoint "
                                 f"{latest}")
        run(str(ROOT / ALG_TINY_YAML), logdir + "/b", max_epochs=2,
            resume_dir=str(exp), device=dev)
        exp_b = next(Path(logdir, "b").iterdir())
        steps_b = [json.loads(x)["step"] for x in open(exp_b / "metrics.jsonl")
                   if json.loads(x)["tag"] == "train"]
        if steps_b != list(range(ALG_TINY_STEPS, 2 * ALG_TINY_STEPS)):
            raise AssertionError(f"[alg train] resumed steps {steps_b}")
        log(f"  {ALG_TINY_YAML}: epoch 0 in {secs:.1f} s on {smi}, train "
            f"total_loss {train[0]:.3f} -> {train[-1]:.3f}, val MPJPE rel "
            f"{metric:.2f} mm, checkpoint {Path(latest).name}; resumed at "
            f"step {steps_b[0]} and ran epoch 1")
    return f32


def alg_train_step(dev, smi, dtype="float32", f32=None):
    """The training step of ALG_TRAIN_YAML at its batch (8), seeded random
    weights, in ``dtype``: [alg train] in float32, [alg train bf16] with
    bf16: true beside ``f32`` (the float32 step's ms, peak GiB of this
    run).  The median of TRAIN_STEPS (bfloat16: BF16_TRAIN_STEPS) timed
    steps after a warm-up, samples/s and peak memory; finite losses and
    float32 gradients of the float32 parameters, the parameters moved, no
    kernel of the port launched.  Returns (ms, peak GiB)."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import factory, steps
    from lt_tpu_torch.utils import cfg
    from lt_tpu_torch.utils.example import example_train_batch

    t0 = time.perf_counter()
    bf16 = dtype == "bfloat16"
    what = "[alg train bf16]" if bf16 else "[alg train]"
    config = cfg.load_config(str(ROOT / ALG_TRAIN_YAML),
                             {"model.backbone.init_weights": False,
                              "bf16": bf16})
    b = config.opt.batch_size
    model = factory.make_model(config, device=dev, seed=0)
    optimizer = factory.make_optimizer(config, model)
    criterion = factory.make_criterion(config)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in example_train_batch(
        b, config.image_shape[0], 17, seed=3).items()}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps.train_step(model, optimizer, criterion, config, batch)  # warm-up
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads or not all(bool(g.isfinite().all())
                            and g.dtype == torch.float32 for g in grads):
        raise AssertionError(f"{what} missing, non-finite or not float32 "
                             f"gradients")
    moved = sum(not torch.equal(p, before[k])
                for k, p in model.named_parameters())
    ms, times, losses, _, peak = _timed_steps(
        model, optimizer, criterion, config, batch,
        BF16_TRAIN_STEPS if bf16 else TRAIN_STEPS)
    _no_kernel_launched(f"the algebraic training step{' (bf16)' * bf16}")
    log(f"{what} {ALG_TRAIN_YAML}{' + bf16: true' * bf16}: "
        f"RN-{config.model.backbone.num_layers} {config.image_shape[0]}^2 x4 "
        f"views, confidences, batch {b}, "
        f"{'bfloat16' if bf16 else 'float32'}, seed 0, random weights, on "
        f"{smi}: step ms (median of {len(times)}) {ms:.1f}  all "
        f"{[round(t, 1) for t in times]}  samples/s {b / ms * 1e3:.2f}  peak "
        f"memory {peak:.2f} GiB  losses {[round(x, 3) for x in losses]}; "
        f"{moved} of {len(before)} parameter tensors moved in the first step"
        + (f"; float32 in this run {f32[0]:.1f} ms, {f32[1]:.2f} GiB; the "
           f"phase took {time.perf_counter() - t0:.1f} s" if bf16 else ""))
    if not np.isfinite(losses).all() or moved < len(before) // 2:
        raise AssertionError(f"{what} losses {losses}, {moved} tensors "
                             f"moved")
    del model, optimizer, batch, before, grads
    torch.cuda.empty_cache()
    return ms, peak


# ---------------------------------------------------------------------------
# Datasets on disk: small Human3.6M and CMU Panoptic trees from a seed
# ---------------------------------------------------------------------------

H36M_SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
H36M_ACTIONS = ("Directions-1", "Directions-2", "Walking-1", "Walking-2")
H36M_CAMERAS = ("54138969", "55011271", "58860488", "60457274")
PANOPTIC_CAMERAS = ("00_00", "00_06", "00_12", "00_18")
# A standing pose (mm, z up, pelvis at the origin): Human3.6M's 17 joints
# in the reference labels' order, and CMU Panoptic's COCO19 joints.
H36M_POSE = (
    (-150, 0, -880), (-150, 0, -480), (-130, 0, 0), (130, 0, 0),
    (150, 0, -480), (150, 0, -880), (0, 0, 0), (0, 0, 480), (0, 0, 600),
    (0, 0, 760), (-420, 0, 200), (-330, 0, 380), (-180, 0, 520),
    (180, 0, 520), (330, 0, 380), (420, 0, 200), (0, 30, 680))
COCO19_POSE = (
    (0, 0, 600), (0, 30, 680), (0, 0, 0), (180, 0, 520), (330, 0, 380),
    (420, 0, 200), (130, 0, 0), (150, 0, -480), (150, 0, -880),
    (-180, 0, 520), (-330, 0, 380), (-420, 0, 200), (-130, 0, 0),
    (-150, 0, -480), (-150, 0, -880), (40, 60, 700), (60, 30, 690),
    (-40, 60, 700), (-60, 30, 690))


def _ring_cameras(n, radius, height, focal, size, seed):
    """``n`` pinhole cameras (R, t in the world's units, K) on a ring of
    ``radius`` at ``height``, each looking at the origin, a (width,
    height) ``size`` frame."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n + rng.uniform(-0.2, 0.2)
        c = np.array([radius * np.cos(a), radius * np.sin(a), height])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        K = np.array([[focal, 0, size[0] / 2], [0, focal, size[1] / 2],
                      [0, 0, 1]])
        cams.append((R, -R @ c, K))
    return cams


def _project(points, cam):
    R, t, K = cam
    uvw = (K @ (R @ points.T + t[:, None])).T
    return uvw[:, :2] / uvw[:, 2:]


def _poses(template, n, rng, spread):
    """``n`` poses: the template turned about z, moved by up to
    ``spread`` in x and y and each joint by a few cm."""
    import numpy as np

    base = np.asarray(template, np.float64)
    out = []
    for _ in range(n):
        a = rng.uniform(0, 2 * np.pi)
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]])
        shift = np.array([*rng.uniform(-spread, spread, 2), 900.0])
        out.append(base @ rz.T + shift + rng.normal(0, 30, base.shape))
    return np.stack(out)


def _jpeg_writer():
    """(name, write(path, bgr uint8)) of the JPEG encoder present: cv2,
    else PIL."""
    try:
        import cv2

        return (f"cv2 {cv2.__version__}", lambda path, im: cv2.imwrite(
            path, im, [cv2.IMWRITE_JPEG_QUALITY, 90]))
    except ImportError:
        from PIL import Image, __version__

        return (f"PIL {__version__}", lambda path, im: Image.fromarray(
            im[..., ::-1]).save(path, quality=90))


def _frame(background, uv, rng):
    """A frame: the camera's background with a disc at each joint."""
    import numpy as np

    im = background.copy()
    h, w = im.shape[:2]
    r = max(2, w // 100)
    for x, y in uv:
        x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
        y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.ogrid[y0:y1, x0:x1]
        im[y0:y1, x0:x1][(xx - x) ** 2 + (yy - y) ** 2 <= r * r] = \
            rng.randint(0, 256, 3)
    return im


def _background(h, w, rng):
    """Smooth seeded noise, as a photograph's low frequencies."""
    import numpy as np

    coarse = rng.randint(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(
        np.float32)
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    c = coarse
    im = ((1 - fy) * ((1 - fx) * c[y0][:, x0] + fx * c[y0][:, x0 + 1])
          + fy * ((1 - fx) * c[y0 + 1][:, x0] + fx * c[y0 + 1][:, x0 + 1]))
    return (im + rng.normal(0, 6, im.shape)).clip(0, 255).astype(np.uint8)


def write_h36m_tree(root, seed=0, frame=1000, n_test=47, n_train=5):
    """A Human3.6M tree in the layout ``lt_tpu_torch.data.human36m`` reads
    (the reference's labels ``.npy`` and ``processed/`` frames), from
    ``seed``: subjects S1, S5-S9, S11; two actions of two trials each; four
    cameras on a ring at 5 m; ``n_test`` rows of S9 and S11 and
    ``n_train`` rows of S1, S5-S8, one image per row and camera at
    ``frame`` x ``frame`` (JPEG, with whichever encoder is present); each
    bbox the square hull of the row's joints projected into its view; the
    test rows' view 1 empty in their row 3 (a missing view); and the
    algebraic predictions of the test rows (ground truth + 20 mm of
    noise, under shuffled ``indexes``) as ``pred_results_path``.  Returns
    the paths and the encoder's name."""
    import os
    import pickle

    import numpy as np

    rng = np.random.RandomState(seed)
    cams = _ring_cameras(4, 5000.0, 1500.0, 1.15 * frame, (frame, frame),
                         seed)
    cameras = np.empty((len(H36M_SUBJECTS), 4), dtype=[
        ("R", np.float32, (3, 3)), ("t", np.float32, (3, 1)),
        ("K", np.float32, (3, 3)), ("dist", np.float32, 5)])
    for s in range(len(H36M_SUBJECTS)):
        for c, (R, t, K) in enumerate(cams):
            cameras[s, c] = (R, t[:, None], K, np.zeros(5))
    subjects = ([H36M_SUBJECTS[i % 5] for i in range(n_train)]
                + [("S9", "S11")[i % 2] for i in range(n_test)])
    table = np.empty(len(subjects), dtype=[
        ("subject_idx", np.int8), ("action_idx", np.int8),
        ("frame_idx", np.int16), ("keypoints", np.float32, (17, 3)),
        ("bbox_by_camera_tlbr", np.int16, (4, 4))])
    poses = _poses(H36M_POSE, len(subjects), rng, 400.0)
    counters = {}
    for i, subject in enumerate(subjects):
        action = i % len(H36M_ACTIONS)
        key = (subject, action)
        counters[key] = counters.get(key, -1) + 1
        boxes = []
        for c, cam in enumerate(cams):
            uv = _project(poses[i], cam)
            box = (uv.min(0) + uv.max(0)) / 2
            half = 0.6 * (uv.max(0) - uv.min(0)).max()
            left, top = (box - half).astype(int)
            side = int(2 * half)
            boxes.append((top, left, top + side, left + side))
        if i == n_train + 3:
            boxes[1] = (0, 0, 0, 0)
        table[i] = (H36M_SUBJECTS.index(subject), action,
                    5 * counters[key], poses[i], boxes)
    labels = {"subject_names": list(H36M_SUBJECTS),
              "action_names": list(H36M_ACTIONS),
              "camera_names": list(H36M_CAMERAS), "cameras": cameras,
              "table": table}
    os.makedirs(root, exist_ok=True)
    labels_path = os.path.join(root, "human36m-multiview-labels.npy")
    np.save(labels_path, labels, allow_pickle=True)

    encoder, write = _jpeg_writer()
    h36m_root = os.path.join(root, "processed")
    backgrounds = [_background(frame, frame, rng) for _ in cams]
    for row in table:
        subject = H36M_SUBJECTS[row["subject_idx"]]
        for c, cam in enumerate(cams):
            d = os.path.join(h36m_root, subject,
                             H36M_ACTIONS[row["action_idx"]],
                             "imageSequence-undistorted", H36M_CAMERAS[c])
            os.makedirs(d, exist_ok=True)
            im = _frame(backgrounds[c], _project(
                row["keypoints"].astype(np.float64), cam), rng)
            write(os.path.join(d, "img_%06d.jpg" % (row["frame_idx"] + 1)),
                  im)
    test = table[n_train:]["keypoints"]
    perm = rng.permutation(n_test)
    pred = {"keypoints_3d": (test + rng.normal(0, 20, test.shape))[perm]
            .astype(np.float32), "indexes": perm}
    pred_path = os.path.join(root, "human36m_alg_val.pkl")
    with open(pred_path, "wb") as f:
        pickle.dump(pred, f)
    return {"h36m_root": h36m_root, "labels_path": labels_path,
            "pred_results_path": pred_path, "encoder": encoder}


def h36m_overrides(tree, split="val"):
    """``run``'s overrides that point a Human3.6M config's split at a
    tree of :func:`write_h36m_tree`."""
    return {f"dataset.{split}.{k}": tree[k]
            for k in ("h36m_root", "labels_path", "pred_results_path")}


def write_panoptic_tree(root, sequence="171204_pose3", seed=0,
                        size=(1920, 1080), n_frames=201, image_every=10):
    """A CMU Panoptic tree in the toolbox layout
    ``lt_tpu_torch.data.cmu_panoptic`` reads, from ``seed``: four HD
    cameras (``PANOPTIC_CAMERAS``) on a ring at 5 m and a VGA camera;
    ``n_frames`` scenes of one body (COCO19, cm), the last with none;
    ``size`` frames (JPEG) for every ``image_every``-th scene, the ones a
    config with ``retain_every_n_frames: image_every`` reads.  Returns the
    root and the encoder's name."""
    import json
    import os

    import numpy as np

    rng = np.random.RandomState(seed)
    cams = _ring_cameras(4, 500.0, 150.0, 1.0 * size[0], size, seed)
    seq_dir = os.path.join(root, sequence)
    os.makedirs(os.path.join(seq_dir, "hdPose3d_stage1_coco19"),
                exist_ok=True)
    calib = [{"name": name, "type": "hd", "K": K.tolist(), "R": R.tolist(),
              "t": t[:, None].tolist(), "distCoef": [0.0] * 5}
             for name, (R, t, K) in zip(PANOPTIC_CAMERAS, cams)]
    calib.append({"name": "01_01", "type": "vga", "K": np.eye(3).tolist(),
                  "R": np.eye(3).tolist(), "t": [[0], [0], [0]]})
    with open(os.path.join(seq_dir, f"calibration_{sequence}.json"),
              "w") as f:
        json.dump({"cameras": calib}, f)
    poses = _poses(COCO19_POSE, n_frames, rng, 400.0) / 10.0     # cm
    encoder, write = _jpeg_writer()
    backgrounds = [_background(size[1], size[0], rng) for _ in cams]
    for i in range(n_frames):
        bodies = [] if i == n_frames - 1 else [{"id": 0, "joints19": np.hstack(
            [poses[i], np.ones((19, 1))]).ravel().tolist()}]
        with open(os.path.join(seq_dir, "hdPose3d_stage1_coco19",
                               f"body3DScene_{i:08d}.json"), "w") as f:
            json.dump({"bodies": bodies}, f)
        if not bodies or i % image_every:
            continue
        for name, cam, bg in zip(PANOPTIC_CAMERAS, cams, backgrounds):
            d = os.path.join(seq_dir, "hdImgs", name)
            os.makedirs(d, exist_ok=True)
            write(os.path.join(d, f"{name}_{i:08d}.jpg"),
                  _frame(bg, _project(poses[i], cam), rng))
    return {"panoptic_root": root, "encoder": encoder}


def save_ddp_pth(model, path):
    """The model's state_dict as the reference's DDP training saves it:
    every name under ``module.``."""
    import torch

    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)


H36M_EVAL_YAML = "experiments/human36m/eval/human36m_vol_softmax.yaml"
CMU_EVAL_YAML = "experiments/cmu_panoptic/eval/cmu_vol_softmax.yaml"
DATA_SEED = 42          # run()'s seed: the model's weights and the order


@contextlib.contextmanager
def count_plain():
    """Count the calls of every kernel's plain version (each ``*_plain``
    function of the kernel modules, where the wrappers look it up) while
    the block runs; yields the dict of counts."""
    import importlib

    calls, saved = {}, []
    for mod_name in ("conv3d", "res3d", "updown", "unproject", "sample",
                     "conv_mp", "res3d_q4", "res3d_folded"):
        mod = importlib.import_module(f"lt_tpu_torch.ops.kernels.{mod_name}")
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_plain") and callable(fn)):
                continue
            calls.setdefault(name, 0)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _run_captured(what, **kwargs):
    """``engine.train.run(**kwargs)`` with its printed lines logged under
    ``what``; returns (metric, lines)."""
    import io

    from lt_tpu_torch.engine.train import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scalar = run(**kwargs)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  {what}: {line}")
    return scalar, lines


def _experiment(logdir):
    """The run's experiment directory (the only one under ``logdir``) and
    its results.pkl, metric.json and metrics.jsonl records."""
    import pickle

    (exp,) = [p for p in Path(logdir).iterdir() if p.is_dir()]
    ck = exp / "checkpoints" / "0000"
    with open(ck / "results.pkl", "rb") as f:
        results = pickle.load(f)
    metric = json.loads((ck / "metric.json").read_text())
    records = [json.loads(x) for x in
               (exp / "metrics.jsonl").read_text().splitlines()]
    return results, metric, records


def _dataset_path(config, yaml, overrides, per_forward, packing, dev, what,
                  smi, tmp, check_metric):
    """Evaluate ``yaml`` with ``run(eval_only=True)`` under cuDNN's
    deterministic algorithms, counting the kernels' launches (the
    flagship forward's ``per_forward`` a batch, and ``packing``
    split_bf16 launches once, where the first forward splits the V2V
    weights) and their plain versions' calls; hold the keypoints of
    results.pkl to a direct forward of the same collated batches through a
    model made and loaded the same way, and that forward to the plain path
    with the same weights (keypoints KP_TOL_MM, volumes REL_TOL, every
    batch: K1-K4 at the run's own shapes); ``check_metric(metric, results,
    dataset)`` holds
    metric.json.  Then the host's rate beside the card's: the loader alone
    (prefetch off and on) and a second run with cuDNN's default
    algorithms, each batch's data time and request time from its
    ``val_batch`` records.  Returns the launches of the first run."""
    import numpy as np
    import torch

    from lt_tpu_torch.engine import factory
    from lt_tpu_torch.engine import train as engine
    from lt_tpu_torch.ops.kernels import _build

    logdir = Path(tmp) / f"logs_{what}"
    torch.cuda.synchronize()
    _build.reset_launches()
    with count_plain() as plain_calls, deterministic_cudnn():
        _, lines = _run_captured(what, config_path=yaml, logdir=str(logdir),
                                 eval_only=True, overrides=overrides,
                                 seed=DATA_SEED, device=dev)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    results, metric, _ = _experiment(logdir)
    val_bs = config.opt.val_batch_size
    n = len(results["indexes"])
    n_batches = -(-n // val_bs)
    log(f"  {n} samples in {n_batches} batches of {val_bs}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; plain versions "
        f"called {sum(plain_calls.values())} times")
    decoder = [x for x in lines if x.startswith("Image decoder: ")]
    fallbacks = [int(x.split()[1]) for x in lines if x.startswith("loader: ")]
    if not decoder or any(fallbacks):
        raise AssertionError(f"{what}: decoder line {decoder}, native "
                             f"per-image fallbacks {fallbacks} (want 0)")
    log(f"  decoder: {decoder[0][len('Image decoder: '):]}; per-image "
        f"fallbacks of the native batch call: {sum(fallbacks)}")
    want = {k: per * n_batches for k, per in per_forward.items()}
    want["split_bf16"] += packing
    got = {k: launches[k] for k in launches if launches[k] or k in want}
    plain = {k: v for k, v in plain_calls.items() if v}
    if got != want or plain:
        raise AssertionError(f"{what}: launches {got}, want {want} "
                             f"(the flagship float32 forward's per batch, "
                             f"and its weights' split once); plain "
                             f"versions called: {plain}")

    # The direct forward of the same batches through the same weights.
    model = factory.make_model(config, device=dev, seed=DATA_SEED)
    report = engine.init_model_state(config, model)
    for part, r in report.items():
        log(f"  direct forward's model: {part} weights from "
            f"{Path(r['path']).name}: {r['loaded']} tensors, unused "
            f"{r['unused']}")
        if r["unused"] or (part == "model"
                           and r["loaded"] != len(model.state_dict())):
            raise AssertionError(f"{what}: {part} weights left entries over")
    # The plain path (PyTorch modules, no kernel of the port) with the same
    # weights holds K1-K4 at this run's own shapes: batch 20, the ragged
    # tail padded to it, and the config's joint count at the k=1 tail.
    plain = factory.make_model(config, device=dev, use_kernels=False,
                               seed=DATA_SEED)
    plain.load_state_dict(model.state_dict())
    plain.train(model.training)
    _, val_ds = engine.make_datasets(config, is_train=False)
    it = engine.make_iterator(val_ds, config.dataset.val, val_bs, DATA_SEED,
                              train=False)
    direct, idx, kp_errs, vol_rels = [], [], [], []
    with torch.no_grad(), deterministic_cudnn():
        for batch in it.epoch(0):
            t, n_real = engine.device_batch(batch, dev, pad_to=val_bs)
            pelvis = (t["keypoints_3d"] if config.model.get("use_gt_pelvis")
                      else t["pred_keypoints_3d"])
            args = (t["images"], t["proj_matrices"], pelvis)
            out = model(*args, view_mask=t["view_mask"])
            ref = plain(*args, view_mask=t["view_mask"])
            kp_errs.append((out.keypoints_3d[:n_real]
                            - ref.keypoints_3d[:n_real]).abs().max().item())
            vols = out.volumes[:n_real]
            vol_rels.append(rel_err(vols, ref.volumes[:n_real])[1]
                            if bool(vols.isfinite().all()) else math.inf)
            direct.append(out.keypoints_3d[:n_real].cpu().numpy())
            idx.append(batch["indexes"])
            del out, ref
    direct = np.concatenate(direct)
    log(f"  kernel path vs the plain path, each batch of "
        f"{tuple(t['images'].shape[:2])} images (the real rows): keypoints "
        f"max |diff| {[f'{e:.3e}' for e in kp_errs]} mm (limit {KP_TOL_MM}),"
        f" volumes rel {[f'{e:.3e}' for e in vol_rels]} (limit {REL_TOL})")
    if max(kp_errs) > KP_TOL_MM or max(vol_rels) > REL_TOL:
        raise AssertionError(f"{what}: the kernel path disagrees with the "
                             f"plain path at the run's shapes")
    del plain
    if not np.array_equal(np.concatenate(idx), results["indexes"]):
        raise AssertionError(f"{what}: the run's order is not the loader's")
    kp = results["keypoints_3d"]
    err = float(np.abs(kp - direct).max())
    finite = bool(np.isfinite(kp).all())
    exact = "bit for bit" if err == 0 else "not bit for bit"
    log(f"  results.pkl keypoints {kp.shape} vs the direct forward: max "
        f"|diff| {err:.3e} mm ({exact}; limit {KP_TOL_MM}), finite {finite}")
    if err > KP_TOL_MM or not finite or kp.shape != direct.shape:
        raise AssertionError(f"{what}: run's keypoints differ from the "
                             f"direct forward by {err:.3e} mm")
    check_metric(metric, results, val_ds)
    del model
    torch.cuda.empty_cache()

    # The host's rate beside the card's.
    for prefetch in (0, 2):
        it = engine.make_iterator(val_ds, config.dataset.val, val_bs,
                                  DATA_SEED, train=False)
        it.prefetch = prefetch
        t0 = time.perf_counter()
        count = sum(b["images"].shape[0] for b in it.epoch(0))
        secs = time.perf_counter() - t0
        log(f"  loader alone (decode, crop, resize, normalize, collate; "
            f"{it.num_workers} threads, prefetch {prefetch}): {count} "
            f"samples in {secs:.3f} s, {count / secs:.2f} samples/s "
            f"({4 * count / secs:.1f} images/s)")
    logdir2 = Path(tmp) / f"logs_{what}_timed"
    _run_captured(f"{what} (cuDNN defaults)", config_path=yaml,
                  logdir=str(logdir2), eval_only=True, overrides=overrides,
                  seed=DATA_SEED, device=dev)
    for r in (r for r in _experiment(logdir2)[2] if r["tag"] == "val_batch"):
        req = r["batch_time"] - r["data_time"]
        log(f"  eval batch of {int(r['batch_size'])} (padded to {val_bs}): "
            f"{1e3 * r['batch_time']:.1f} ms, data {1e3 * r['data_time']:.1f}"
            f" ms ({100 * r['data_time'] / r['batch_time']:.1f} %), request "
            f"{1e3 * req:.1f} ms, {val_bs / req:.2f} frames/s at batch "
            f"{val_bs}  [{smi}]")
    return launches


def check_h36m_metric(metric, results, ds):
    """[h36m]: metric.json has the per-subject (S9, S11) and per-action
    (trials merged) breakdown of both errors, and its relative MPJPE is a
    numpy recomputation from results.pkl (relative 1e-5)."""
    import numpy as np

    order = np.argsort(results["indexes"])
    pred = results["keypoints_3d"][order].astype(np.float64)
    gt = ds.labels["table"]["keypoints"][:, :17].astype(np.float64)
    rel = np.sqrt((((gt - gt[:, 6:7]) - (pred - pred[:, 6:7])) ** 2)
                  .sum(2)).mean(1).mean()
    got = metric.get("per_pose_error_relative", {})
    subjects = {"Average", "S9", "S11"}
    actions = {"Average", "Directions", "Walking"}
    complete = (set(metric) == {"per_pose_error",
                                "per_pose_error_relative"}
                and subjects <= set(got)
                and all(actions <= set(got[k]) for k in subjects))
    avg = got.get("Average", {}).get("Average", float("nan"))
    log(f"  metric.json: relative MPJPE {avg:.4f} mm (numpy from "
        f"results.pkl {rel:.4f}); per subject "
        f"{ {k: round(got[k]['Average'], 2) for k in subjects if k in got} }"
        f"; per action (all) "
        f"{ {k: round(v, 2) for k, v in got.get('Average', {}).items()} }")
    if not complete or abs(avg - rel) > 1e-5 * rel:
        raise AssertionError("[h36m] metric.json lacks its breakdown or "
                             "disagrees with results.pkl")


def check_cmu_metric(metric, results, ds):
    """[cmu]: metric.json has the per-sequence breakdown, and its relative
    MPJPE is a numpy recomputation from results.pkl (relative 1e-5)."""
    import numpy as np

    order = np.argsort(results["indexes"])
    pred = results["keypoints_3d"][order].astype(np.float64)
    gt = ds.table["keypoints"][:, :, :3].astype(np.float64)
    rel = np.sqrt((((gt - gt[:, 2:3]) - (pred - pred[:, 2:3])) ** 2)
                  .sum(2)).mean(1).mean()
    got = metric.get("per_pose_error_relative", {}).get("Average", {})
    avg = got.get("Average", float("nan"))
    log(f"  metric.json: relative MPJPE {got} mm (numpy from "
        f"results.pkl {rel:.4f})")
    if "171204_pose3" not in got or abs(avg - rel) > 1e-5 * rel:
        raise AssertionError("[cmu] metric.json lacks its breakdown or "
                             "disagrees with results.pkl")


def h36m_phase(dev, smi, per_forward, packing):
    """[h36m]: human36m_vol_softmax.yaml evaluated at its own width (RN-152,
    384^2, 4 views, 64^3, softmax, val batch 20, float32) on a
    Human3.6M tree of :func:`write_h36m_tree` (two full batches and a
    ragged tail of test rows, one view missing in one row) from a
    whole-model ``.pth`` the port saves from its seeded model with DDP's
    ``module.`` names; overrides only for the tree's paths and the weights.
    Returns the run's launches."""
    import tempfile

    from lt_tpu_torch.engine import factory
    from lt_tpu_torch.utils import cfg

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = write_h36m_tree(Path(tmp) / "h36m", seed=0)
        log(f"  tree: 52 rows x 4 views of 1000^2 JPEGs ({tree['encoder']})"
            f" written in {time.perf_counter() - t0:.1f} s")
        pth = str(Path(tmp) / "human36m_vol_softmax.pth")
        overrides = {**h36m_overrides(tree), "model.checkpoint": pth}
        config = cfg.load_config(H36M_EVAL_YAML, overrides)
        save_ddp_pth(factory.make_model(config, device=dev, seed=7), pth)
        return _dataset_path(config, H36M_EVAL_YAML, overrides, per_forward,
                             packing, dev, "h36m", smi, tmp,
                             check_h36m_metric)


def cmu_phase(dev, smi, per_forward, packing):
    """[cmu]: one batch of cmu_vol_softmax.yaml at its width (RN-152, 384^2,
    19 joints, 4 HD views, use_gt_pelvis, seeded random weights) on a
    Panoptic tree of :func:`write_panoptic_tree` (200 scenes, every 10th
    retained and imaged, an empty scene skipped).  Returns the run's
    launches."""
    import tempfile

    from lt_tpu_torch.utils import cfg

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = write_panoptic_tree(str(Path(tmp) / "panoptic"), seed=1)
        log(f"  tree: 201 scenes, 20 x 4 views of 1920x1080 JPEGs "
            f"({tree['encoder']}) written in {time.perf_counter() - t0:.1f}"
            f" s")
        overrides = {"dataset.val.panoptic_root": tree["panoptic_root"]}
        config = cfg.load_config(CMU_EVAL_YAML, overrides)
        return _dataset_path(config, CMU_EVAL_YAML, overrides, per_forward,
                             packing, dev, "cmu", smi, tmp, check_cmu_metric)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8,
                    help="flagship batch (bench.py's is 8)")
    args = ap.parse_args(argv)

    if not (ROOT / "lt_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(lt_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from lt_tpu_torch.models.triangulation import (
        VolumetricTriangulationNet, rescale_proj_to_heatmap,
        select_base_points)
    from lt_tpu_torch.ops import volumetric as vol_ops
    from lt_tpu_torch.ops.kernels import _build
    from lt_tpu_torch.ops.kernels.unproject import compose_grid_projection
    from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
    from lt_tpu_torch.utils.example import example_batch
    from lt_tpu_torch.utils.weights import load_volumetric_npz

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}  torch {torch.__version__}  cuda "
        f"{torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"nvidia-smi: {smi}")

    # Phase 1: build.
    secs = _build.build()
    log(f"[build] {len(_build.SOURCES)} sources ({len(_build.KERNELS)} "
        f"kernels) in {secs:.1f} s (parallel nvcc)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            entry = re.search(r"Compiling entry.*conv3d_mma_kernelILi(\d+)ELi"
                              r"(\d+)ELi(\d+)ELi(\d)E(\w+?)EEv", line)
            up = re.search(r"Compiling entry.*upsample3d_2x_mma_kernelILi"
                           r"(\d+)EEv", line)
            if entry:       # which instantiation the next lines describe
                nt, ck, kt, parts, to = entry.groups()
                log(f"  {name}: conv3d_mma_kernel<NT={nt}, CK={ck}, "
                    f"k={kt if kt != '0' else 'any'}, "
                    f"{'bfloat16' if parts == '1' else parts + '-part float32'}"
                    f" in, {'bfloat16' if 'bfloat16' in to else 'float'} "
                    f"out>")
            elif up:
                log(f"  {name}: upsample3d_2x_mma_kernel<NT={up.group(1)}>")
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log("  (the tensor-core kernels' shared memory is dynamic: each replayed "
        "launch below prints its plan's bytes)")

    # Phase 2: full float32 everywhere (no TF32 in cuDNN or cuBLAS).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    b = args.batch
    fl = FLAGSHIP
    images, proj, pelvis = (torch.from_numpy(a).to(dev) for a in
                            example_batch(b, 4, fl["image"], 17))

    def geometry(nb):
        """The flagship's composed (nb, 4, 3, 4) grid -> pixel matrices."""
        base = select_base_points(pelvis[:nb], "mpii")
        aff = vol_ops.coord_volume_affine(base, 2500.0, fl["volume"])
        return compose_grid_projection(
            rescale_proj_to_heatmap(proj[:nb], (fl["image"],) * 2,
                                    (fl["heatmap"],) * 2), aff).contiguous()

    def build_model(use_kernels="fused", dt=torch.float32, like=None):
        net = VolumetricTriangulationNet(
            num_joints=17, num_layers=fl["layers"], volume_size=fl["volume"],
            cuboid_side=2500.0, volume_aggregation_method="softmax",
            kind="mpii", use_kernels=use_kernels, device=dev, seed=0,
            compute_dtype=dt)
        if like is not None:
            net.load_state_dict(like.state_dict())
        return net

    def drive(net, n, what, dt=torch.float32):
        """``n`` timed requests after the counts were set to 0; checks
        shapes, finiteness, that K1-K4 were all launched, K2 and K3 through
        the bodies of ``dt`` only, K2_PER_FORWARD and K3_PER_FORWARD times
        a request, and in float32 one split_bf16 before each K2."""
        torch.cuda.synchronize()
        _build.reset_launches()
        times, outs = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(net(images, proj, pelvis))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        log(f"  launches over {n} requests: "
            f"{ {k: v for k, v in launches.items() if v} }")
        kind = str(dt).replace("torch.", "")
        missing = [k for k in EVAL_KERNELS[kind] if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {what} "
                                 f"path: {missing}")
        other = "bfloat16" if kind == "float32" else "float32"
        splits = K2_PER_FORWARD if kind == "float32" else 0
        for k, per in ((K2, K2_PER_FORWARD), (K3, K3_PER_FORWARD)):
            if (launches[k[kind]] != per * n or launches[k[other]] != 0
                    or launches["split_bf16"] != splits * n):
                raise AssertionError(
                    f"{what}: {launches[k[kind]]} {k[kind]}, "
                    f"{launches[k[other]]} {k[other]} and "
                    f"{launches['split_bf16']} split_bf16 launches over {n} "
                    f"requests, want {per}, 0 and {splits} a request")
        for out in outs:
            kp, vols = out.keypoints_3d, out.volumes
            if tuple(kp.shape) != (b, 17, 3) or tuple(vols.shape) != (
                    b, 17) + (fl["volume"],) * 3:
                raise AssertionError(f"output shapes {tuple(kp.shape)}, "
                                     f"{tuple(vols.shape)}")
            if kp.dtype != torch.float32 or not (
                    bool(kp.isfinite().all())
                    and bool(vols.isfinite().all())):
                raise AssertionError(f"non-finite {what} output")
        ms = float(np.median(times))
        log(f"  forward ms per request (median of {n}): {ms:.1f}  all: "
            f"{[round(t, 1) for t in times]}  frames/s at batch {b}: "
            f"{b / ms * 1e3:.2f}")
        return outs, launches

    def timed_plain(net, label):
        net(images, proj, pelvis)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(images, proj, pelvis)
        torch.cuda.synchronize()
        log(f"  plain path ({label}): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return out

    def kernel_table(calls, launches, n):
        """Replay one forward's launches; per-kernel sums of this path."""
        per_kernel, per_entry = replay(calls, geometry, dev)

        def summed_bound(e):
            return e["bound_ms"], max(e["bound_by"], key=e["bound_by"].get)

        for entry, e in per_entry.items():
            b_ms, b_by = summed_bound(e)
            log(f"  entry point {entry}: {e['launches']} launches/forward, "
                f"kernels {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, "
                f"library {_ms(e['library_ms'])} (sum over the launches that "
                f"have one), bound {b_ms:.4f} ms ({b_by}; with tensor cores "
                f"{e['tc_bound_ms']:.4f} ms, on the CUDA cores "
                f"{e['f32_bound_ms']:.4f} ms), max rel err "
                f"{e['max_rel_err']:.3e}")
        table = {}
        for name in per_kernel:
            k = per_kernel[name]
            b_ms, b_by = summed_bound(k)
            table[name] = {
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": k["library_ms"]}
            graphed = ""
            if name in GRAPH_TIMED:
                table[name]["loop_ms"] = k["loop_ms"]
                graphed = f" as graphs (loop {k['loop_ms']:.3f} ms)"
            log(f"  {name}: {launches[name] // n} launches/forward, kernel "
                f"{k['ms']:.3f} ms{graphed}, plain {k['plain_ms']:.3f} ms, "
                f"library "
                f"{_ms(k['library_ms'])}, bound {b_ms:.4f} ms ({b_by}; with "
                f"tensor cores {k['tc_bound_ms']:.4f} ms, on the CUDA cores "
                f"{k['f32_bound_ms']:.4f} ms), max rel err "
                f"{k['max_rel_err']:.3e}")
        return table

    def kp_dist(a, ref):
        """Per-joint distances (mm) between two keypoint sets."""
        return (a - ref).norm(dim=-1).flatten()

    # Phase 3: entry points at flagship shapes, kernel vs plain.
    log(f"[entry points] batch {b}, flagship shapes, tolerance rel "
        f"{REL_TOL}")
    entry_point_checks(b, geometry, dev)

    # Phase 3b: NaN and infinities in the kernels' inputs.
    log("[nan] NaN, +inf and -inf planted in the inputs of K1-K8, each "
        "kernel against its plain version")
    nan_checks(b, geometry, dev)

    # Phase 4: the flagship forward on the kernel path.
    log(f"[flagship] VolumetricTriangulationNet RN-{fl['layers']} "
        f"{fl['image']}^2 x4 views, {fl['volume']}^3, softmax, 17 joints, "
        f"f32, seed 0, batch {b}")
    t0 = time.perf_counter()
    model = build_model()
    log(f"  model built in {time.perf_counter() - t0:.1f} s")
    # A warm-up forward packs (and in float32 splits) the V2V weights, once
    # per weight version; the recorded forward is a later one.  The timed
    # requests run with cuDNN's default algorithms.
    _build.reset_launches()
    model(images, proj, pelvis)
    packing = _build.LAUNCHES["split_bf16"] - K2_PER_FORWARD
    calls = record_launches(lambda: model(images, proj, pelvis))
    outs, launches = drive(model, REQUESTS, "eval")
    plain_model = build_model(False, like=model)
    plain_out = timed_plain(plain_model, "PyTorch modules, cuDNN f32")
    for i, out in enumerate(outs):
        kp_err = (out.keypoints_3d - plain_out.keypoints_3d).abs().max().item()
        vol_err, vol_rel = rel_err(out.volumes, plain_out.volumes)
        log(f"  request {i}, cuDNN's default algorithms: keypoints max "
            f"|kernel - plain| {kp_err:.3e} mm (limit {KP_TOL_MM}); volumes "
            f"max abs {vol_err:.3e} (rel {vol_rel:.3e}, not held to a limit: "
            f"the backbone differs between identical requests)")
        if kp_err > KP_TOL_MM:
            raise AssertionError(f"flagship request {i}: keypoints "
                                 f"{kp_err:.3e} mm from the plain path")
    # The comparison that holds: both paths under cuDNN's deterministic
    # algorithms, so that the backbone does not differ between them.
    with deterministic_cudnn():
        out = model(images, proj, pelvis)
        plain_out = plain_model(images, proj, pelvis)
    kp_err = (out.keypoints_3d - plain_out.keypoints_3d).abs().max().item()
    vol_err, vol_rel = rel_err(out.volumes, plain_out.volumes)
    log(f"  cuDNN's deterministic algorithms: keypoints max |kernel - plain| "
        f"{kp_err:.3e} mm (limit {KP_TOL_MM}); volumes max abs {vol_err:.3e} "
        f"(rel {vol_rel:.3e}, limit {REL_TOL})")
    if kp_err > KP_TOL_MM or vol_rel > REL_TOL:
        raise AssertionError("flagship: kernel path disagrees with the plain "
                             "path")
    kp_f32 = outs[0].keypoints_3d.clone()
    del plain_out, outs, out
    torch.cuda.empty_cache()

    # Phase 5: every main-path launch shape, kernel vs plain vs library.
    log(f"[kernels] {len(calls)} launches per flagship forward; distinct "
        f"shapes held to rel {REL_TOL}, times summed over one forward")
    table = kernel_table(calls, launches, REQUESTS)

    def row(name, numbers):
        return {"name": name, "route": "cuda",
                "source": f"lt_tpu_torch/ops/kernels/csrc/"
                          f"{_build.KERNELS[name]}.cu",
                "replaces": REPLACES[name], "launches": 0,
                "launches_by_path": {}, **numbers}

    def add_path(path, path_launches):
        for r in rows:
            n = path_launches.get(r["name"], 0)
            if n:
                r["launches"] += n
                r["launches_by_path"][path] = n

    # Phase 5b: rows 1-7 in bfloat16 at the flagship shapes.
    log(f"[entry points bf16] batch {b}, flagship shapes, bfloat16, "
        f"tolerance rel {REL_TOL_BF16}")
    entry_point_checks(b, geometry, dev, torch.bfloat16, REL_TOL_BF16)

    # Phase 5c: the bfloat16 flagship forward on the fused kernel path.
    log(f"[flagship bf16] the same model and weights, bf16: true "
        f"(compute_dtype bfloat16), use_kernels='fused', batch {b}")
    model16 = build_model(dt=torch.bfloat16, like=model)
    calls16 = record_launches(lambda: model16(images, proj, pelvis))
    outs, launches16 = drive(model16, REQUESTS, "bfloat16 eval",
                             torch.bfloat16)
    plain16 = build_model(False, torch.bfloat16, like=model)
    plain_out = timed_plain(plain16, "PyTorch modules under autocast, "
                                     "cuDNN bf16")
    # The plain path's own spread: the images scaled by one bfloat16 ulp.
    moved = plain16(images * (1.0 + 2.0 ** -8), proj, pelvis)
    spread = kp_dist(moved.keypoints_3d, plain_out.keypoints_3d)
    log(f"  plain bf16 path under images * (1 + 2^-8): keypoints move mean "
        f"{spread.mean().item():.3e} p95 "
        f"{spread.quantile(0.95).item():.3e} max {spread.max().item():.3e} "
        f"mm (largest coordinate "
        f"{(moved.keypoints_3d - plain_out.keypoints_3d).abs().max().item():.3e}"
        f" mm)")
    for i, out in enumerate(outs):
        kp_err = (out.keypoints_3d - plain_out.keypoints_3d).abs().max().item()
        vol_err, vol_rel = rel_err(out.volumes, plain_out.volumes)
        log(f"  request {i}: keypoints max |kernel - plain| {kp_err:.3e} mm "
            f"(limit {KP_TOL_BF16_MM}); volumes max abs {vol_err:.3e} (rel "
            f"{vol_rel:.3e})")
        if kp_err > KP_TOL_BF16_MM:
            raise AssertionError(f"bfloat16 flagship request {i}: kernel "
                                 f"path {kp_err:.3e} mm from the plain "
                                 f"bfloat16 path (> {KP_TOL_BF16_MM})")
    kp_bf16 = outs[0].keypoints_3d.clone()
    d = kp_dist(kp_bf16, kp_f32)
    log(f"  bf16 kernel path vs f32 kernel path keypoints: mean "
        f"{d.mean().item():.3f} p95 {d.quantile(0.95).item():.3f} max "
        f"{d.max().item():.3f} mm (random weights)")
    del plain16, plain_out, moved, outs, out
    torch.cuda.empty_cache()
    log(f"[kernels bf16] {len(calls16)} launches per bfloat16 forward; "
        f"distinct shapes held to rel {REL_TOL_BF16}")
    table16 = kernel_table(calls16, launches16, REQUESTS)
    # One row per eval kernel: its float32 numbers where it serves float32,
    # else its bfloat16 ones; K1 and K4 carry their bfloat16 numbers too.
    rows = []
    for name in dict.fromkeys(EVAL_KERNELS["float32"]
                              + EVAL_KERNELS["bfloat16"]):
        rows.append(row(name, table.get(name) or table16[name]))
        if name in table and name in table16:
            rows[-1]["bf16"] = table16[name]
    add_path("eval", launches)
    add_path("eval_bf16", launches16)
    del model16
    torch.cuda.empty_cache()

    # Phase 5d: the per-conv V2V configuration, float32 and bfloat16.
    log(f"[flagship conv] use_kernels='conv': every V2V layer its own "
        f"launch (conv3d_mp, conv3d_same, max_pool3d_2x, upsample3d_2x)")
    for dt, ref_kp, path in ((torch.float32, kp_f32, "eval_conv"),
                             (torch.bfloat16, kp_bf16, "eval_conv_bf16")):
        net = build_model("conv", dt, like=model)
        net(images, proj, pelvis)                       # warm-up
        outs, conv_launches = drive(net, REQUESTS, f"per-conv {dt}", dt)
        add_path(path, conv_launches)
        kp_err = (outs[0].keypoints_3d - ref_kp).abs().max().item()
        log(f"  {dt}: keypoints max |conv - fused| {kp_err:.3e} mm (limit "
            f"{KP_TOL_MM})")
        if kp_err > KP_TOL_MM:
            raise AssertionError(f"per-conv path ({dt}) disagrees with the "
                                 f"fused path: {kp_err:.3e} mm")
        del net, outs
        torch.cuda.empty_cache()
    del model, plain_model
    torch.cuda.empty_cache()

    # Phase 5e: the entry points with no caller on the model paths.
    log(f"[alt entry points] conv3d_same, res3d_block_mp / _q4 / _folded at "
        f"{fl['volume']}^3 batch {b}; sample_views_affine at {TRAIN_BATCH * 4}"
        f" views; tolerance rel {REL_TOL} (float32), {REL_TOL_BF16} "
        f"(bfloat16; {2 * REL_TOL_BF16} for a block, which rounds thrice)")
    alt_launches, alt_rows = alt_entry_points(b, geometry, dev)
    log(f"  launches over the alternative entry points: "
        f"{ {k: v for k, v in alt_launches.items() if v} }")
    missing = [k for k in ALT_KERNELS if alt_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the alternative "
                             f"entry points: {missing}")
    for name in ("sample_views", "sample_views_grad"):
        rows.append(row(name, alt_rows[name]))
    add_path("alt", alt_launches)

    # Phase 6: the committed trained fixture (RN-18, 128^2, 32^3).
    fix = ROOT / "tests" / "fixtures" / "vol_rn18_synth.npz"
    im_s, pj_s, kp_s = (torch.from_numpy(a).to(dev) for a in
                        example_batch(1, 4, 128, 17, seed=1))
    outs = []
    for use_kernels in (True, False):
        net = VolumetricTriangulationNet(
            num_joints=17, num_layers=18, volume_size=32, cuboid_side=2500.0,
            use_kernels="fused" if use_kernels else False, device=dev)
        load_volumetric_npz(net, str(fix), num_layers=18)
        with deterministic_cudnn():
            outs.append(net(im_s, pj_s, kp_s))
    fk_err = (outs[0].keypoints_3d - outs[1].keypoints_3d).abs().max().item()
    fv_err, fv_rel = rel_err(outs[0].volumes, outs[1].volumes)
    peak = outs[0].volumes.flatten(2).amax(-1).mean().item()
    log(f"[fixture] vol_rn18_synth.npz RN-18 128^2 32^3: keypoints max "
        f"|kernel - plain| {fk_err:.3e} mm, volumes rel {fv_rel:.3e}, mean "
        f"peak voxel probability {peak:.4f} (uniform {1 / 32 ** 3:.2e})")
    if fk_err > KP_TOL_MM or fv_rel > REL_TOL:
        raise AssertionError("fixture kernel path disagrees with the plain "
                             "path")
    del net, outs
    # The same weights in bfloat16 on the fused kernel path (conv3d_mma,
    # upsample3d_2x_mma) against the float32 kernel path, per joint, on the
    # fixture's 8 held-out validation poses: the CPU test's band
    # (tests/test_torch_bf16.py), mean FIX_BF16_MEAN_MM, max FIX_BF16_MAX_MM.
    ds = SyntheticMultiViewDataset(n_samples=8, n_views=4, image_size=128,
                                   sample_offset=1_000_000)
    val = [ds[i] for i in range(len(ds))]
    im_v, pj_v, gt_v = (torch.from_numpy(np.stack(a)).to(dev) for a in (
        [np.stack(v["images"]).astype(np.float32) for v in val],
        [np.stack(v["proj_matrices"]) for v in val],
        [v["keypoints_3d"][:, :3] for v in val]))
    kps = {}
    for dt in (torch.float32, torch.bfloat16):
        net = VolumetricTriangulationNet(
            num_joints=17, num_layers=18, volume_size=32, cuboid_side=2500.0,
            use_kernels="fused", device=dev, compute_dtype=dt)
        load_volumetric_npz(net, str(fix), num_layers=18)
        _build.reset_launches()
        kps[dt] = net(im_v, pj_v, gt_v).keypoints_3d
        if not _build.LAUNCHES[K3[str(dt).replace("torch.", "")]]:
            raise AssertionError(f"fixture {dt}: K3 was not launched")
        del net
    d = kp_dist(kps[torch.bfloat16], kps[torch.float32])
    mpjpe = {dt: ds.evaluate(kp.cpu().numpy())[0] for dt, kp in kps.items()}
    log(f"[fixture bf16] the same weights in bfloat16 (fused kernel path) vs "
        f"float32, 8 validation poses: keypoints mean {d.mean().item():.3f} "
        f"p95 {d.quantile(0.95).item():.3f} max {d.max().item():.3f} mm "
        f"(limits {FIX_BF16_MEAN_MM} / {FIX_BF16_MAX_MM}); rel MPJPE float32 "
        f"{mpjpe[torch.float32]:.2f} mm, bfloat16 "
        f"{mpjpe[torch.bfloat16]:.2f} mm")
    if (not bool(d.isfinite().all()) or d.mean().item() > FIX_BF16_MEAN_MM
            or d.max().item() > FIX_BF16_MAX_MM):
        raise AssertionError("fixture in bfloat16 outside the band of its "
                             "float32 keypoints")
    del kps, im_v, pj_v, gt_v
    torch.cuda.empty_cache()

    # Phase 7: the training kernels at the flagship training shapes, in
    # float32 and in their bfloat16 instances.
    train_rows = train_entry_points(geometry, dev)

    # Phase 8: the flagship training step (kernel path vs plain path, then
    # timed on the kernel path), in float32 and with bf16: true.
    train_launches, train_f32 = train_flagship(dev)
    train_launches16 = train_flagship_bf16(dev, smi, train_f32)
    train_fixture_bf16(dev)
    for launches_, what in ((train_launches, "float32"),
                            (train_launches16, "bfloat16")):
        if any(launches_[k] for k in ("conv3d_mma", "conv3d_mma_f32",
                                      "split_bf16")):
            raise AssertionError(f"the {what} training step launched K2: "
                                 f"{launches_}")
    for name in ("sample_views_t", "sample_views_grad_t"):
        rows.append(row(name, train_rows[name].pop("float32")))
        rows[-1]["types"] = train_rows[name]
    add_path("train", {k: train_launches[k] for k in TRAIN_KERNELS})
    add_path("train_bf16", {k: train_launches16[k] for k in TRAIN_KERNELS})

    # Phase 9: the CLI's run on the synthetic config, one epoch, then resume.
    train_cli(dev)

    # Phase 10: the algebraic and RANSAC families at the flagship width, on
    # the trained fixture, and the algebraic training step and CLI.
    alg_flagship(dev, smi, images, proj)
    ransac_flagship(dev, smi, images, proj)
    alg_fixture(dev, smi)
    alg_train_step(dev, smi, "bfloat16", alg_train(dev, smi))

    # Phase 11: the dataset configs through the CLI's run, at their width.
    per_forward = {k: launches[k] // REQUESTS
                   for k in EVAL_KERNELS["float32"]}
    log(f"  the flagship's float32 forward: {per_forward} launches, and "
        f"{packing} split_bf16 launches in its first, which packs the "
        f"weights")
    log(f"[h36m] {H36M_EVAL_YAML} --eval at its width, on a Human3.6M tree "
        f"written from seed 0, weights from a whole-model .pth")
    add_path("h36m", h36m_phase(dev, smi, per_forward, packing))
    log(f"[cmu] {CMU_EVAL_YAML} --eval at its width, one batch, on a CMU "
        f"Panoptic tree written from seed 1")
    add_path("cmu", cmu_phase(dev, smi, per_forward, packing))

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
