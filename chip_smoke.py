#!/usr/bin/env python3
"""Smoke run of lt_tpu_torch on one NVIDIA GPU.

Builds the four CUDA kernels of the port from ``lt_tpu_torch/ops/kernels/
csrc``, holds each against its plain PyTorch version, drives the flagship
volumetric forward (ResNet-152, 384^2 images, 4 views, 64^3 volume,
softmax aggregation, 17 joints, float32, seeded random weights) through
them, and loads the committed trained RN-18 fixture.

    python3 chip_smoke.py [--batch N]

Run from the repository root.  Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result.  Its last three lines
are the kernels JSON, the ``nvidia-smi`` name / power-limit line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 on the CUDA
# cores (the kernels use no tensor cores) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The flagship configuration (bench.py's shapes): ResNet-152 backbone at
# 384^2 (96^2 heatmaps), a 64^3 volume, 4 views, 17 joints.
FLAGSHIP = {"layers": 152, "image": 384, "heatmap": 96, "volume": 64}
REL_TOL = 1e-4          # kernel vs plain: max |diff| <= REL_TOL * max |plain|
KP_TOL_MM = 0.1         # kernel path vs plain path keypoints
REQUESTS = 3            # flagship forwards answered on the kernel path

# The TPU kernels (pallas_call sites) each CUDA kernel replaces.
REPLACES = {
    "unproject_agg": "lt_tpu/ops/pallas/unproject.py:427",
    "conv3d_fused": "lt_tpu/ops/pallas/conv_mp.py:237, "
                    "lt_tpu/ops/pallas/res3d.py:742, :950, :1180",
    "upsample3d_2x": "lt_tpu/ops/pallas/updown.py:376, :330, "
                     "lt_tpu/ops/pallas/res3d.py:1180",
    "max_pool3d_2x": "lt_tpu/ops/pallas/updown.py:185, :143, "
                     "lt_tpu/ops/pallas/res3d.py:742, :950",
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err, err / max(scale, 1e-30)


def check(name, got, ref, tol=REL_TOL):
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err, rel = rel_err(got, ref)
    if rel > tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} (rel {rel:.3e})"
                             f" > rel {tol}")
    return err, rel


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Replaying the main path's launches: one case per distinct launch shape
# ---------------------------------------------------------------------------


class Case:
    """One distinct launch of a kernel on the main path: random inputs of
    its shapes, the kernel, its plain version, the library call, and the
    bytes / flops the function needs."""

    def __init__(self, run, plain, library, nbytes, flops):
        self.run, self.plain, self.library = run, plain, library
        self.nbytes, self.flops = nbytes, flops


def make_case(name, args, geometry, dev, gen):
    import torch
    import torch.nn.functional as F

    from lt_tpu_torch.ops.kernels import conv3d, unproject, updown

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    f = 4  # bytes per float32
    if name == "conv3d_fused":
        _, _, _, res_ptr, _, b, sx, sy, sz, cin, cout, k, relu = args
        x = randn(b, sx, sy, sz, cin)
        w = randn(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        res = randn(b, sx, sy, sz, cout) if res_ptr else None
        w_lib = w.permute(4, 3, 0, 1, 2).contiguous()
        vox = b * sx * sy * sz
        nbytes = f * (x.numel() + w.numel() + cout + vox * cout
                      * (2 if res is not None else 1))
        return Case(
            lambda: conv3d.conv3d_fused(x, w, bias, res, bool(relu)),
            lambda: conv3d.conv3d_fused_plain(x, w, bias, res, bool(relu)),
            lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w_lib, bias,
                             padding=(k - 1) // 2),
            nbytes, 2.0 * vox * k ** 3 * cin * cout)
    if name == "upsample3d_2x":
        _, _, _, skip_ptr, _, b, sx, sy, sz, cin, cout = args
        x = randn(b, sx, sy, sz, cin)
        w8 = randn(cin, 8 * cout, scale=cin ** -0.5)
        b8 = randn(cout, scale=0.1).repeat(8)
        skip = randn(b, 2 * sx, 2 * sy, 2 * sz, cout) if skip_ptr else None
        w_lib = w8.reshape(cin, 2, 2, 2, cout).permute(0, 4, 1, 2, 3)
        w_lib = w_lib.contiguous()
        out_n = b * 8 * sx * sy * sz * cout

        def library():
            y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w_lib,
                                   b8[:cout], stride=2).relu_()
            return y if skip is None else y.add_(skip.permute(0, 4, 1, 2, 3))

        return Case(
            lambda: updown.upsample3d_2x(x, w8, b8, skip),
            lambda: updown.upsample3d_2x_plain(x, w8, b8, skip), library,
            f * (x.numel() + w8.numel() + b8.numel() + out_n
                 * (2 if skip is not None else 1)),
            2.0 * out_n * cin)
    if name == "max_pool3d_2x":
        _, _, b, sx, sy, sz, c = args
        x = randn(b, sx, sy, sz, c)
        return Case(
            lambda: updown.max_pool3d_2x(x),
            lambda: updown.max_pool3d_2x_plain(x),
            lambda: F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2),
            f * x.numel() * 9 / 8, 7.0 * x.numel() / 8)
    if name == "unproject_agg":
        _, _, _, conf_ptr, _, b, v, h, w, c, s, method, _, _ = args
        names = {0: "softmax", 1: "sum", 2: "max", 3: "conf"}
        feats = randn(b, v, h, w, c)
        m = geometry(b)
        mask = torch.ones(b, v, device=dev)
        conf = randn(b, v, c).abs() if conf_ptr else None
        n = b * s ** 3
        # Ops counted as if every voxel's 4 taps were in the map for every
        # view (the most the data could need); the bytes bound is larger.
        return Case(
            lambda: unproject.unproject_agg(feats, m, mask, conf,
                                            names[method], s),
            lambda: unproject.unproject_agg_plain(feats, m, mask, conf,
                                                  names[method], s),
            None, f * (feats.numel() + m.numel() + mask.numel() + n * c),
            n * v * (30.0 + 8.0 * c + 4.0 * c))
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

    def recording(name, cfn, device, argtypes, *args):
        calls.append((active[-1] if active else None, name, args))
        return orig(name, cfn, device, argtypes, *args)

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


def _acc(table, key, mult, err, rel, ms, plain_ms, lib_ms, case):
    acc = table.setdefault(key, dict(
        launches=0, max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0,
        library_ms=None, nbytes=0.0, flops=0.0))
    acc["launches"] += mult
    acc["max_abs_err"] = max(acc["max_abs_err"], err)
    acc["max_rel_err"] = max(acc["max_rel_err"], rel)
    acc["ms"] += mult * ms
    acc["plain_ms"] += mult * plain_ms
    if lib_ms is not None:
        acc["library_ms"] = (acc["library_ms"] or 0.0) + mult * lib_ms
    acc["nbytes"] += mult * case.nbytes
    acc["flops"] += mult * case.flops


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
        err, rel = check(f"{name}{_shape_str(name, args)}", case.run(),
                         case.plain())
        ms = cuda_ms(case.run)
        plain_ms = cuda_ms(case.plain)
        lib_ms = None if case.library is None else cuda_ms(case.library)
        b_ms, _ = bound(case.nbytes, case.flops)
        log(f"  {entry}: {name}{_shape_str(name, args)} x{mult}: "
            f"max_abs_err {err:.3e} rel {rel:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
            f"{b_ms:.4f} ms")
        for table, k in ((per_kernel, name), (per_entry, entry)):
            _acc(table, k, mult, err, rel, ms, plain_ms, lib_ms, case)
        del case
        torch.cuda.empty_cache()
    return per_kernel, per_entry


# Argument slots that are pointers (kept as present / absent in the key).
_PTR_SLOTS = {"conv3d_fused": range(5), "upsample3d_2x": range(5),
              "max_pool3d_2x": range(2), "unproject_agg": range(5)}


def _shape_str(name, args):
    ints = [a for i, a in enumerate(args) if i not in _PTR_SLOTS[name]]
    return "(" + ",".join(f"{a:g}" if isinstance(a, float) else str(a)
                          for a in ints) + ")"


# ---------------------------------------------------------------------------
# Entry-point checks: the seven TPU entry points' port counterparts
# ---------------------------------------------------------------------------


def entry_point_checks(batch, geometry, dev):
    import torch

    from lt_tpu_torch.ops.kernels import conv_mp, res3d, unproject, updown
    from lt_tpu_torch.ops.kernels.conv3d import conv3d_fused_plain

    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def conv_w(k, cin, cout):
        return randn(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5)

    def block(cin, c, proj=False):
        blk = [conv_w(3, cin, c), randn(c, scale=0.1), conv_w(3, c, c),
               randn(c, scale=0.1)]
        if proj:
            blk.append((randn(cin, c, scale=cin ** -0.5), randn(c, scale=0.1)))
        return blk

    def tail(c, out):
        return [(randn(c, c, scale=c ** -0.5), randn(c, scale=0.1), True),
                (randn(c, c, scale=c ** -0.5), randn(c, scale=0.1), True),
                (randn(c, out, scale=c ** -0.5), randn(out, scale=0.1),
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
        errs = [check(label, g, r) for g, r in zip(got, ref)]
        torch.cuda.synchronize()
        ms, plain_ms = cuda_ms(kernel_fn, 100), cuda_ms(plain_fn, 100)
        log(f"  {label}: max_abs_err {max(e for e, _ in errs):.3e} rel "
            f"{max(r for _, r in errs):.3e}  kernel {ms:.3f} ms  plain "
            f"{plain_ms:.3f} ms")

    b, s, hm = batch, FLAGSHIP["volume"], FLAGSHIP["heatmap"]
    h = s // 2
    feats = randn(b, 4, hm, hm, 32)
    m = geometry(b)
    conf = randn(b, 4, 32).abs()
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
    w7, b7 = conv_w(7, 32, 16), randn(16, scale=0.1)
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
    b8 = randn(32, scale=0.1).repeat(8)
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
    log(f"[build] {len(_build.SOURCES)} kernels in {secs:.1f} s "
        f"(parallel nvcc)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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

    # Phase 3: entry points at flagship shapes, kernel vs plain.
    log(f"[entry points] batch {b}, flagship shapes, tolerance rel "
        f"{REL_TOL}")
    entry_point_checks(b, geometry, dev)

    # Phase 4: the flagship forward on the kernel path.
    log(f"[flagship] VolumetricTriangulationNet RN-{fl['layers']} "
        f"{fl['image']}^2 x4 views, {fl['volume']}^3, softmax, 17 joints, "
        f"f32, seed 0, batch {b}")
    t0 = time.perf_counter()
    model = VolumetricTriangulationNet(
        num_joints=17, num_layers=fl["layers"], volume_size=fl["volume"],
        cuboid_side=2500.0,
        volume_aggregation_method="softmax", kind="mpii", device=dev, seed=0)
    log(f"  model built in {time.perf_counter() - t0:.1f} s")
    calls = record_launches(lambda: model(images, proj, pelvis))  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    times, outs = [], []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(model(images, proj, pelvis))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    log(f"  launches over {REQUESTS} requests: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for out in outs:
        kp, vols = out.keypoints_3d, out.volumes
        if tuple(kp.shape) != (b, 17, 3) or tuple(vols.shape) != (
                b, 17) + (fl["volume"],) * 3:
            raise AssertionError(f"output shapes {tuple(kp.shape)}, "
                                 f"{tuple(vols.shape)}")
        if not (bool(kp.isfinite().all()) and bool(vols.isfinite().all())):
            raise AssertionError("non-finite flagship output")
    ms = float(np.median(times))
    log(f"  forward ms per request (median of {len(times)}): {ms:.1f}  "
        f"all: {[round(t, 1) for t in times]}  frames/s at batch {b}: "
        f"{b / ms * 1e3:.2f}")

    plain_model = VolumetricTriangulationNet(
        num_joints=17, num_layers=fl["layers"], volume_size=fl["volume"],
        cuboid_side=2500.0,
        use_kernels=False, device=dev, seed=0)
    plain_model.load_state_dict(model.state_dict())
    plain_out = plain_model(images, proj, pelvis)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out = plain_model(images, proj, pelvis)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    log(f"  plain path (PyTorch modules, cuDNN f32): {plain_ms:.1f} ms")
    for i, out in enumerate(outs):
        kp_err = (out.keypoints_3d - plain_out.keypoints_3d).abs().max().item()
        vol_err, vol_rel = rel_err(out.volumes, plain_out.volumes)
        log(f"  request {i}: keypoints max |kernel - plain| {kp_err:.3e} mm; "
            f"volumes max abs {vol_err:.3e} (rel {vol_rel:.3e})")
        if kp_err > KP_TOL_MM or vol_rel > REL_TOL:
            raise AssertionError(f"flagship request {i}: kernel path "
                                 f"disagrees with the plain path")
    del plain_model, plain_out, outs, out
    torch.cuda.empty_cache()

    # Phase 5: every main-path launch shape, kernel vs plain vs library.
    log(f"[kernels] {len(calls)} launches per flagship forward; distinct "
        f"shapes held to rel {REL_TOL}, times summed over one forward")
    per_kernel, per_entry = replay(calls, geometry, dev)
    for entry, e in per_entry.items():
        b_ms, b_by = bound(e["nbytes"], e["flops"])
        log(f"  entry point {entry}: {e['launches']} launches/forward, "
            f"kernels {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max rel err {e['max_rel_err']:.3e}")
    rows = []
    for name in _build.SOURCES:
        k = per_kernel[name]
        b_ms, b_by = bound(k["nbytes"], k["flops"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"lt_tpu_torch/ops/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": k["library_ms"]})
        log(f"  {name}: {launches[name] // REQUESTS} launches/forward, "
            f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, library "
            f"{k['library_ms']}, bound {b_ms:.4f} ms ({b_by}), max rel err "
            f"{k['max_rel_err']:.3e}")
    del model
    torch.cuda.empty_cache()

    # Phase 6: the committed trained fixture (RN-18, 128^2, 32^3).
    fix = ROOT / "tests" / "fixtures" / "vol_rn18_synth.npz"
    im_s, pj_s, kp_s = (torch.from_numpy(a).to(dev) for a in
                        example_batch(1, 4, 128, 17, seed=1))
    outs = []
    for use_kernels in (True, False):
        net = VolumetricTriangulationNet(
            num_joints=17, num_layers=18, volume_size=32, cuboid_side=2500.0,
            use_kernels=use_kernels, device=dev)
        load_volumetric_npz(net, str(fix), num_layers=18)
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

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
