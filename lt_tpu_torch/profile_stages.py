"""Where the flagship forward's time goes on the card.

    python -m lt_tpu_torch.profile_stages [--batch 8]

Times one warm request of the volumetric forward (RN-152, 384^2, 4 views,
64^3, f32, TF32 off, seeded random weights) split by stage with CUDA
events on module hooks (backbone, coord volumes, process_features,
unprojection, V2V, soft-argmax), then traces one more request with
``torch.profiler`` and prints the device's busy share of the window and the
kernels that take the most device time.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.utils.example import example_batch

# The flagship shape: ResNet-152 at 384^2, a 64^3 volume.
LAYERS, IMAGE, VOLUME = 152, 384, 64


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = VolumetricTriangulationNet(num_layers=LAYERS, volume_size=VOLUME,
                                       device=dev)
    inputs = [torch.from_numpy(a).to(dev)
              for a in example_batch(args.batch, 4, IMAGE, 17)]
    model(*inputs)                                  # warm-up (cuDNN, packing)

    stages = [("backbone", model.backbone),
              ("process_features", model.process_features),
              ("v2v", model.volume_net)]
    events = {}

    def mark(key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[key] = ev
        return hook

    handles = []
    for name, mod in stages:
        handles.append(mod.register_forward_pre_hook(mark(f"{name}:start")))
        handles.append(mod.register_forward_hook(mark(f"{name}:end")))
    torch.cuda.synchronize()
    mark("forward:start")()
    t0 = time.perf_counter()
    model(*inputs)
    mark("forward:end")()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for h in handles:
        h.remove()

    def span(a, b):
        return events[a].elapsed_time(events[b])

    split = {
        "input layout": span("forward:start", "backbone:start"),
        "backbone": span("backbone:start", "backbone:end"),
        "coord volumes": span("backbone:end", "process_features:start"),
        "process_features": span("process_features:start",
                                 "process_features:end"),
        "unprojection (K1)": span("process_features:end", "v2v:start"),
        "v2v (K2-K4)": span("v2v:start", "v2v:end"),
        "soft-argmax": span("v2v:end", "forward:end"),
    }
    total = span("forward:start", "forward:end")
    print(f"{torch.cuda.get_device_name(0)}; batch {args.batch}, RN-"
          f"{LAYERS} {IMAGE}^2, {VOLUME}^3; request "
          f"{total:.1f} ms on device events, {wall:.1f} ms on the host clock")
    for name, ms in split.items():
        print(f"  {name:36s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(*inputs)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only (an operator's row would count its kernels again).
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("torch.profiler recorded no device time; see the event split")
        return
    print(f"torch.profiler: device busy {busy_us / 1e3:.1f} ms of a "
          f"{window_us / 1e3:.1f} ms window ({100 * busy_us / window_us:.1f}%"
          f" busy, {100 - 100 * busy_us / window_us:.1f}% idle)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
