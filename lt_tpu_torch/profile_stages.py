"""Where the flagship forward's, or training step's, time goes on the card.

    python -m lt_tpu_torch.profile_stages [--batch 8] [--bf16]
    python -m lt_tpu_torch.profile_stages --train [--batch 5]

Times warm requests of the volumetric forward (RN-152, 384^2, 4 views,
64^3, f32 with TF32 off or, with ``--bf16``, the bfloat16 eval
configuration; seeded random weights) split by stage with CUDA events on
module hooks (backbone, coord volumes, process_features, unprojection and
within it the kernel step, K1 with its matrices and view mask, V2V,
soft-argmax; the median of three requests after two warm-up ones), each
beside the host clock's time between the same marks,
then traces one more request with ``torch.profiler`` and prints the
device's busy share of the window and the kernels that take the most
device time.  ``--train`` does the same for training steps of
experiments/human36m/train/human36m_vol_softmax.yaml
(forward stages, loss, backward, Adam) on the kernel path, and prints the
peak device memory.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from lt_tpu_torch import resolve_device
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_batch, example_train_batch

# The flagship shape: ResNet-152 at 384^2, a 64^3 volume.
LAYERS, IMAGE, VOLUME = 152, 384, 64
WARMUP, TIMED = 2, 3        # runs before timing; timed runs (the median's
                            # split is printed)
TRAIN_YAML = (Path(__file__).resolve().parents[1] / "experiments" / "human36m"
              / "train" / "human36m_vol_softmax.yaml")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8, or the training config's 5 with --train")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of a request")
    ap.add_argument("--bf16", action="store_true",
                    help="the bfloat16 eval configuration (requests only)")
    args = ap.parse_args(argv)
    if args.train and args.bf16:
        ap.error("training runs in float32 only")

    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        config = cfg.load_config(str(TRAIN_YAML),
                                 {"model.backbone.init_weights": False})
        args.batch = args.batch or config.opt.batch_size
        model = factory.make_model(config, device=dev)
        criterion = factory.make_criterion(config)
        optimizer = factory.make_optimizer(config, model)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 example_train_batch(args.batch, IMAGE, 17).items()}

        def run():
            model.train()
            out = steps.model_outputs(model, batch, config)
            total, _ = steps.compute_losses(criterion, config, out, batch)
            mark("loss:end")()
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            mark("backward:end")()
            optimizer.step()
    else:
        args.batch = args.batch or 8
        model = VolumetricTriangulationNet(
            num_layers=LAYERS, volume_size=VOLUME, device=dev,
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
        inputs = [torch.from_numpy(a).to(dev)
                  for a in example_batch(args.batch, 4, IMAGE, 17)]

        def run():
            model(*inputs)

    stages = [("backbone", model.backbone),
              ("process_features", model.process_features),
              ("unproject", model.unproject),
              ("v2v", model.volume_net)]
    events, host = {}, {}

    def mark(key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[key] = ev
            host[key] = time.perf_counter()
        return hook

    def span(a, b):
        return events[a].elapsed_time(events[b])

    def timed_run():
        """One run between events; its split by stage (device ms, and the
        host's ms between the same marks), total and wall ms."""
        mark("run:start")()
        t0 = time.perf_counter()
        run()
        mark("run:end")()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        bounds = {
            "input layout": ("run:start", "backbone:start"),
            "backbone": ("backbone:start", "backbone:end"),
            "coord volumes": ("backbone:end", "process_features:start"),
            "process_features": ("process_features:start",
                                 "process_features:end"),
            "unprojection": ("process_features:end", "v2v:start"),
            "  of it: layout, grid affine": ("process_features:end",
                                             "unproject:start"),
            "  of it: m, mask, K1": ("unproject:start", "unproject:end"),
            "v2v": ("v2v:start", "v2v:end"),
        }
        split = {k: (span(a, b), (host[b] - host[a]) * 1e3)
                 for k, (a, b) in bounds.items()}
        tail = ([("soft-argmax + losses", "v2v:end", "loss:end"),
                 ("backward (K5, K6 in it)", "loss:end", "backward:end"),
                 ("Adam step", "backward:end", "run:end")] if args.train
                else [("soft-argmax", "v2v:end", "run:end")])
        for k, a, b in tail:
            split[k] = (span(a, b), (host[b] - host[a]) * 1e3)
        return split, span("run:start", "run:end"), wall

    # Warm-up (cuDNN's plans, V2V's packing, kernels loaded at first
    # launch): the first two requests after start-up are slower and vary.
    for _ in range(WARMUP):
        run()
    handles = []
    for name, mod in stages:
        handles.append(mod.register_forward_pre_hook(mark(f"{name}:start")))
        handles.append(mod.register_forward_hook(mark(f"{name}:end")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = sorted((timed_run() for _ in range(TIMED)), key=lambda r: r[1])
    split, total, wall = runs[len(runs) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in handles:
        h.remove()
    print(f"{torch.cuda.get_device_name(0)}; batch {args.batch}, RN-"
          f"{LAYERS} {IMAGE}^2, {VOLUME}^3, "
          f"{'bfloat16' if args.bf16 else 'float32'}; "
          f"{'training step' if args.train else 'request'} {total:.1f} ms on "
          f"device events (median of {TIMED}: "
          f"{[round(r[1], 1) for r in runs]}), {wall:.1f} ms on the host "
          f"clock; peak memory {peak:.2f} GiB")
    print(f"  {'stage':36s} {'device':>9s}     {'share':>5s}  {'host':>9s}")
    for name, (ms, host_ms) in split.items():
        print(f"  {name:36s} {ms:9.2f} ms  {100 * ms / total:5.1f}%  "
              f"{host_ms:9.2f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only (an operator's row would count its kernels again, and
    # a user annotation such as Optimizer.step#Adam.step spans kernels).
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("torch.profiler recorded no device time; see the event split")
        return
    print(f"torch.profiler: device busy {busy_us / 1e3:.1f} ms of a "
          f"{window_us / 1e3:.1f} ms window ({100 * busy_us / window_us:.1f}%"
          f" busy, {100 - 100 * busy_us / window_us:.1f}% idle)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
