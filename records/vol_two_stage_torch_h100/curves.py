"""The two-stage recipe's curves on the H100 beside lt_tpu's r5 run.

    python records/vol_two_stage_torch_h100/curves.py [PORT_DIR] [R5_DIR]

PORT_DIR (default: this file's directory) holds the port's
``stage1_metrics.jsonl.gz``, ``stage2_metrics.jsonl.gz`` and
``polish_metrics.jsonl.gz`` (``metrics.jsonl`` of
``python -m lt_tpu_torch.two_stage 600 100 1024`` and of its ``--polish``,
gzipped); R5_DIR (default ``records/vol_two_stage_r5``) lt_tpu's four
``stage2*.jsonl`` segments.  Prints markdown: stage 1's argmax error at
each logged step; for every tenth epoch of stage 2 and the polish, the
val rel MPJPE and the epoch's mean train MAE and volumetric CE beside
lt_tpu's at the same count of training steps (the polish: at the same
epoch of lt_tpu's 30-epoch polish); seconds a step and the time of each
stage's steps.  Reads the files only; numpy and the standard library.
"""

from __future__ import annotations

import gzip
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
R5_SEGMENTS = ("stage2a_256", "stage2b_256_resume", "stage2c_1024",
               "stage2d_2048_polish")


def read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [json.loads(line) for line in f]


def epochs(records):
    """Per epoch in order: (epoch, last step + 1, val rel MPJPE, mean train
    MAE, mean volumetric CE, train records)."""
    out, train = [], []
    for r in records:
        if r["tag"] == "train":
            train.append(r)
        elif r["tag"] == "val_epoch":
            out.append((r["step"], train[-1]["step"] + 1,
                        r["dataset_metric"],
                        float(np.mean([t["MAE"] for t in train])),
                        float(np.mean([t["volumetric_ce_loss"]
                                       for t in train])), train))
            train = []
    return out


def at_step(table, steps):
    """The last epoch of ``table`` that ended at or before ``steps``."""
    done = [e for e in table if e[1] <= steps]
    return done[-1] if done else None


def band_departures(table, r5, column, window=128):
    """The epochs of ``table`` whose ``column`` (3: train MAE, 4: CE) lies
    above / below the range of r5's epochs that ended within ``window``
    steps of the epoch's end."""
    above, below = [], []
    for e in table:
        near = [r[column] for r in r5 if abs(r[1] - e[1]) < window]
        if near and e[column] > max(near):
            above.append(e[0])
        elif near and e[column] < min(near):
            below.append(e[0])
    return above, below


def timing(table):
    """(median seconds a step after the first, the stage's seconds of
    steps, steps)."""
    times = [t["batch_time"] for e in table for t in e[5]]
    return float(np.median(times[1:])), float(np.sum(times)), len(times)


def main(port_dir=HERE, r5_dir="records/vol_two_stage_r5"):
    stage1 = read(os.path.join(port_dir, "stage1_metrics.jsonl.gz"))
    print("| stage-1 step | loss | argmax error (heatmap px) | lr |")
    print("| ---: | ---: | ---: | ---: |")
    for r in stage1:
        print(f"| {r['step']} | {r['loss']:.5f} | {r['argmax_err']:.2f} | "
              f"{r['lr']:.3e} |")
    print(f"\nstage 1: {stage1[-1]['seconds']:.1f} s to step "
          f"{stage1[-1]['step']}\n")

    r5 = epochs([r for seg in R5_SEGMENTS
                 for r in read(os.path.join(r5_dir, seg + ".jsonl"))])
    for name in ("stage2", "polish"):
        table = epochs(read(os.path.join(port_dir,
                                         f"{name}_metrics.jsonl.gz")))
        print(f"| {name} epoch | steps | val rel MPJPE mm | train MAE | CE | "
              "lt_tpu r5 epoch | r5 val mm | r5 train MAE | r5 CE |")
        print("| ---: | ---: | ---: | ---: | ---: | ---: | ---: | ---: | "
              "---: |")
        for i, e in enumerate(table):
            if i % 10 and i != len(table) - 1 and i not in (1, 2, 5):
                continue
            ref = (at_step(r5, e[1]) if name == "stage2"
                   else r5[len(r5) - 30 + i])     # r5's 30 polish epochs
            ref_cols = ("| - | - | - | - |" if ref is None else
                        f"| {ref[0]} | {ref[2]:.1f} | {ref[3]:.2f} | "
                        f"{ref[4]:.3f} |")
            print(f"| {e[0]} | {e[1]} | {e[2]:.1f} | {e[3]:.2f} | "
                  f"{e[4]:.3f} {ref_cols}")
        if name == "stage2":
            for col, what in ((3, "train MAE"), (4, "CE")):
                above, below = band_departures(table, r5, col)
                print(f"\n{what} above r5's band (its epochs within 128 "
                      f"steps) at epochs {above}; below at {below}")
        best = min(table, key=lambda e: e[2])
        step_s, total_s, n = timing(table)
        print(f"\n{name}: final val {table[-1][2]:.2f} mm, best "
              f"{best[2]:.2f} mm at epoch {best[0]}; {n} steps, median "
              f"{step_s * 1e3:.1f} ms a step, {total_s:.0f} s of steps\n")
    print(f"lt_tpu r5 (on its TPU; the curves only): final val "
          f"{r5[-1][2]:.2f} mm after {r5[-1][1]} steps")


if __name__ == "__main__":
    main(*sys.argv[1:])
