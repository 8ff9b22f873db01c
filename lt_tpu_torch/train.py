"""CLI: train or evaluate the volumetric model with the port, on an NVIDIA
GPU (``--device cpu`` runs the kernels' plain versions on the CPU).

The flags of the repository's ``train.py``:

    python -m lt_tpu_torch.train --config experiments/synthetic/vol_tiny_2stage.yaml --logdir ./logs
    python -m lt_tpu_torch.train --eval --eval_dataset val --config ... --logdir ...
    python -m lt_tpu_torch.train --resume ./logs/<experiment> --config ...
"""

from __future__ import annotations

import argparse

from lt_tpu_torch.engine.train import run


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str, required=True,
                        help="Path to a YAML experiment config")
    parser.add_argument("--eval", action="store_true",
                        help="Only run evaluation")
    parser.add_argument("--eval_dataset", type=str, default="val",
                        choices=("train", "val"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--logdir", type=str, default="./logs")
    parser.add_argument("--resume", type=str, default=None,
                        help="Previous experiment dir: restore its newest "
                             "epoch checkpoint and continue training")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="Cap config.opt.n_epochs (smoke runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    return run(args.config, args.logdir, eval_only=args.eval,
               eval_dataset=args.eval_dataset, seed=args.seed,
               max_epochs=args.max_epochs, resume_dir=args.resume,
               device=args.device)


if __name__ == "__main__":
    main()
