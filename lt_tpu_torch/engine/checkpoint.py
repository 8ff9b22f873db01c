"""Checkpoints of the full train state: model, optimizer, step and the
augmentation generator, with ``torch.save``.

Port of ``lt_tpu/engine/checkpoint.py`` (Orbax there): a checkpoint is the
whole train state, so a run resumes exactly where it stopped.  Epoch
directories are ``checkpoints/{epoch:04d}`` as in ``lt_tpu``.

Under data parallelism every rank calls :func:`save_checkpoint`: the
master writes and the others wait for it at a barrier; every rank
restores.  A ``DistributedDataParallel`` model is saved and restored as
the module inside it, so its names carry no ``module.`` and a checkpoint
resumes on any world size.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from lt_tpu_torch.parallel.mesh import barrier, is_master, unwrap

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, model, optimizer, step: int,
                    generator: torch.Generator) -> str:
    """Write the train state to ``directory/state.pt`` on the master, then
    wait for it on every rank; returns the path."""
    path = os.path.join(directory, STATE_FILE)
    if is_master():
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"model": unwrap(model).state_dict(),
                    "optimizer": optimizer.state_dict(), "step": int(step),
                    "generator": generator.get_state()}, tmp)
        os.replace(tmp, path)
    barrier()
    return path


def _load_state(directory: str) -> dict:
    return torch.load(os.path.join(directory, STATE_FILE),
                      map_location="cpu", weights_only=True)


def load_model_state(directory: str) -> dict:
    """The model's state_dict of a state written by
    :func:`save_checkpoint`."""
    return _load_state(directory)["model"]


def restore_checkpoint(directory: str, model, optimizer,
                       generator: torch.Generator) -> int:
    """Load a state written by :func:`save_checkpoint` into ``model``,
    ``optimizer`` and ``generator``; returns the step."""
    state = _load_state(directory)
    unwrap(model).load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"])
    return state["step"]


def resolve_checkpoint_dir(path: str) -> str:
    """Accept an experiment dir, its checkpoints/ dir, or an epoch dir."""
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return path
    cdir = path if os.path.basename(path) == "checkpoints" else os.path.join(
        path, "checkpoints")
    latest = latest_epoch_dir(cdir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return latest


def latest_epoch_dir(checkpoints_dir: str) -> Optional[str]:
    """The newest {epoch:04d} checkpoint directory, if any."""
    if not os.path.isdir(checkpoints_dir):
        return None
    epochs = [d for d in os.listdir(checkpoints_dir) if d.isdigit()]
    if not epochs:
        return None
    return os.path.join(checkpoints_dir, max(epochs, key=int))
