"""Checkpoints: best-MAE weights, the rolling resume dict, reference ``.pth`` files.

Port of ``tramba_tpu/train/checkpoint.py`` with ``torch.save`` in place of
Orbax.  The formats are the reference's (``train.py:248-263``): (a) the
best-MAE weights, a state dict under the reference key names, in
``{method}_MAE_{mae}_{epoch}.pth``; (b) the resume dict ``{model, optimizer,
epoch}``; (c) a reference state dict loads with ``strict=True``.  Tramba-R's
BatchNorm running statistics travel in all three; the reference's
``num_batches_tracked`` is dropped at load and never written.
"""

from __future__ import annotations

import os
import re

import torch

from tramba_tpu_torch.compat.torch_weights import _IGNORABLE, _ignorable

__all__ = ["save_params", "load_checkpoint", "save_resume", "load_resume", "best_mae_path",
           "epoch_from_filename"]


def save_params(path: str, model: torch.nn.Module) -> None:
    """The model's state dict, on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference state dict (or a resume dict's ``model``) with
    ``strict=True``, dropping only what the JAX converter also ignores: the
    weightless buffers (DCT bases, masks, relative-position indices,
    BatchNorm's ``num_batches_tracked``: flax keeps no count and a fixed
    momentum never reads it) and the model's ``checkpoint_ignore`` keys
    (Tramba-S: the stage-4 Swin blocks, never run).  BatchNorm's running
    statistics are buffers of the state dict and load strictly with the
    weights."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    ignore = (*_IGNORABLE, *getattr(model, "checkpoint_ignore", ()))
    sd = {k: v for k, v in sd.items() if not _ignorable(k, ignore)}
    model.load_state_dict(sd, strict=True)


def save_resume(path: str, model: torch.nn.Module, optimizer, epoch: int) -> None:
    """The rolling resume dict: weights, optimizer state and the epoch just done."""
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(), "epoch": int(epoch)}, path)


def load_resume(path: str, model: torch.nn.Module, optimizer) -> int:
    """Restore weights and optimizer state from a resume dict; returns the
    epoch to start from (the one after the saved epoch)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"]) + 1


def best_mae_path(save_dir: str, method: str, mae: float, epoch: int) -> str:
    return os.path.join(save_dir, f"{method}_MAE_{round(float(mae), 4)}_{epoch + 1}.pth")


def epoch_from_filename(path: str) -> int:
    """{method}_MAE_{mae}_{epoch}.{ext} -> epoch (train.py:226-227)."""
    stem = re.sub(r"\.(pth|ckpt)$", "", os.path.basename(path))
    return int(stem.split("_")[-1])
