"""One training step and one eval step.

Port of ``tramba_tpu/train/step.py``.  The train step runs the forward in
``train()`` mode (stochastic depth on, drawing from the generator the trainer
gave the DropPath modules), the deep-supervision loss, the backward and the
optimizer step, and returns the loss as a device tensor: no host sync per
step.  The step is the span ``train.step`` around the model's spans,
``train.loss``, ``train.backward`` and the optimizer's ``optim.step``.  The
eval step returns the sigmoid of the full-resolution head.
"""

from __future__ import annotations

from typing import Optional

import torch

from tramba_tpu_torch.train.loss import deep_supervision_loss
from tramba_tpu_torch.utils.profiling import span

__all__ = ["train_step", "eval_step"]


def train_step(model: torch.nn.Module, optimizer, images: torch.Tensor, gts: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """images (B, H, W, 3), gts (B, H, W, 1); returns the detached loss."""
    with span("train.step"):
        model.train()
        optimizer.zero_grad()
        heads = model(images)
        with span("train.loss"):
            loss = deep_supervision_loss(heads, gts, valid)
        del heads  # not held through the backward and the optimizer step
        with span("train.backward"):
            loss.backward()
        optimizer.step()
        return loss.detach()


@torch.no_grad()
def eval_step(model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Sigmoid saliency maps (B, H, W, 1) fp32 from the last head."""
    model.eval()
    return torch.sigmoid(model(images)[-1].float())
