"""One training step and one eval step.

Port of ``tramba_tpu/train/step.py``.  The train step runs the forward in
``train()`` mode (stochastic depth on, drawing from the generator the trainer
gave the DropPath modules), the deep-supervision loss, the backward and the
optimizer step, and returns the loss as a device tensor: no host sync per
step.  The eval step returns the sigmoid of the full-resolution head.
"""

from __future__ import annotations

from typing import Optional

import torch

from tramba_tpu_torch.train.loss import deep_supervision_loss

__all__ = ["train_step", "eval_step"]


def train_step(model: torch.nn.Module, optimizer, images: torch.Tensor, gts: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """images (B, H, W, 3), gts (B, H, W, 1); returns the detached loss."""
    model.train()
    optimizer.zero_grad()
    loss = deep_supervision_loss(model(images), gts, valid)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Sigmoid saliency maps (B, H, W, 1) fp32 from the last head."""
    model.eval()
    return torch.sigmoid(model(images)[-1].float())
