"""Training losses: deep-supervision BCE + soft IoU, and the edge-weighted losses.

Port of ``tramba_tpu/train/loss.py`` (reference ``utils/loss.py:6-42`` and
``train.py:53-95``).  Tensors are channels-last (B, H, W, 1); every loss
computes in fp32.  The heads are upsampled to the mask's size by bilinear
interpolation with half-pixel centres and no antialiasing, which is what
``jax.image.resize(..., "bilinear")`` does when it upsamples.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["bce_with_logits", "iou_loss", "resize_bilinear", "deep_supervision_loss",
           "structure_loss", "weighted_bce"]


def _bce(logits, targets):
    """Elementwise stable BCE on logits: max(x, 0) - x t + log1p(e^-|x|)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss semantics)."""
    return _bce(logits.float(), targets.float()).mean()


def iou_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft IoU on sigmoid predictions, per sample over all other axes, then
    the mean: 1 - (inter + 1) / (union + 1)."""
    pred = torch.sigmoid(logits.float())
    targets = targets.float()
    axes = tuple(range(1, pred.ndim))
    inter = (pred * targets).sum(axes)
    union = (pred + targets).sum(axes) - inter
    return (1.0 - (inter + 1.0) / (union + 1.0)).mean()


def resize_bilinear(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C), bilinear with half-pixel centres, in
    x's dtype.  A bf16 x is resized in fp32 and the result rounded to bf16,
    as ``jax.image.resize`` computes it, so that the backward, too, adds each
    source pixel's contributions in fp32 (CUDA's bf16 interpolate backward
    adds them in bf16 atomics: at 24 -> 384 px about a thousand per pixel)."""
    if x.shape[1] == H and x.shape[2] == W:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(H, W), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def deep_supervision_loss(outputs: Sequence[torch.Tensor], gt: torch.Tensor,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over heads of (BCE + IoU), each head upsampled to the mask's size.

    ``valid``: optional (B,) 0/1 weights; rows of weight 0 (padding) drop out
    and each mean renormalises over the real rows."""
    H, W = gt.shape[1], gt.shape[2]
    gtf = gt.float()
    w = gtf.new_ones(gt.shape[0]) if valid is None else valid.float()
    denom = w.sum().clamp_min(1.0)
    axes = tuple(range(1, gt.ndim))
    total = gtf.new_zeros(())
    for out in outputs:
        up = resize_bilinear(out, H, W).float()
        bce = (w * _bce(up, gtf).mean(axes)).sum() / denom
        pred = torch.sigmoid(up)
        inter = (pred * gtf).sum(axes)
        union = (pred + gtf).sum(axes) - inter
        iou = (w * (1.0 - (inter + 1.0) / (union + 1.0))).sum() / denom
        total = total + bce + iou
    return total


def _box_mean(mask, k):
    """k x k box mean with zero padding counted (torch avg_pool2d's default),
    channels-last."""
    y = F.avg_pool2d(mask.permute(0, 3, 1, 2), k, stride=1, padding=k // 2,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def structure_loss(logits: torch.Tensor, mask: torch.Tensor, weight=None) -> torch.Tensor:
    """Edge-weighted BCE + weighted IoU on a smoothed mask (utils/loss.py:15-34)."""
    logits, mask = logits.float(), mask.float()
    weit = 1 + 5 * ((_box_mean(mask, 31) - mask).abs() if weight is None else weight)
    eps = 0.001
    smooth = (1 - eps) * mask + eps / 2
    axes = (1, 2, 3)
    wbce = (weit * _bce(logits, smooth)).sum(axes) / weit.sum(axes)
    pred = torch.sigmoid(logits)
    inter = (pred * mask * weit).sum(axes)
    union = ((pred + mask) * weit).sum(axes)
    wiou = 1 - (inter + 1) / (union - inter + 1)
    return (wbce + wiou).mean()


def weighted_bce(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Edge-weighted BCE with a 15 x 15 context window (utils/loss.py:38-42)."""
    logits, mask = logits.float(), mask.float()
    weit = 1 + 5 * (_box_mean(mask, 15) - mask).abs()
    axes = (1, 2, 3)
    return ((weit * _bce(logits, mask)).sum(axes) / weit.sum(axes)).mean()
