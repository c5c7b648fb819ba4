"""Plain fp32 reference of Tramba's training step: the deep-supervision loss
(BCE + soft IoU on every head, upsampled bilinearly to the mask; reference
``train.py:53-95``) and Adam with optax's arithmetic (``optax.adam`` with a
bf16 first moment, the encoder at 0.1x the LR; ``train.py:266-280``).

:func:`run` follows a whole batch through ``steps`` steps in blocks of rows:
the loss is a mean over samples, so each block's loss is scaled by its share
of the batch and the gradients add up to the whole batch's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tsodbench.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def _bce(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def loss(outs: Sequence[torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    """Sum over heads of (BCE + IoU), each the mean over samples of a
    per-sample mean; heads upsampled with half-pixel centres, no antialias."""
    H, W = gt.shape[1:3]
    total = gt.new_zeros(())
    for o in outs:
        if o.shape[1:3] != (H, W):
            o = F.interpolate(o.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        bce = _bce(o, gt).mean((1, 2, 3)).mean()
        p = torch.sigmoid(o)
        inter = (p * gt).sum((1, 2, 3))
        union = (p + gt).sum((1, 2, 3)) - inter
        total = total + bce + (1.0 - (inter + 1.0) / (union + 1.0)).mean()
    return total


class Adam:
    """optax.adam per named parameter, mu stored in bf16: in fp32,
    mu = bf16(b1) * mu (rounded to bf16 first) + (1 - b1) g;
    nu = b2 nu + (1 - b2) g^2; p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float]):
        self.lrs = lrs
        self.mu = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> None:
        self.n += 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.n))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.n))
        b1_mu = float(torch.tensor(B1, dtype=torch.bfloat16))
        for name, p in params.items():
            g = p.grad.float()
            mu = (self.mu[name] * b1_mu).float() + g * (1 - B1)
            self.nu[name] = self.nu[name] * B2 + g * g * (1 - B2)
            upd = (mu / bc1) / ((self.nu[name] / bc2).sqrt() + EPS)
            p.add_(upd * -self.lrs[name])
            self.mu[name] = mu.to(torch.bfloat16)


def lr_of(name: str, base_lr: float, encoder_scale: float) -> float:
    """The fp32 LR of a parameter's group: the encoder's ("encoder" in the
    name) at ``encoder_scale`` times the base."""
    scale = encoder_scale if "encoder" in name.lower() else 1.0
    return float(np.float32(base_lr * scale))


def drop_masks(rates: Sequence[float], B: int, gen: torch.Generator, device) -> List[torch.Tensor]:
    """One (B,) multiplier per dropped branch, drawn as the program draws
    them: a uniform per sample, kept below 1 - rate, divided by 1 - rate."""
    out = []
    for r in rates:
        keep = 1.0 - r
        out.append((torch.rand((B,), generator=gen, device=device) < keep).float() / keep)
    return out


def run(cfg: dict, P0: Dict[str, torch.Tensor], batches, steps: int, rates: Sequence[float],
        drop_seed: int, base_lr: float, encoder_scale: float, rows: int, quant=None,
        keep_rows=None, frozen: Sequence[str] = ()) -> dict:
    """``steps`` training steps from the parameters ``P0`` on ``batches``
    [(images, masks)], the DropPath draws from a generator seeded
    ``drop_seed`` on the batches' device.  Planted faults: ``keep_rows``, the
    rows of each batch that enter the loss (None: all); ``frozen``, the
    parameters Adam leaves unchanged.  Returns
    {"loss": [per step], "grad_norm": {name: the first step's gradient
    norm}, "params": the parameters after the steps}."""
    device = batches[0][0].device
    params = {n: p.detach().clone().requires_grad_(True) for n, p in P0.items()}
    frozen = set(frozen)
    opt = Adam(params, {n: 0.0 if n in frozen else lr_of(n, base_lr, encoder_scale)
                        for n in params})
    gen = torch.Generator(device=device).manual_seed(drop_seed)
    losses, grad_norm = [], {}
    with ref.exact_fp32():
        for s in range(steps):
            images, gts = batches[s]
            B = images.shape[0]
            masks = drop_masks(rates, B, gen, device)
            sel = torch.arange(B, device=device) if keep_rows is None else keep_rows
            n = sel.numel()
            for p in params.values():
                p.grad = None
            total = 0.0
            for i in range(0, n, rows):
                r = sel[i:i + rows]
                ctx = ref.Ctx(quant, drop=[m[r] for m in masks])
                part = loss(ref.forward(ctx, params, cfg, images[r]), gts[r].float())
                (part * (r.numel() / n)).backward()
                total += part.item() * r.numel() / n
            losses.append(total)
            if s == 0:
                grad_norm = {k: p.grad.double().norm().item() for k, p in params.items()}
            opt.step(params)
    return {"loss": losses, "grad_norm": grad_norm,
            "params": {k: p.detach() for k, p in params.items()}}
