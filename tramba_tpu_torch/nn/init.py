"""Seeded weight init, following the JAX package's initializers.

Linear weights: truncated normal, std 0.02 (VSSMEncoder._init_weights,
vmamba.py:459-471); conv weights: kaiming normal (a=1e-2, fan_in); biases 0;
LayerNorm 1 / 0; BatchNorm scale 1, bias 0 and running statistics 0 / 1, as
flax's ``nn.BatchNorm`` starts.  A module that draws its own parameters
otherwise (SS2D, the PVTv2, Swin and ResNet encoders' ``LecunConv2d``, Swin's
``WindowAttention``) has a ``reset_own_parameters(generator)`` method, which
is called instead.  Every draw comes from the one ``torch.Generator`` passed
in, in module order.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tramba_tpu_torch.nn.layers import BatchNorm

__all__ = ["init_weights"]


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in model.modules():
        if hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(generator)
        elif isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / (1.0 + 1e-2 ** 2)) / math.sqrt(fan_in)
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
