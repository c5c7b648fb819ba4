"""Tramba-V: VSSM encoder + DFVSS-guided decoder, channels-last, eval only.

Port of ``tramba_tpu/models/tramba.py:78-200`` (reference ``Trambav6.py``).
Each decoder stage upsamples the deep feature (PatchExpand), gates the skip
through a FreqBlock guide, reduces the concat with a split dense, and runs
MultiScaleDecoderBlocks; deep supervision emits 4 logit maps at 1/16, 1/8,
1/4 and full resolution.  The last head is kernel K4 (FinalPatchExpandX4).
``dtype`` (fp32 or bf16) is the compute dtype: the input is cast to it, the
modules run in it and the heads come back in it; parameters stay fp32.
Module names follow the reference state dict (``decoder.expand_layers.{s}``,
``guide_layers``, ``concat_back_dim``, ``stage_layers.{s}.blocks.{d}``,
``seg_layers``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.models.vssm_encoder import VSSMEncoder, _Stage
from tramba_tpu_torch.nn.blocks import MultiScaleDecoderBlock
from tramba_tpu_torch.nn.freq import FreqBlock
from tramba_tpu_torch.nn.layers import FinalPatchExpandX4, PatchExpand, check_dtype

__all__ = ["TrambaDecoder", "TrambaV", "window_for_resolution"]

# high-frequency window size per resolution (csms6s.py:107-111)
_WINDOW_BY_RES = {12: 4, 24: 8, 48: 12, 96: 16}


def window_for_resolution(res: int) -> int:
    if res in _WINDOW_BY_RES:
        return _WINDOW_BY_RES[res]
    # fallback: the divisor of res nearest res/5 (the reference defines none)
    target = max(2, res // 5)
    divs = [d for d in range(2, res + 1) if res % d == 0]
    return min(divs, key=lambda d: abs(d - target))


class TrambaDecoder(nn.Module):
    """``features_per_stage``: encoder widths, shallow -> deep."""

    def __init__(self, features_per_stage: Sequence[int], depths: Sequence[int],
                 img_size: int = 384, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = list(features_per_stage)
        n = len(chans)
        base_res = img_size // 2 ** n
        self.expand_layers = nn.ModuleList(
            [PatchExpand(chans[-(s + 1)]) for s in range(n - 1)] + [FinalPatchExpandX4(chans[0])])
        self.guide_layers = nn.ModuleList(
            FreqBlock(chans[-(s + 2)], window_for_resolution(base_res * 2 ** s), 4, dtype=dtype)
            for s in range(n - 1))
        self.concat_back_dim = nn.ModuleList(
            nn.Linear(2 * chans[-(s + 2)], chans[-(s + 2)]) for s in range(n - 1))
        self.stage_layers = nn.ModuleList(
            _Stage([MultiScaleDecoderBlock(chans[-(s + 2)], dtype=dtype)
                    for _ in range(depths[s])])
            for s in range(n - 1))
        self.seg_layers = nn.ModuleList(
            [nn.Conv2d(chans[-(s + 2)], 1, 1) for s in range(n - 1)] + [nn.Conv2d(chans[0], 1, 1)])

    def forward(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        x = skips[-1]
        outs = []
        for s in range(len(self.guide_layers)):
            x = self.expand_layers[s](x)
            mid = self.guide_layers[s](skips[-(s + 2)])
            # concat + dense as two products on the weight's halves
            lin = self.concat_back_dim[s]
            up = x.shape[-1]
            w = lin.weight.to(x.dtype)
            x = x @ w[:, :up].t() + mid @ w[:, up:].t() + lin.bias.to(x.dtype)
            x = self.stage_layers[s](x)
            seg = self.seg_layers[s]
            outs.append(F.linear(x, seg.weight.reshape(1, -1).to(x.dtype), seg.bias.to(x.dtype)))
        outs.append(self.expand_layers[-1](x, self.seg_layers[-1]))
        return outs


class TrambaV(nn.Module):
    """Tramba-V (Trambav6.py:142-200)."""

    def __init__(self, img_size: int = 384, dims: int = 128,
                 enc_depths: Sequence[int] = (2, 2, 15, 2),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.vssm_encoder = VSSMEncoder(enc_depths, dims, dtype)
        self.decoder = TrambaDecoder([dims * 2 ** i for i in range(len(enc_depths))],
                                     dec_depths, img_size, dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) normalized image -> 4 logit maps (B, h, w, 1) in the
        model dtype."""
        return self.decoder(self.vssm_encoder(x.to(self.dtype)))
