"""Tramba-V / -S / -P / -R and BaseUMamba: an encoder + a U-shaped decoder,
channels-last.

Port of ``tramba_tpu/models/tramba.py:78-289`` (reference ``Trambav6.py``,
``Trambav6_enc.py``, ``BaseUMamba.py``): Tramba-V's VSSM encoder, and
``TrambaEnc``'s Swin-B (Tramba-S), PVTv2-b4 (Tramba-P) and ResNet-50
(Tramba-R) encoders with their skip assembly; BaseUMamba, the ablation
baseline, is the VSSM encoder with a decoder of neither guides nor DWMS FFNs.
Each decoder stage upsamples the deep feature (PatchExpand), gates the skip
through a FreqBlock guide (BaseUMamba: the skip as it is), reduces the
concat with a split dense, and runs MultiScaleDecoderBlocks (BaseUMamba:
VSSMDecoderBlocks); deep supervision emits a logit map per stage and
the full-resolution one: 4 maps at 1/16, 1/8, 1/4 and 1/1, Tramba-R's
three-stage decoder 3 at 1/8, 1/4 and 1/1.  The last head is kernel K4
(FinalPatchExpandX4).
``dtype`` (fp32 or bf16) is the compute dtype: the input is cast to it, the
modules run in it and the heads come back in it; parameters stay fp32.
Module names follow the reference state dict (``decoder.expand_layers.{s}``,
``guide_layers`` (none in BaseUMamba), ``concat_back_dim``,
``stage_layers.{s}.blocks.{d}``, ``seg_layers``).  Stochastic depth: encoder
0 -> 0.6, decoder blocks 0.2 -> 0 (``tramba.py:100-134``), guides 0; active
in ``train()`` mode only.
``ssm_backend`` goes to every SS2D (``tramba.py:92-250``): None (the default
kernels) or a backend of ``nn/ssm.BACKENDS``; the parameters are the same.
A forward is the span ``model.forward`` around ``model.encoder`` and
``model.decoder`` (``utils/profiling.span``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.models.pvt import PVTv2Encoder, pvt_v2_b4_config
from tramba_tpu_torch.models.resnet import ResNetEncoder, resnet50_config
from tramba_tpu_torch.models.swin import SwinEncoder, swin_b_384_config
from tramba_tpu_torch.models.vssm_encoder import VSSMEncoder, _Stage
from tramba_tpu_torch.nn.blocks import MultiScaleDecoderBlock, VSSMDecoderBlock
from tramba_tpu_torch.nn.freq import FreqBlock
from tramba_tpu_torch.nn.layers import FinalPatchExpandX4, PatchExpand, check_dtype
from tramba_tpu_torch.utils.profiling import span

__all__ = ["TrambaDecoder", "TrambaV", "TrambaEnc", "BaseUMamba", "window_for_resolution"]

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
    """``features_per_stage``: encoder widths, shallow -> deep.  Each stage's
    concat-dense takes the upsampled deep map (half its width) beside the
    guided skip: 2C -> C for Tramba-V and -S, 256 + 320 -> 320 (and 160 + 128,
    64 + 64) for Tramba-P.  ``use_guides=False`` builds no ``guide_layers``
    and feeds each skip straight to the concat-dense; ``block_type`` is
    ``"ms"`` (MultiScaleDecoderBlock) or ``"plain"`` (VSSMDecoderBlock)
    (``tramba_tpu/models/tramba.py:90-91``: BaseUMamba's decoder is both)."""

    def __init__(self, features_per_stage: Sequence[int], depths: Sequence[int],
                 img_size: int = 384, dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.2, ssm_backend: Optional[str] = None,
                 use_guides: bool = True, block_type: str = "ms"):
        super().__init__()
        blocks = {"ms": MultiScaleDecoderBlock, "plain": VSSMDecoderBlock}
        if block_type not in blocks:
            raise ValueError(f"unknown decoder block type {block_type!r}; use 'ms' or 'plain'")
        chans = list(features_per_stage)
        n = len(chans)
        base_res = img_size // 2 ** n
        # rates by running block index, 0 past the end (tramba.py:100, :134)
        dpr = np.linspace(drop_path_rate, 0, (n - 1) * 2)

        def rate(i):
            return float(dpr[i]) if i < len(dpr) else 0.0

        self.expand_layers = nn.ModuleList(
            [PatchExpand(chans[-(s + 1)]) for s in range(n - 1)] + [FinalPatchExpandX4(chans[0])])
        self.use_guides = use_guides
        if use_guides:
            self.guide_layers = nn.ModuleList(
                FreqBlock(chans[-(s + 2)], window_for_resolution(base_res * 2 ** s), 4,
                          dtype=dtype, ssm_backend=ssm_backend)
                for s in range(n - 1))
        self.concat_back_dim = nn.ModuleList(
            nn.Linear(chans[-(s + 1)] // 2 + chans[-(s + 2)], chans[-(s + 2)])
            for s in range(n - 1))
        self.stage_layers = nn.ModuleList(
            _Stage([blocks[block_type](chans[-(s + 2)], dtype=dtype,
                                       drop_path=rate(sum(depths[:s]) + d),
                                       ssm_backend=ssm_backend)
                    for d in range(depths[s])])
            for s in range(n - 1))
        self.seg_layers = nn.ModuleList(
            [nn.Conv2d(chans[-(s + 2)], 1, 1) for s in range(n - 1)] + [nn.Conv2d(chans[0], 1, 1)])

    def forward(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        x = skips[-1]
        outs = []
        for s in range(len(self.stage_layers)):
            x = self.expand_layers[s](x)
            mid = skips[-(s + 2)]
            if self.use_guides:
                mid = self.guide_layers[s](mid)
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
                 dtype: torch.dtype = torch.float32, enc_drop_path: float = 0.6,
                 dec_drop_path: float = 0.2, ssm_backend: Optional[str] = None):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.vssm_encoder = VSSMEncoder(enc_depths, dims, dtype, enc_drop_path, ssm_backend)
        self.decoder = TrambaDecoder([dims * 2 ** i for i in range(len(enc_depths))],
                                     dec_depths, img_size, dtype, dec_drop_path, ssm_backend)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) normalized image -> 4 logit maps (B, h, w, 1) in the
        model dtype."""
        with span("model.forward"):
            with span("model.encoder"):
                skips = self.vssm_encoder(x.to(self.dtype))
            with span("model.decoder"):
                return self.decoder(skips)


class BaseUMamba(nn.Module):
    """BaseUMamba, the ablation baseline (BaseUMamba.py:14-181,
    ``tramba_tpu/models/tramba.py:256-289``): Tramba-V's VSSM encoder and a
    decoder without guides, whose blocks are VSSMDecoderBlocks (K=8 line
    SS2D + plain MLP)."""

    def __init__(self, img_size: int = 384, dims: int = 128,
                 enc_depths: Sequence[int] = (2, 2, 15, 2),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32, enc_drop_path: float = 0.6,
                 dec_drop_path: float = 0.2, ssm_backend: Optional[str] = None):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.vssm_encoder = VSSMEncoder(enc_depths, dims, dtype, enc_drop_path, ssm_backend)
        self.decoder = TrambaDecoder([dims * 2 ** i for i in range(len(enc_depths))],
                                     dec_depths, img_size, dtype, dec_drop_path, ssm_backend,
                                     use_guides=False, block_type="plain")

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) normalized image -> 4 logit maps (B, h, w, 1) in the
        model dtype."""
        with span("model.forward"):
            with span("model.encoder"):
                skips = self.vssm_encoder(x.to(self.dtype))
            with span("model.decoder"):
                return self.decoder(skips)


class TrambaEnc(nn.Module):
    """Tramba-S (``enc_type="swin"``, Swin-B), Tramba-P (``"pvt"``, PVTv2-b4)
    and Tramba-R (``"resnet"``, ResNet-50) (Trambav6_enc.py:162-230): the
    skips are [image, stage maps shallow -> deep], Swin's the stage inputs
    (its stage-4 output is unused, :212), PVT's its four stage outputs
    (:216), ResNet's its stages 1-3 (the stem's and stage 4's outputs are
    unused, :214).  ``enc_config`` overrides the encoder's configuration
    (``swin_b_384_config`` / ``pvt_v2_b4_config`` / ``resnet50_config``) and
    ``dec_depths`` the decoder's, to cut the model down for tests; the
    decoder's widths are the encoder's stage widths ([128, 256, 512, 1024],
    [64, 128, 320, 512] and [256, 512, 1024], ``tramba.py:229-238``).
    Tramba-R's BatchNorms take batch statistics in ``train()`` and move
    their running ones, as JAX's ``deterministic=False`` with a mutable
    ``batch_stats`` does.  Its stage 4 feeds no head: it runs in ``train()``
    only, for those statistics (in ``eval()`` it is dead code, which XLA
    drops from JAX's jitted forward), and its parameters are frozen, since
    JAX's gradients there are 0 and Adam without decay leaves them as they
    are; frozen, they stay out of DDP's reducer, which would otherwise wait
    for their gradients forever."""

    def __init__(self, enc_type: str, img_size: int = 384, dtype: torch.dtype = torch.float32,
                 enc_config: Optional[dict] = None, dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_drop_path: float = 0.2, ssm_backend: Optional[str] = None):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.enc_type, self.img_size = enc_type, img_size
        if enc_type == "swin":
            cfg = {**swin_b_384_config(), **(enc_config or {})}
            self.encoder = SwinEncoder(img_size, dtype=dtype, **cfg)
            features = [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]
            # the stage-4 blocks of a reference checkpoint: dead compute,
            # never built (compat/torch_weights.py:393)
            self.checkpoint_ignore = (f"encoder.layers.{len(features) - 1}.blocks",)
        elif enc_type == "pvt":
            cfg = {**pvt_v2_b4_config(), **(enc_config or {})}
            self.encoder = PVTv2Encoder(dtype=dtype, **cfg)
            features = list(cfg["embed_dims"])
            self.checkpoint_ignore = ()
        elif enc_type == "resnet":
            cfg = {**resnet50_config(), **(enc_config or {})}
            self.encoder = ResNetEncoder(dtype=dtype, **cfg)
            getattr(self.encoder, f"layer{self.encoder.n_stages}").requires_grad_(False)
            features = [256, 512, 1024]
            self.checkpoint_ignore = ()
        else:
            raise ValueError(f"unsupported encoder type: {enc_type!r}")
        self.decoder = TrambaDecoder(features, dec_depths, img_size, dtype, dec_drop_path,
                                     ssm_backend)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) normalized image -> 4 logit maps (B, h, w, 1) in the
        model dtype."""
        with span("model.forward"):
            with span("model.encoder"):
                x = x.to(self.dtype)
                if self.enc_type == "swin":
                    skips = [x] + self.encoder(x)
                elif self.enc_type == "pvt":
                    skips = [x] + self.encoder(x)[::-1]
                else:
                    n = self.encoder.n_stages
                    outs = self.encoder(x, n if self.training else n - 1)
                    skips = [x] + outs[-4:-1][::-1]  # stages 1-3
            with span("model.decoder"):
                return self.decoder(skips)
