"""ResNet-50 encoder, channels-last: the encoder of Tramba-R.

Port of ``tramba_tpu/models/resnet.py`` (reference
``Models/encoder/resnet_encoder.py:62-110``): a 7x7 stride-2 stem with a
BatchNorm and a 3x3 stride-2 max pool, then four stages of bottleneck blocks
(1x1 -> 3x3 (stride) -> 1x1 x4, each conv followed by a BatchNorm, a 1x1 conv
+ BatchNorm shortcut in each stage's first block).  It returns the stage
outputs deepest first.  Tramba-R feeds its decoder stages 1-3 and asks for
stage 4 only in ``train()``, where its running statistics move as JAX's
``batch_stats`` do (``models/tramba.TrambaEnc``).  The convs run in cuDNN in
the model dtype (no hand-written kernel: JAX leaves them to XLA); ``nn.layers.BatchNorm`` is
flax's BatchNorm.  Module names are torchvision's (``conv1``, ``bn1``,
``layer{i}.{b}.conv{1,2,3}``, ``...bn{1,2,3}``, ``...downsample.{0,1}``), so
a torchvision ``resnet50`` state dict maps onto them key for key.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.nn.layers import BatchNorm, LecunConv2d, conv_nhwc

__all__ = ["ResNetEncoder", "Bottleneck", "resnet50_config"]


def resnet50_config() -> dict:
    """ResNet-50: (3, 4, 6, 3) bottlenecks (``tramba_tpu/models/resnet.py:54``)."""
    return dict(layers=(3, 4, 6, 3))


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return LecunConv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), BatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, 4 * planes, 1), BatchNorm(4 * planes)
        self.downsample = (nn.ModuleList([_conv(cin, 4 * planes, 1, stride),
                                          BatchNorm(4 * planes)]) if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        out = F.relu(self.bn2(conv_nhwc(self.conv2, out)))
        out = self.bn3(conv_nhwc(self.conv3, out))
        if self.downsample is not None:
            x = self.downsample[1](conv_nhwc(self.downsample[0], x))
        return F.relu(out + x)


class ResNetEncoder(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), BatchNorm(64)
        cin = 64
        for i, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}", nn.ModuleList(
                Bottleneck(cin if b == 0 else 4 * planes, planes, stride if b == 0 else 1,
                           has_downsample=b == 0) for b in range(blocks)))
            cin = 4 * planes
        self.n_stages = len(layers)

    def forward(self, x: torch.Tensor, stages: Optional[int] = None) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> [stage 4 (H/32, 2048), stage 3 (H/16, 1024),
        stage 2 (H/8, 512), stage 1 (H/4, 256), stem (H/4, 64)], NHWC in the
        model dtype; with ``stages``, only the stem and the first ``stages``
        stages run and return."""
        h = F.relu(self.bn1(conv_nhwc(self.conv1, x.to(self.dtype))))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        outs = [h]
        for i in range(1, (self.n_stages if stages is None else stages) + 1):
            for blk in getattr(self, f"layer{i}"):
                h = blk(h)
            outs.append(h)
        return outs[::-1]
