"""Shared building blocks, channels-last (B, H, W, C).

Port of ``tramba_tpu/nn/layers.py``.  Parameter names follow the reference
PyTorch modules (``Models/modules.py``, ``Models/vmamba.py``), so reference
state dicts load as they are.  ``DropPath`` (stochastic depth) is active in
``train()`` mode only and draws from the generator the trainer gives it.

Compute dtype: parameters stay fp32 whatever the model's dtype, as flax
keeps them; a module running in bf16 casts each matmul or conv weight at its
use (flax's ``w.astype(dtype)``; the kernels' wrappers cast the fp32
parameters they are handed), and LayerNorm computes in fp32 and returns the
input's dtype.  The FFNs take a ``dtype`` and in bf16 run kernels K6
(``Mlp``) and K7 (``DWMSMlp``) with the block's pre-norm fused in, and
under autograd their backwards K9 and K10.  ``flax_dense`` and
``flax_conv`` apply a Linear or Conv2d with the rounding points of flax's
``nn.Dense`` / ``nn.Conv`` in a compute dtype, for the composed parts of the
PVTv2 and Swin encoders.  ``BatchNorm`` is flax's ``nn.BatchNorm`` (the
ResNet-50 encoder's): fp32 statistics, the running variance updated with
the biased batch variance.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.ops import fused_mlp
from tramba_tpu_torch.ops.fused_expand import expand_ln, final_head, pixel_shuffle

__all__ = [
    "COMPUTE_DTYPES",
    "BatchNorm",
    "LayerNorm",
    "LecunConv2d",
    "check_dtype",
    "conv_nhwc",
    "flax_conv",
    "flax_dense",
    "DropPath",
    "set_drop_path_generator",
    "Mlp",
    "DWConv",
    "DWMSMlp",
    "PatchExpand",
    "FreqExpand2D",
    "FinalPatchExpandX4",
    "pixel_shuffle",
]


# the model dtypes the port runs: fp32, and bf16 (the kernels K5-K7 path)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype} is not supported; use one of {COMPUTE_DTYPES}")
    return dtype


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the channel axis, eps 1e-5 unless given (PVTv2's block
    norms take 1e-6): fp32 parameters and statistics, output in the input's
    dtype (flax ``LayerNorm(dtype=...)``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel axis
    of an NHWC tensor.  Parameters ``weight`` / ``bias`` and buffers
    ``running_mean`` / ``running_var`` under torch's names (torchvision's
    state dict loads as it is; its ``num_batches_tracked`` has no
    counterpart, flax keeps no count).  The statistics and the normalisation
    are fp32 and only the output is rounded to the input's dtype, as flax
    computes them.  ``train()``: batch statistics, and the running ones move
    by ``0.9 r + 0.1 s`` with the *biased* batch variance, as flax updates
    them (``torch.nn.BatchNorm2d`` takes the unbiased one, n / (n - 1)
    larger); ``eval()``: the running statistics."""

    MOMENTUM, EPS = 0.9, 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        xf = x.float().permute(0, 3, 1, 2)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
                self.running_mean.lerp_(mean, 1 - self.MOMENTUM)
                self.running_var.lerp_(var, 1 - self.MOMENTUM)
            y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0, self.EPS)
        else:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.EPS)
        return y.permute(0, 2, 3, 1).to(x.dtype)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor in x's dtype (weight and
    bias cast at use); returns NHWC."""
    b = conv.bias
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 None if b is None else b.to(x.dtype), conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return y.permute(0, 2, 3, 1)


class LecunConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` that ``nn.init.init_weights`` draws as flax's default
    conv init (lecun normal), where the JAX package leaves ``nn.Conv`` its
    default: the PVTv2 and Swin encoders."""

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        """flax's variance_scaling(1, fan_in, truncated_normal): normal
        truncated at 2 sigma, scaled to variance 1 / fan_in; bias 0."""
        std = math.sqrt(1.0 / self.weight[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


def flax_dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` as flax's ``nn.Dense(dtype=dtype)``: x and the weight cast to
    ``dtype``; in bf16 the product is rounded before the bias is added in
    bf16 (a second rounding)."""
    x = x.to(dtype)
    if dtype == torch.float32:
        return lin(x)
    y = x @ lin.weight.to(dtype).t()
    return y if lin.bias is None else y + lin.bias.to(dtype)


def flax_conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC ``conv`` as flax's ``nn.Conv(dtype=dtype)``: in bf16 the bias is
    added after the conv's rounding."""
    x = x.to(dtype)
    if dtype == torch.float32 or conv.bias is None:
        return conv_nhwc(conv, x)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dtype), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1) + conv.bias.to(dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics, ``tramba_tpu/nn/layers.py:49-64``):
    in ``train()`` mode each sample keeps its branch with probability
    ``1 - rate``, divided by that probability, or drops it to 0; the identity
    in ``eval()`` mode.  The Bernoulli draws come from ``self.generator`` (on
    the input's device; torch's default generator when None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def extra_repr(self) -> str:
        return f"rate={self.rate}"

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_drop_path_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Give every DropPath of ``model`` the one generator its draws come from."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator


class Mlp(nn.Module):
    """The block FFN with its pre-norm: LN -> fc1 -> exact GELU -> fc2
    (modules.py:134-153).  bf16: kernel K6 ``ln_mlp``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, norm: nn.LayerNorm):
        if self.dtype == torch.bfloat16:
            return fused_mlp.ln_mlp(x, norm.weight, norm.bias, self.fc1.weight, self.fc1.bias,
                                    self.fc2.weight, self.fc2.bias)
        return self.fc2(F.gelu(self.fc1(norm(x))))


class DWConv(nn.Module):
    """Depthwise k x k conv with SAME padding (vmamba.py:595-603)."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.dw_conv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)

    def forward(self, x):
        return conv_nhwc(self.dw_conv, x)


class DWMSMlp(nn.Module):
    """Multi-scale depthwise FFN with its pre-norm: LN -> fc1 -> h + dw3 + dw5
    + dw7 -> GELU -> fc2 (vmamba.py:606-629).  bf16: kernel K7
    ``ln_dwms_mlp``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.fc1 = nn.Linear(dim, hidden)
        self.dwc3 = DWConv(hidden, 3)
        self.dwc5 = DWConv(hidden, 5)
        self.dwc7 = DWConv(hidden, 7)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, norm: nn.LayerNorm):
        if self.dtype == torch.bfloat16:
            convs = [t for m in (self.dwc3, self.dwc5, self.dwc7)
                     for t in (m.dw_conv.weight, m.dw_conv.bias)]
            return fused_mlp.ln_dwms_mlp(x, norm.weight, norm.bias, self.fc1.weight,
                                         self.fc1.bias, *convs, self.fc2.weight, self.fc2.bias)
        h = self.fc1(norm(x))
        h = h + self.dwc3(h) + self.dwc5(h) + self.dwc7(h)
        return self.fc2(F.gelu(h))


class _Expand(nn.Module):
    """Dense dim -> factor*dim (no bias), x2 pixel shuffle, LayerNorm: kernel K3."""

    def __init__(self, dim: int, factor: int):
        super().__init__()
        self.expand = nn.Linear(dim, factor * dim, bias=False)
        self.norm = LayerNorm(factor * dim // 4)

    def forward(self, x):
        return expand_ln(x.contiguous(), self.expand.weight.to(x.dtype), self.norm.weight,
                         self.norm.bias)


class PatchExpand(_Expand):
    """x2 upsample, dim -> dim/2 channels (modules.py:183-221)."""

    def __init__(self, dim: int):
        super().__init__(dim, 2)


class FreqExpand2D(_Expand):
    """DFVSS x2 upsample, dim -> dim channels (modules.py:678-696)."""

    def __init__(self, dim: int):
        super().__init__(dim, 4)


class FinalPatchExpandX4(nn.Module):
    """x4 upsample (Dense dim -> 16dim, pixel shuffle, LN; modules.py:224-274)
    fused with the 1x1 seg conv that follows it: kernel K4 computes the 16
    logits of each coarse pixel, and they are laid out as its 4 x 4 patch."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x, seg: nn.Conv2d):
        B, h, w, C = x.shape
        seg16 = final_head(x.contiguous(), self.expand.weight.to(x.dtype), self.norm.weight,
                           self.norm.bias, seg.weight.reshape(C), seg.bias)
        seg16 = seg16.reshape(B, h, w, 4, 4, 1).permute(0, 1, 3, 2, 4, 5)
        return seg16.reshape(B, 4 * h, 4 * w, 1)
