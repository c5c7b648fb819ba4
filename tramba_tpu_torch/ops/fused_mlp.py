"""Block FFNs of the bf16 path: kernel K6 ``ln_mlp`` and kernel K7 ``ln_dwms_mlp``.

Port of ``tramba_tpu/ops/fused_mlp.py``: ``_mlp_pallas`` (:130, kernel :115)
and ``_dwms_pallas`` (:360, kernel :312).  Each fuses the block's pre-norm
into the FFN and keeps the 4x-wide hidden tensor out of device memory
(``csrc/mlp.cu``):

* K6 ``ln_mlp``: LN -> fc1 -> exact GELU -> fc2 (VSSBlock and FreqBlock FFN).
* K7 ``ln_dwms_mlp``: LN -> fc1 -> h + dw3(h) + dw5(h) + dw7(h) -> GELU ->
  fc2 (MultiScaleDecoderBlock FFN); the depthwise convs pad h, not x.

The kernels take bf16 activations and matmul/conv weights, and fp32
LayerNorm parameters and biases; they round where the TPU kernels round:
LN output, GELU output and the result to bf16, everything else in fp32
(h in K7 stays fp32 through the depthwise convs).  The plain versions
(``*_ref``) do fp32 math on operands rounded to ``x``'s dtype and round at
the same points, so for fp32 inputs they are the plain fp32 FFNs.  The
wrappers pick by device (CPU tensors: the plain version; CUDA tensors: the
kernel or an error) and count launches in ``<wrapper>.launches``.  Weights
are in torch layout: Linear (out, in), depthwise Conv2d (C, 1, k, k).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, F32, check_args, on_card

__all__ = ["layer_norm_bf16", "ln_mlp", "ln_mlp_ref", "ln_dwms_mlp", "ln_dwms_mlp_ref"]


def _ln_rounded(x, ln_w, ln_b):
    """LayerNorm over the last axis in fp32 (eps 1e-5), rounded to x's dtype,
    returned as fp32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln_w.float(), ln_b.float(), 1e-5)
    return y.to(x.dtype).float()


def _linear(x32, w, cd):
    """fp32 product of an fp32 tensor with a weight rounded to ``cd``."""
    return x32 @ w.to(cd).float().t()


@functools.lru_cache(maxsize=None)
def _splits(name: str, device: int, *shape) -> int:
    """Splits of the hidden dimension that kernel ``name`` takes at ``shape``
    on CUDA device ``device`` (the kernel's own choice, from its occupancy)."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        _native.launch(name, *shape, ctypes.byref(out))
    return out.value


def _split_scratch(x, name: str, *shape):
    """(splits, fp32 scratch for that many partial outputs of K6 / K7: shape
    (splits, *x.shape), or an empty tensor when it is 1)."""
    splits = _splits(name, x.device.index, *shape)
    size = (splits, *x.shape) if splits > 1 else (0,)
    return splits, torch.empty(size, device=x.device, dtype=torch.float32)


def layer_norm_bf16(x, ln_w, ln_b):
    """bf16 LayerNorm of a CUDA bf16 tensor over its last axis (fp32
    statistics): the launch that kernels K5, K6 and K7 start with."""
    d = x.shape[-1]
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32))
    if ln_w.numel() != d or ln_b.numel() != d:
        raise ValueError(f"layer_norm_bf16: LN parameters must have {d} elements")
    y = torch.empty_like(x)
    _native.launch("layer_norm_bf16_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                   y.data_ptr(), x.numel() // d, d, _native.stream_handle(x))
    return y


# ---------------------------------------------------------------------------
# plain versions (mirror _mlp_kernel, fused_mlp.py:115-126, and _dwms_kernel,
# :312-356)
# ---------------------------------------------------------------------------


def ln_mlp_ref(x, ln_w, ln_b, w1, b1, w2, b2):
    """x (..., d); ln_w, ln_b (d); w1 (hid, d); b1 (hid); w2 (d, hid); b2 (d).
    Returns (..., d) in x's dtype."""
    cd = x.dtype
    y = _ln_rounded(x, ln_w, ln_b)
    h = F.gelu(_linear(y, w1, cd) + b1.float()).to(cd).float()
    return (_linear(h, w2, cd) + b2.float()).to(cd)


def ln_dwms_mlp_ref(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2):
    """x (B, H, W, d); w1 (hid, d); b1 (hid); k3/k5/k7 (hid, 1, k, k) with
    biases c3/c5/c7 (hid); w2 (d, hid); b2 (d).  Returns (B, H, W, d) in x's
    dtype."""
    cd = x.dtype
    hid = w1.shape[0]
    h = _linear(_ln_rounded(x, ln_w, ln_b), w1, cd) + b1.float()  # fp32, unrounded
    hc = h.permute(0, 3, 1, 2)
    a = h
    for k, c in ((k3, c3), (k5, c5), (k7, c7)):
        conv = F.conv2d(hc, k.to(cd).float(), c.float(), padding=k.shape[-1] // 2, groups=hid)
        a = a + conv.permute(0, 2, 3, 1)
    g = F.gelu(a).to(cd).float()
    return (_linear(g, w2, cd) + b2.float()).to(cd)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
    """Kernel K6 on CUDA tensors, :func:`ln_mlp_ref` on CPU tensors."""
    if not on_card(x):
        return ln_mlp_ref(x, ln_w, ln_b, w1, b1, w2, b2)
    d = x.shape[-1]
    hid = w1.shape[0]
    check_args(x=(x, BF16), w1=(w1, BF16), b1=(b1, F32), w2=(w2, BF16), b2=(b2, F32))
    if (d % 16 or hid % 16 or tuple(w1.shape) != (hid, d) or tuple(w2.shape) != (d, hid)
            or b1.numel() != hid or b2.numel() != d):
        raise ValueError(f"ln_mlp: d={d} and hid={hid} must be multiples of 16, "
                         "w1 (hid, d), w2 (d, hid)")
    M = x.numel() // d
    y = layer_norm_bf16(x, ln_w, ln_b)
    out = torch.empty_like(x)
    splits, part = _split_scratch(x, "ln_mlp_splits", M, d, hid)
    _native.launch("ln_mlp_launch", y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), out.data_ptr(), part.data_ptr(), M, d, hid, splits,
                   _native.stream_handle(x))
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0


def ln_dwms_mlp(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2):
    """Kernel K7 on CUDA tensors, :func:`ln_dwms_mlp_ref` on CPU tensors."""
    if not on_card(x):
        return ln_dwms_mlp_ref(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2)
    B, H, W, d = x.shape
    hid = w1.shape[0]
    check_args(x=(x, BF16), w1=(w1, BF16), b1=(b1, F32), k3=(k3, BF16), c3=(c3, F32),
               k5=(k5, BF16), c5=(c5, F32), k7=(k7, BF16), c7=(c7, F32), w2=(w2, BF16),
               b2=(b2, F32))
    if (d % 16 or hid % 16 or tuple(w1.shape) != (hid, d) or tuple(w2.shape) != (d, hid)
            or b1.numel() != hid or b2.numel() != d
            or any(tuple(k.shape) != (hid, 1, n, n) or c.numel() != hid
                   for n, k, c in ((3, k3, c3), (5, k5, c5), (7, k7, c7)))):
        raise ValueError(f"ln_dwms_mlp: d={d} and hid={hid} must be multiples of 16, "
                         "w1 (hid, d), w2 (d, hid), taps (hid, 1, k, k)")
    y = layer_norm_bf16(x, ln_w, ln_b)
    out = torch.empty_like(x)
    splits, part = _split_scratch(x, "ln_dwms_mlp_splits", B, H, W, d, hid)
    _native.launch("ln_dwms_mlp_launch", y.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   k3.data_ptr(), c3.data_ptr(), k5.data_ptr(), c5.data_ptr(), k7.data_ptr(),
                   c7.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), part.data_ptr(),
                   B, H, W, d, hid, splits, _native.stream_handle(x))
    ln_dwms_mlp.launches += 1
    return out


ln_dwms_mlp.launches = 0
