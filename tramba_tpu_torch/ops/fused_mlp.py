"""Block FFNs of the bf16 path: kernels K6 ``ln_mlp``, K7 ``ln_dwms_mlp`` and
K11 ``ln_dwmlp``, and the adjoints K9 ``ln_mlp_bwd`` and K10
``ln_dwms_mlp_bwd``.

Port of ``tramba_tpu/ops/fused_mlp.py``: ``_mlp_pallas`` (:130, kernel :115),
``_dwms_pallas`` (:360, kernel :312) and ``_dwmlp_pallas`` (:844, kernel
:806), with the custom VJPs ``_mlp_bwd_pallas`` (:233, kernel :177) and
``_dwms_bwd_pallas`` (:674, kernel :541).  The forwards fuse the block's
pre-norm into the FFN and keep the wide hidden tensor out of device memory
(``csrc/mlp.cu``):

* K6 ``ln_mlp``: LN -> fc1 -> exact GELU -> fc2 (VSSBlock, FreqBlock and
  SwinBlock FFN).
* K7 ``ln_dwms_mlp``: LN -> fc1 -> h + dw3(h) + dw5(h) + dw7(h) -> GELU ->
  fc2 (MultiScaleDecoderBlock FFN); the depthwise convs pad h, not x.
* K11 ``ln_dwmlp``: LN (eps 1e-6) -> fc1 -> dw3(h) -> GELU -> fc2 (PVTv2's
  DWConvMlp; the conv replaces h, no identity term).  Its backward is the VJP
  of the plain version (:class:`LnDwMlp`), as ``_dwmlp_bwd`` (:902)
  differentiates the composed version.  Above d 384 it runs K7's launches
  with K11's eps and taps (the wide route, ``csrc/mlp.cu``).

The kernels take bf16 activations, and weights cast to x's dtype at the
call (the modules hand over the fp32 parameters, as flax does); LayerNorm
parameters and biases are fp32.  They round where the TPU kernels round: LN
output, GELU output and the result to bf16, everything else in fp32 (h in
K7 stays fp32 through the depthwise convs).  The plain versions (``*_ref``)
do fp32 math on operands rounded to ``x``'s dtype and round at the same
points, so for fp32 inputs they are the plain fp32 FFNs.  The plain adjoints
(``*_bwd_ref``) are the explicit adjoints of the TPU kernels, with their
rounding points (``csrc/mlp_bwd.cu`` lists them); they return dx in x's
dtype and fp32 weight gradients.  The wrappers pick by device (CPU tensors:
the plain version; CUDA tensors: the kernel or an error) and count launches
in ``<wrapper>.launches``.  Under autograd in bf16 ``ln_mlp`` and
``ln_dwms_mlp`` run :class:`LnMlp` and :class:`LnDwmsMlp` (K6 / K7 forward,
K9 / K10 backward on the card, their plain versions on the CPU), the custom
VJPs of ``fused_ln_mlp`` (:279-299) and ``fused_ln_dwmsmlp`` (:751-776), so
a bf16 gradient rounds where the TPU adjoint rounds on either device; an
fp32 FFN on the CPU differentiates its plain version.  Weights are in torch
layout: Linear (out, in), depthwise Conv2d (C, 1, k, k).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, F32, check_args, needs_grad, on_card
from tramba_tpu_torch.utils.profiling import span

__all__ = ["ln_mlp", "ln_mlp_ref", "check_ln_mlp_shape", "ln_dwms_mlp",
           "ln_dwms_mlp_ref", "check_ln_dwms_mlp_shape", "ln_dwmlp", "ln_dwmlp_ref",
           "dwmlp_fusable", "check_ln_dwmlp_shape", "dwmlp_plan", "DWMLP_PLAN_FIELDS", "ln_mlp_bwd", "ln_mlp_bwd_ref", "check_ln_mlp_bwd_shape",
           "mlp_bwd_column_groups",
           "ln_dwms_mlp_bwd", "ln_dwms_mlp_bwd_ref", "LnMlp", "LnDwmsMlp", "LnDwMlp"]


def _ln_rounded(x, ln_w, ln_b, eps=1e-5):
    """LayerNorm over the last axis in fp32, rounded to x's dtype, returned as
    fp32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln_w.float(), ln_b.float(), eps)
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


def _f32(*shape, like):
    return torch.empty(*shape, device=like.device, dtype=torch.float32)


def _split_scratch(x, name: str, *shape):
    """(splits, fp32 scratch for that many partial outputs of K6 / K7: shape
    (splits, *x.shape), or an empty tensor when it is 1)."""
    splits = _splits(name, x.device.index, *shape)
    size = (splits, *x.shape) if splits > 1 else (0,)
    return splits, torch.empty(size, device=x.device, dtype=torch.float32)


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


def ln_dwmlp_ref(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps=1e-6):
    """x (B, H, W, d); w1 (hid, d); b1 (hid); k3 (hid, 1, 3, 3); c3 (hid);
    w2 (d, hid); b2 (d).  Mirrors _dwmlp_kernel (fused_mlp.py:806-840): the
    3x3 taps rounded to x's dtype act on the unrounded fc1 output, padded
    with zeros.  Returns (B, H, W, d) in x's dtype."""
    cd = x.dtype
    h = _linear(_ln_rounded(x, ln_w, ln_b, eps), w1, cd) + b1.float()
    a = F.conv2d(h.permute(0, 3, 1, 2), k3.to(cd).float(), c3.float(), padding=1,
                 groups=w1.shape[0])
    g = F.gelu(a.permute(0, 2, 3, 1)).to(cd).float()
    return (_linear(g, w2, cd) + b2.float()).to(cd)


def dwmlp_fusable(H: int, W: int, d: int, hid: int, dtype) -> bool:
    """Where the JAX package runs ``_dwmlp_pallas`` on a TPU (``dwmlp_fusable``,
    fused_mlp.py:796-803, whose VMEM budgets hold at every PVTv2-b4 width):
    bf16, W % 8 == 0 (PVT stages 1-3 at 384 px; the 12 px stage 4 runs the
    composed FFN; at 512 px stage 4 is 16 px and fused), hid % 128 == 0 and an
    even H; within those, the widths K11 takes (:func:`check_ln_dwmlp_shape`):
    d % 16 == 0 and d <= 512, where JAX takes d % 8 == 0 within its weight
    budget.  Every PVTv2 width (64, 128, 320, 512) is one of them."""
    return (dtype == torch.bfloat16 and W % 8 == 0 and H % 2 == 0 and d % 16 == 0
            and 16 <= d <= 512 and hid % 128 == 0)


def check_ln_dwmlp_shape(B: int, H: int, W: int, d: int, hid: int) -> None:
    """Raise ValueError unless K11 takes a (B, H, W, d) map with hidden width
    hid: d and hid multiples of 16, d from 16 to 512 (up to 384 one launch
    whose block holds the LN'd halo rows and a chunk's weight boxes; beyond,
    the wide route of K7's two launches; ``ops/encoder_stages.dwmlp_plan``
    is the plan).  No launch."""
    if min(B, H, W) < 1 or d % 16 or hid % 16 or not 16 <= d <= 512 or hid < 16:
        raise ValueError(f"ln_dwmlp: B={B}, H={H}, W={W} must be positive, d={d} and "
                         f"hid={hid} multiples of 16, d from 16 to 512")


# ---------------------------------------------------------------------------
# plain adjoints (mirror _mlp_bwd_kernel, fused_mlp.py:177-229, and
# _dwms_bwd_kernel, :541-670)
# ---------------------------------------------------------------------------


def _gelu_grad(z):
    """d/dz of exact GELU: Phi(z) + z phi(z) (fused_mlp._gelu_grad)."""
    return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + \
        z * torch.exp(-0.5 * z * z) * 0.3989422804014327


def _ln_fwd(x, ln_w, ln_b):
    """(xn, rstd, xf): the normalised rows (fp32), 1/std, and the LN output
    rounded to x's dtype (as fp32)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x32 - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    xn = (x32 - mean) * rstd
    return xn, rstd, (xn * ln_w.float() + ln_b.float()).to(x.dtype).float()


def _ln_bwd(dxf, xn, rstd, ln_w):
    """The LN adjoint in fp32: (dx, d_ln_w, d_ln_b), rows flattened."""
    d = xn.shape[-1]
    dxn = dxf * ln_w.float()
    dx = rstd * (dxn - dxn.mean(-1, keepdim=True) - xn * (dxn * xn).mean(-1, keepdim=True))
    return dx, (dxf * xn).reshape(-1, d).sum(0), dxf.reshape(-1, d).sum(0)


def _rows_t(a, b):
    """a^T b over all leading axes: (..., i), (..., j) -> (i, j), fp32."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def ln_mlp_bwd_ref(x, g, ln_w, ln_b, w1, b1, w2):
    """The adjoint of :func:`ln_mlp_ref` at x for the output cotangent g:
    (dx, d_ln_w, d_ln_b, dw1, db1, dw2, db2), dx in x's dtype, the rest fp32
    in the parameters' layouts."""
    cd = x.dtype
    xn, rstd, xf = _ln_fwd(x, ln_w, ln_b)
    g32 = g.to(cd).float()
    w1c, w2c = w1.to(cd).float(), w2.to(cd).float()
    h0 = xf @ w1c.t() + b1.float()
    hg = F.gelu(h0).to(cd).float()
    dh = (g32 @ w2c) * _gelu_grad(h0)
    dhc = dh.to(cd).float()
    dx, d_ln_w, d_ln_b = _ln_bwd(dhc @ w1c, xn, rstd, ln_w)
    return (dx.to(cd), d_ln_w, d_ln_b, _rows_t(dhc, xf), dh.reshape(-1, dh.shape[-1]).sum(0),
            _rows_t(g32, hg), g32.reshape(-1, g32.shape[-1]).sum(0))


def ln_dwms_mlp_bwd_ref(x, g, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2):
    """The adjoint of :func:`ln_dwms_mlp_ref` at x (B, H, W, d) for the
    output cotangent g: (dx, d_ln_w, d_ln_b, dw1, db1, dk3, dc3, dk5, dc5,
    dk7, dc7, dw2, db2), dx in x's dtype, the rest fp32.  The depthwise
    convs' adjoints are torch.nn.grad's input and weight adjoints."""
    cd = x.dtype
    hid = w1.shape[0]
    xn, rstd, xf = _ln_fwd(x, ln_w, ln_b)
    g32 = g.to(cd).float()
    w1c, w2c = w1.to(cd).float(), w2.to(cd).float()
    h = (xf @ w1c.t() + b1.float()).permute(0, 3, 1, 2)  # (B, hid, H, W), fp32
    taps = [(k.to(cd).float(), c.float(), k.shape[-1] // 2) for k, c in ((k3, c3), (k5, c5), (k7, c7))]
    acc = h
    for k, c, p in taps:
        acc = acc + F.conv2d(h, k, c, padding=p, groups=hid)
    dacc = (g32 @ w2c).permute(0, 3, 1, 2) * _gelu_grad(acc)
    hg = F.gelu(acc).to(cd).float().permute(0, 2, 3, 1)
    dh = dacc
    dk = []
    for k, _, p in taps:
        dh = dh + torch.nn.grad.conv2d_input(h.shape, k, dacc, padding=p, groups=hid)
        dk += [torch.nn.grad.conv2d_weight(h, k.shape, dacc, padding=p, groups=hid),
               dacc.sum((0, 2, 3))]
    dh = dh.permute(0, 2, 3, 1)
    dhc = dh.to(cd).float()
    dx, d_ln_w, d_ln_b = _ln_bwd(dhc @ w1c, xn, rstd, ln_w)
    return (dx.to(cd), d_ln_w, d_ln_b, _rows_t(dhc, xf), dh.reshape(-1, hid).sum(0), *dk,
            _rows_t(g32, hg), g32.reshape(-1, g32.shape[-1]).sum(0))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
    """Kernel K6 on CUDA tensors, :func:`ln_mlp_ref` on CPU tensors; under
    autograd in bf16 (and on the card) :class:`LnMlp`."""
    with span("K6 ln_mlp"):
        args = (x, ln_w, ln_b, w1, b1, w2, b2)
        if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
            return LnMlp.apply(*args)
        return _ln_mlp_launch(*args) if on_card(x) else ln_mlp_ref(*args)


def _mlp_shapes(name, x, w1, b1, w2, b2):
    d, hid = x.shape[-1], w1.shape[0]
    if (d % 16 or hid % 16 or tuple(w1.shape) != (hid, d) or tuple(w2.shape) != (d, hid)
            or b1.numel() != hid or (b2 is not None and b2.numel() != d)):
        raise ValueError(f"{name}: d={d} and hid={hid} must be multiples of 16, "
                         "w1 (hid, d), w2 (d, hid)")
    return d, hid


def check_ln_mlp_shape(M: int, d: int, hid: int) -> None:
    """Raise ValueError unless K6 takes M rows of width ``d`` and hidden
    width ``hid``: d and hid multiples of 16 (as K7 and K9 take them), d up
    to 1024 (a warp holds a row of x in four 16-byte groups a lane for its
    LayerNorm), any M >= 1.  No launch: the tests hold every model's shapes
    to it on the CPU."""
    if M < 1 or d % 16 or hid % 16 or not 0 < d <= 1024 or hid < 16:
        raise ValueError(f"ln_mlp: M={M} must be positive, d={d} and hid={hid} multiples of "
                         "16, d at most 1024")


def _ln_mlp_launch(x, ln_w, ln_b, w1, b1, w2, b2):
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), w1=(w1, BF16), b1=(b1, F32),
               w2=(w2, BF16), b2=(b2, F32))
    d, hid = _mlp_shapes("ln_mlp", x, w1, b1, w2, b2)
    M = x.numel() // d
    check_ln_mlp_shape(M, d, hid)
    if ln_w.numel() != d or ln_b.numel() != d:
        raise ValueError(f"ln_mlp: LN parameters must have {d} elements")
    out = torch.empty_like(x)
    splits, part = _split_scratch(x, "ln_mlp_splits", M, d, hid)
    _native.launch("ln_mlp_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                   w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                   part.data_ptr(), M, d, hid, splits, _native.stream_handle(x))
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0


def ln_dwms_mlp(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2):
    """Kernel K7 on CUDA tensors, :func:`ln_dwms_mlp_ref` on CPU tensors;
    under autograd in bf16 (and on the card) :class:`LnDwmsMlp`."""
    with span("K7 ln_dwms_mlp"):
        args = (x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2)
        if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
            return LnDwmsMlp.apply(*args)
        return _ln_dwms_mlp_launch(*args) if on_card(x) else ln_dwms_mlp_ref(*args)


def _dwms_checks(name, x, w1, b1, taps, w2, b2):
    """taps: ((k3, c3), (k5, c5), (k7, c7)), already in x's dtype."""
    check_args(x=(x, BF16), w1=(w1, BF16), b1=(b1, F32), w2=(w2, BF16),
               **{f"k{n}": (k, BF16) for n, (k, _) in zip((3, 5, 7), taps)},
               **{f"c{n}": (c, F32) for n, (_, c) in zip((3, 5, 7), taps)})
    d, hid = _mlp_shapes(name, x, w1, b1, w2, b2)
    if x.dim() != 4 or any(tuple(k.shape) != (hid, 1, n, n) or c.numel() != hid
                           for n, (k, c) in zip((3, 5, 7), taps)):
        raise ValueError(f"{name}: x (B, H, W, d), taps (hid, 1, k, k), biases (hid)")
    return d, hid


def check_ln_dwms_mlp_shape(B: int, H: int, W: int, d: int, hid: int) -> None:
    """Raise ValueError unless K7 takes a (B, H, W, d) map with hidden width
    ``hid``: d and hid multiples of 16, d from 16 to 512 (its 64 x d output
    tile stays in registers).  No launch: the tests hold every model's
    shapes to it on the CPU."""
    if min(B, H, W) < 1 or d % 16 or hid % 16 or not 16 <= d <= 512 or hid < 16:
        raise ValueError(f"ln_dwms_mlp: B={B}, H={H}, W={W} must be positive, d={d} and "
                         f"hid={hid} multiples of 16, d from 16 to 512")


def _ln_dwms_mlp_launch(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2):
    cd = x.dtype
    w1, w2 = w1.to(cd), w2.to(cd)
    taps = ((k3.to(cd), c3), (k5.to(cd), c5), (k7.to(cd), c7))
    check_args(ln_w=(ln_w, F32), ln_b=(ln_b, F32), b2=(b2, F32))
    d, hid = _dwms_checks("ln_dwms_mlp", x, w1, b1, taps, w2, b2)
    B, H, W, _ = x.shape
    check_ln_dwms_mlp_shape(B, H, W, d, hid)
    if ln_w.numel() != d or ln_b.numel() != d:
        raise ValueError(f"ln_dwms_mlp: LN parameters must have {d} elements")
    out = torch.empty_like(x)
    # fc1's output, read by the stencil's halos, then the merged taps and
    # biases: 50 x 64 floats a chunk of 64 hidden channels
    h = _f32(B * H * W * hid + 50 * 64 * -(-hid // 64), like=x)
    splits, part = _split_scratch(x, "ln_dwms_mlp_splits", B, H, W, d, hid)
    _native.launch("ln_dwms_mlp_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                   w1.data_ptr(), b1.data_ptr(), *(t.data_ptr() for kc in taps for t in kc),
                   w2.data_ptr(), b2.data_ptr(), out.data_ptr(), h.data_ptr(), part.data_ptr(),
                   B, H, W, d, hid, splits, _native.stream_handle(x))
    ln_dwms_mlp.launches += 1
    return out


ln_dwms_mlp.launches = 0


def ln_dwmlp(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps=1e-6):
    """Kernel K11 on CUDA tensors, :func:`ln_dwmlp_ref` on CPU tensors; under
    autograd in bf16 (and on the card) :class:`LnDwMlp`."""
    with span("K11 ln_dwmlp"):
        args = (x, ln_w, ln_b, w1, b1, k3, c3, w2, b2)
        if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
            return LnDwMlp.apply(*args, eps)
        return _ln_dwmlp_launch(*args, eps) if on_card(x) else ln_dwmlp_ref(*args, eps)


# the plan ln_dwmlp_plan reports (csrc/mlp.cu plan_dwmlp, pick_dwmlp_splits;
# "wide": 1 where the call runs K7's launches, d above 384)
DWMLP_PLAN_FIELDS = ("NT", "stages", "per_sm", "smem", "tiles", "nchunks", "splits", "wide")


@functools.lru_cache(maxsize=None)
def _dwmlp_plan(device: int, *shape) -> tuple:
    out = (ctypes.c_int * len(DWMLP_PLAN_FIELDS))()
    with torch.cuda.device(device):
        _native.launch("ln_dwmlp_plan", *shape, out)
    return tuple(out)


def dwmlp_plan(B: int, H: int, W: int, d: int, hid: int, device: int = 0) -> dict:
    """The plan the built library makes for a K11 call on CUDA device
    ``device`` ({field: value} over :data:`DWMLP_PLAN_FIELDS`: fc2's output
    tiles a warpgroup, ring slots, blocks an SM, shared bytes, 8x8 tiles an
    image, hidden chunks of 64, splits of the chunks, the wide route);
    ``ops/encoder_stages.dwmlp_plan`` is its plain mirror.  No launch."""
    check_ln_dwmlp_shape(B, H, W, d, hid)
    return dict(zip(DWMLP_PLAN_FIELDS, _dwmlp_plan(device, B, H, W, d, hid)))


def _ln_dwmlp_launch(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps):
    cd = x.dtype
    w1, k3, w2 = w1.to(cd), k3.to(cd), w2.to(cd)
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), w1=(w1, BF16), b1=(b1, F32),
               k3=(k3, BF16), c3=(c3, F32), w2=(w2, BF16), b2=(b2, F32))
    d, hid = _mlp_shapes("ln_dwmlp", x, w1, b1, w2, b2)
    if x.dim() != 4 or tuple(k3.shape) != (hid, 1, 3, 3) or c3.numel() != hid:
        raise ValueError("ln_dwmlp: x (B, H, W, d), k3 (hid, 1, 3, 3), c3 (hid)")
    if ln_w.numel() != d or ln_b.numel() != d:
        raise ValueError(f"ln_dwmlp: LN parameters must have {d} elements")
    B, H, W, _ = x.shape
    plan = dwmlp_plan(B, H, W, d, hid, x.device.index)
    splits = plan["splits"]
    out = torch.empty_like(x)
    part = _f32(*((splits, *x.shape) if splits > 1 else (0,)), like=x)
    # the wide route's fc1 map and merged taps, as K7's
    h = _f32(B * H * W * hid + 50 * 64 * -(-hid // 64) if plan["wide"] else 0, like=x)
    _native.launch("ln_dwmlp_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                   w1.data_ptr(), b1.data_ptr(), k3.data_ptr(), c3.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), out.data_ptr(), part.data_ptr(), h.data_ptr(), B, H, W, d,
                   hid, splits, ctypes.c_float(eps), _native.stream_handle(x))
    ln_dwmlp.launches += 1
    return out


ln_dwmlp.launches = 0


def _bwd_scratch(x, dwms, *shape):
    n = ctypes.c_long()
    _native.launch("mlp_bwd_scratch", dwms, *shape, ctypes.byref(n))
    return torch.empty(n.value, device=x.device, dtype=torch.uint8)


def check_ln_mlp_bwd_shape(M: int, d: int, hid: int, name: str = "ln_mlp_bwd") -> None:
    """Raise ValueError unless K9 (and K10, ``name``) takes M rows of width d
    and hidden width hid: d and hid multiples of 16, d from 16 to 1024, and
    d's 64-column tiles split into column groups of 1, 2, 4 or 8 tiles, at
    most 8 groups (a thread block cluster): every d but those of 9, 11, 13
    or 15 tiles.  No launch."""
    tiles = -(-d // 64)
    if (M < 1 or d % 16 or hid % 16 or not 16 <= d <= 1024 or hid < 16
            or tiles in (9, 11, 13, 15)):
        raise ValueError(f"{name}: M={M} must be positive, d={d} and hid={hid} multiples of "
                         "16, d from 16 to 1024 and not of 9, 11, 13 or 15 tiles of 64")


def mlp_bwd_column_groups(M: int, d: int, hid: int) -> int:
    """Column groups of d that stage (c) of K9 and K10 splits M rows into, as
    the built library plans them (``plan_dx`` in ``csrc/mlp_bwd.cu``;
    :func:`tramba_tpu_torch.ops.ffn_stages.column_groups` is its plain
    mirror).  No launch; raises for shapes the kernels do not take."""
    G = _native.library().mlp_bwd_column_groups(M, d, hid)
    if G < 1:
        raise ValueError(f"ln_mlp_bwd: no plan for M={M}, d={d}, hid={hid}")
    return G


def ln_mlp_bwd(x, g, ln_w, ln_b, w1, b1, w2):
    """Kernel K9 on CUDA tensors, :func:`ln_mlp_bwd_ref` on CPU tensors."""
    with span("K9 ln_mlp_bwd"):
        if not on_card(x):
            return ln_mlp_bwd_ref(x, g, ln_w, ln_b, w1, b1, w2)
        g = g.to(x.dtype).contiguous()
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        check_args(x=(x, BF16), g=(g, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), w1=(w1c, BF16),
                   b1=(b1, F32), w2=(w2c, BF16))
        d, hid = _mlp_shapes("ln_mlp_bwd", x, w1c, b1, w2c, None)
        M = x.numel() // d
        check_ln_mlp_bwd_shape(M, d, hid)
        if g.shape != x.shape or ln_w.numel() != d or ln_b.numel() != d:
            raise ValueError("ln_mlp_bwd: g must have x's shape, LN parameters d elements")
        dx = torch.empty_like(x)
        dw1, db1, dw2 = _f32(hid, d, like=x), _f32(hid, like=x), _f32(d, hid, like=x)
        db2, dln_w, dln_b = _f32(d, like=x), _f32(d, like=x), _f32(d, like=x)
        scratch = _bwd_scratch(x, 0, M, 1, 1, d, hid)
        _native.launch("ln_mlp_bwd_launch", x.data_ptr(), g.data_ptr(), ln_w.data_ptr(),
                       ln_b.data_ptr(), w1c.data_ptr(), b1.data_ptr(), w2c.data_ptr(),
                       dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                       db2.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(), scratch.data_ptr(),
                       M, d, hid, _native.stream_handle(x))
        ln_mlp_bwd.launches += 1
        return dx, dln_w, dln_b, dw1, db1, dw2, db2


ln_mlp_bwd.launches = 0


def ln_dwms_mlp_bwd(x, g, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2):
    """Kernel K10 on CUDA tensors, :func:`ln_dwms_mlp_bwd_ref` on CPU tensors."""
    with span("K10 ln_dwms_mlp_bwd"):
        if not on_card(x):
            return ln_dwms_mlp_bwd_ref(x, g, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2)
        cd = x.dtype
        g = g.to(cd).contiguous()
        w1c, w2c = w1.to(cd), w2.to(cd)
        taps = ((k3.to(cd), c3), (k5.to(cd), c5), (k7.to(cd), c7))
        check_args(g=(g, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32))
        d, hid = _dwms_checks("ln_dwms_mlp_bwd", x, w1c, b1, taps, w2c, None)
        if g.shape != x.shape or ln_w.numel() != d or ln_b.numel() != d:
            raise ValueError("ln_dwms_mlp_bwd: g must have x's shape, LN parameters d elements")
        B, H, W, _ = x.shape
        check_ln_mlp_bwd_shape(B * H * W, d, hid, "ln_dwms_mlp_bwd")
        dx = torch.empty_like(x)
        dw1, db1, dw2 = _f32(hid, d, like=x), _f32(hid, like=x), _f32(d, hid, like=x)
        dk = [t for n in (3, 5, 7) for t in (_f32(hid, 1, n, n, like=x), _f32(hid, like=x))]
        db2, dln_w, dln_b = _f32(d, like=x), _f32(d, like=x), _f32(d, like=x)
        scratch = _bwd_scratch(x, 1, B, H, W, d, hid)
        _native.launch("ln_dwms_mlp_bwd_launch", x.data_ptr(), g.data_ptr(), ln_w.data_ptr(),
                       ln_b.data_ptr(), w1c.data_ptr(), b1.data_ptr(),
                       *(t.data_ptr() for kc in taps for t in kc), w2c.data_ptr(),
                       dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                       *(t.data_ptr() for t in dk), dw2.data_ptr(), db2.data_ptr(),
                       dln_w.data_ptr(), dln_b.data_ptr(), scratch.data_ptr(),
                       B, H, W, d, hid, _native.stream_handle(x))
        ln_dwms_mlp_bwd.launches += 1
        return (dx, dln_w, dln_b, dw1, db1, *dk, dw2, db2)


ln_dwms_mlp_bwd.launches = 0


class LnMlp(torch.autograd.Function):
    """K6 forward, K9 backward (their plain versions on CPU tensors): the
    custom VJP of ``fused_ln_mlp`` (fused_mlp.py:279-299).  The weights come
    in as the fp32 parameters and get fp32 gradients, as flax's do."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        args = (x, ln_w, ln_b, w1, b1, w2, b2)
        return _ln_mlp_launch(*args) if on_card(x) else ln_mlp_ref(*args)

    @staticmethod
    def backward(ctx, g):
        return ln_mlp_bwd(*ctx.saved_tensors[:1], g, *ctx.saved_tensors[1:])


class LnDwmsMlp(torch.autograd.Function):
    """K7 forward, K10 backward (their plain versions on CPU tensors): the
    custom VJP of ``fused_ln_dwmsmlp`` (fused_mlp.py:751-776), at every shape
    (JAX sends d > 256 to its composed VJP, the same function)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2)
        args = (x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2)
        return _ln_dwms_mlp_launch(*args) if on_card(x) else ln_dwms_mlp_ref(*args)

    @staticmethod
    def backward(ctx, g):
        return ln_dwms_mlp_bwd(*ctx.saved_tensors[:1], g, *ctx.saved_tensors[1:])


class LnDwMlp(torch.autograd.Function):
    """K11 forward (its plain version on CPU tensors); backward: the VJP of
    :func:`ln_dwmlp_ref` by recomputation, as ``_dwmlp_bwd``
    (fused_mlp.py:902-904) differentiates ``composed_ln_dwmlp``."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2)
        ctx.eps = eps
        args = (x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps)
        return _ln_dwmlp_launch(*args) if on_card(x) else ln_dwmlp_ref(*args)

    @staticmethod
    def backward(ctx, g):
        grads = _native.recompute_vjp(lambda *a: ln_dwmlp_ref(*a, ctx.eps), ctx.saved_tensors,
                                      ctx.needs_input_grad[:9], g)
        return (*grads, None)
