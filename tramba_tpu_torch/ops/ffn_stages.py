"""Plain mirrors of how the redesigned K7 ``ln_dwms_mlp``, K9 ``ln_mlp_bwd``
and K10 ``ln_dwms_mlp_bwd`` split their work (``csrc/mlp.cu``,
``csrc/mlp_bwd.cu``), beside the plain versions in
:mod:`tramba_tpu_torch.ops.fused_mlp` that follow the TPU kernels' own
order.

* :func:`dwms_merged_ref`: K7 computes h = LN(x) w1^T + b1 once for every
  pixel (fp32, zero outside the image), then runs one 7x7 depthwise stencil
  with the merged taps t = k7 + pad(k5) + pad(k3) + identity and bias
  c3 + c5 + c7, then GELU and fc2.  The same function as
  ``ln_dwms_mlp_ref`` reassociated in fp32, far below the bf16 rounding of
  the output.
* :func:`mlp_bwd_split_ref`: K9's front keeps h and g w2 on chip and writes
  only hg, bf16(dh) and the db1 sums; its stage (c) computes dxf in column
  groups of d (:func:`column_groups`, the kernel's choice), and the LN
  adjoint's two row sums are each group's share added in group order.
* :func:`dwms_bwd_merged_ref`: K10 runs its three depthwise convs as the
  merged 7x7 tap set t (identity included) of K7: one forward stencil
  acc = t * h + bias, dh = the correlation of dacc (zero outside the
  image) with the flipped taps, and one 49-offset correlation
  dk[o] = sum_p dacc(p) h(p + o) whose central 5x5 and 3x3 are dk5 and dk3.
  The same function as ``ln_dwms_mlp_bwd_ref`` reassociated in fp32.

Each takes ``fault``, a named mistake planted in the mirror, so that a
check can show it would see a kernel making it (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops.fused_mlp import (_gelu_grad, _linear, _ln_bwd, _ln_fwd, _ln_rounded,
                                            _rows_t)

__all__ = ["DWMS_FAULTS", "MLP_BWD_FAULTS", "DWMS_BWD_FAULTS", "dwms_merged_ref",
           "column_groups", "mlp_bwd_split_ref", "dwms_bwd_merged_ref"]

DWMS_FAULTS = ("no 3x3 taps", "h not zero outside", "no last chunk")
MLP_BWD_FAULTS = ("no mean term", "no last group's row sums")
DWMS_BWD_FAULTS = ("dacc not zero outside", "no identity in dh", "dk3 taken off-centre")

_CHUNK = 64  # K7's hidden chunk


def _merged_taps(k3, k5, k7, cd):
    """(hid, 1, 7, 7) fp32: k7 + pad(k5) + pad(k3) + identity, the taps
    rounded to ``cd`` first."""
    t = k7.to(cd).float().clone()
    t[:, :, 1:6, 1:6] += k5.to(cd).float()
    t[:, :, 2:5, 2:5] += k3.to(cd).float()
    t[:, :, 3, 3] += 1.0
    return t


def dwms_merged_ref(x, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2, fault=None):
    """K7's function computed as the kernel splits it.  x (B, H, W, d);
    weights in torch layout.  Returns (B, H, W, d) in x's dtype.  ``fault``:
    one of :data:`DWMS_FAULTS` or None."""
    cd = x.dtype
    hid = w1.shape[0]
    h = _linear(_ln_rounded(x, ln_w, ln_b), w1, cd) + b1.float()  # once per pixel, fp32
    hc = h.permute(0, 3, 1, 2)
    taps = _merged_taps(torch.zeros_like(k3) if fault == "no 3x3 taps" else k3, k5, k7, cd)
    bias = c3.float() + c5.float() + c7.float()
    if fault == "h not zero outside":  # padding LN(x) instead of h: b1 outside the image
        b = b1.float()[:, None, None]
        a = F.conv2d(F.pad(hc - b, (3, 3, 3, 3)) + b, taps, bias, groups=hid)
    else:
        a = F.conv2d(hc, taps, bias, padding=3, groups=hid)
    g = F.gelu(a.permute(0, 2, 3, 1)).to(cd).float()
    w2c = w2.to(cd).float()
    if fault == "no last chunk":
        w2c = w2c.clone()
        w2c[:, (hid - 1) // _CHUNK * _CHUNK:] = 0
    return (g @ w2c.t() + b2.float()).to(cd)


def column_groups(M: int, d: int) -> int:
    """Plain mirror of the column groups of K9's stage (c) (``plan_dx`` in
    ``csrc/mlp_bwd.cu``, which the card reports through
    ``fused_mlp.mlp_bwd_column_groups``): the fewest G <= 8 that split d's
    64-column tiles into groups of 1, 2, 4 or 8 tiles and give the 64-row
    tiles at least 132 blocks, else the most such G."""
    tiles, rows, best = -(-d // 64), -(-M // 64), 0
    for g in range(1, 9):
        if tiles % g or tiles // g not in (1, 2, 4, 8):
            continue
        best = g
        if rows * g >= 132:
            break
    if not best:
        raise ValueError(f"ln_mlp_bwd: no column groups for d={d}")
    return best


def mlp_bwd_split_ref(x, g, ln_w, ln_b, w1, b1, w2, groups=None, fault=None):
    """K9's adjoint computed as the kernel splits it: the same outputs as
    ``ln_mlp_bwd_ref`` (dx, d_ln_w, d_ln_b, dw1, db1, dw2, db2).  ``groups``:
    column groups of stage (c), by default the kernel's; ``fault``: one of
    :data:`MLP_BWD_FAULTS` or None."""
    cd = x.dtype
    d = x.shape[-1]
    xn, rstd, xf = _ln_fwd(x, ln_w, ln_b)
    g32 = g.to(cd).float()
    w1c, w2c = w1.to(cd).float(), w2.to(cd).float()
    # the front: h and g w2 stay on chip; hg, bf16(dh) and db1's sums leave
    z = xf @ w1c.t() + b1.float()
    dh = (g32 @ w2c) * _gelu_grad(z)
    hg = F.gelu(z).to(cd).float()
    dhc = dh.to(cd).float()
    # (c): dxf by column groups, the row sums of the LN adjoint as each
    # group's share added in group order
    dxf = dhc @ w1c
    dxn = dxf * ln_w.float()
    G = groups or column_groups(dxf.numel() // d, d)
    width = -(-d // 64) // G * 64
    s1 = s2 = 0.0
    for k in range(G):
        if fault == "no last group's row sums" and k == G - 1:
            continue
        part = slice(k * width, min(d, (k + 1) * width))
        s1 = s1 + dxn[..., part].sum(-1, keepdim=True)
        s2 = s2 + (dxn * xn)[..., part].sum(-1, keepdim=True)
    s1, s2 = s1 / d, s2 / d
    if fault == "no mean term":
        s1 = 0.0
    dx = rstd * (dxn - s1 - xn * s2)
    return (dx.to(cd), (dxf * xn).reshape(-1, d).sum(0), dxf.reshape(-1, d).sum(0),
            _rows_t(dhc, xf), dh.reshape(-1, dh.shape[-1]).sum(0), _rows_t(g32, hg),
            g32.reshape(-1, d).sum(0))


def dwms_bwd_merged_ref(x, g, ln_w, ln_b, w1, b1, k3, c3, k5, c5, k7, c7, w2, fault=None):
    """K10's adjoint computed as the kernel splits it: the same outputs as
    ``ln_dwms_mlp_bwd_ref`` (dx, d_ln_w, d_ln_b, dw1, db1, dk3, dc3, dk5, dc5,
    dk7, dc7, dw2, db2).  ``fault``: one of :data:`DWMS_BWD_FAULTS` or None
    ("dacc not zero outside": the adjoint stencil's halo clamped to the
    image's edge pixels instead of zero-filled)."""
    cd = x.dtype
    hid = w1.shape[0]
    xn, rstd, xf = _ln_fwd(x, ln_w, ln_b)
    g32 = g.to(cd).float()
    w1c, w2c = w1.to(cd).float(), w2.to(cd).float()
    # the front: h and g w2, once per pixel, fp32
    h = (xf @ w1c.t() + b1.float()).permute(0, 3, 1, 2)
    gw = (g32 @ w2c).permute(0, 3, 1, 2)
    # (b1): one merged stencil
    t = _merged_taps(k3, k5, k7, cd)
    acc = F.conv2d(h, t, c3.float() + c5.float() + c7.float(), padding=3, groups=hid)
    dacc = gw * _gelu_grad(acc)
    hg = F.gelu(acc).to(cd).float().permute(0, 2, 3, 1)
    # (b2): dh = sum_o t[o] dacc(p - o) on a zero halo, and the 49 offsets
    pad = "replicate" if fault == "dacc not zero outside" else "constant"
    t_dh = t.clone()
    if fault == "no identity in dh":
        t_dh[:, :, 3, 3] -= 1.0
    dh = F.conv2d(F.pad(dacc, (3, 3, 3, 3), mode=pad), t_dh.flip(-2, -1), groups=hid)
    dk7 = torch.nn.grad.conv2d_weight(h, t.shape, dacc, padding=3, groups=hid)
    dk3 = dk7[:, :, 1:4, 1:4] if fault == "dk3 taken off-centre" else dk7[:, :, 2:5, 2:5]
    dc = dacc.sum((0, 2, 3))
    dh = dh.permute(0, 2, 3, 1)
    dhc = dh.to(cd).float()
    # (c) - (e): K9's tail
    dx, d_ln_w, d_ln_b = _ln_bwd(dhc @ w1c, xn, rstd, ln_w)
    return (dx.to(cd), d_ln_w, d_ln_b, _rows_t(dhc, xf), dh.reshape(-1, hid).sum(0),
            dk3.contiguous(), dc, dk7[:, :, 1:6, 1:6].contiguous(), dc, dk7, dc,
            _rows_t(g32, hg), g32.reshape(-1, g32.shape[-1]).sum(0))
