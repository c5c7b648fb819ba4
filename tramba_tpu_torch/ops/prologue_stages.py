"""Plain mirror of how the redesigned K5 ``prologue`` tiles its work
(``csrc/prologue.cu``), beside :func:`tramba_tpu_torch.ops.fused_prologue.
prologue_ref`, which follows the TPU kernel's own order.

* :func:`prologue_plan`: the kernel's plan (``plan_prologue``, which the card
  reports through ``prologue_plan``): the output tile TH x TW and M tiles MT
  of 64 halo rows that cover the map in the fewest products, among those
  whose A tile fits a block, and, where the tiles fill less than a wave of
  132 blocks, the most channel groups that keep the grid inside one wave.
* :func:`prologue_tiled_ref`: per output tile, the (TH + 2) x (TW + 2) halo
  pixels' rows normalised (rows outside the image are zero rows), u = y
  w_in^T in fp32 for every halo row (the halo recomputed, as the TPU kernel
  recomputes it), the 3x3 taps and SiLU on the tile, the results placed in
  the map.  The same function as ``prologue_ref``, its sums in another order.

It takes ``fault``, a named mistake planted in the mirror, so that a check
can show it would see a kernel making it (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops.fused_mlp import _linear, _ln_rounded

__all__ = ["PROLOGUE_FAULTS", "prologue_faults", "prologue_plan", "prologue_tiled_ref"]

# "u not zero outside": the halo rows outside the image staged as zero rows
# of x and normalised, so their u is in_proj(ln_b); "halo rows not
# normalised": the tile's ring of halo rows taken as x; "halo clamped to the
# edge": a halo pixel outside the image read at the nearest pixel inside
PROLOGUE_FAULTS = ("u not zero outside", "halo rows not normalised", "halo clamped to the edge")


def prologue_faults(with_ln: bool) -> tuple:
    """The faults of :data:`PROLOGUE_FAULTS` that change the output: without
    the LayerNorm a zero row projects to 0 and the halo's rows are x anyway."""
    return PROLOGUE_FAULTS if with_ln else ("halo clamped to the edge",)

_SMEM_BLOCK = 227 * 1024  # shared memory one block may use
_BOX = 64 * 64 * 2  # bytes of one 64 x 64 bf16 box of w_in
_LDU = 66  # fp32 row stride of the kernel's u tile


def _smem(mt: int, dp: int, stages: int) -> int:
    return 1024 + 64 * mt * dp * 2 + stages * _BOX + 64 * mt * _LDU * 4


def prologue_plan(B: int, H: int, W: int, dm: int, D: int) -> dict:
    """``plan_prologue`` of ``csrc/prologue.cu``: {"tile": (TH, TW), "mt":
    M tiles of 64 halo rows, "tiles": tiles an image, "groups": channel groups
    (grid z), "stages": ring slots}.  Raises for shapes K5 does not take."""
    if min(B, H, W) < 1 or dm % 16 or D % 16 or not 16 <= dm <= 1024 or D < 16:
        raise ValueError(f"prologue: no plan for B={B}, H={H}, W={W}, dm={dm}, D={D}")
    dp = -(-dm // 64) * 64
    best = None
    mt = 1
    while mt <= 4 and _smem(mt, dp, 3) <= _SMEM_BLOCK:
        th = 1
        while th <= H and th + 2 <= 64 * mt // 3:
            tw = min(W, 64 * mt // (th + 2) - 2)
            if tw >= 1:
                tiles = -(-H // th) * -(-W // tw)
                key = (tiles * mt, tiles)
                if best is None or key < best[0]:
                    best = (key, (th, tw), mt, tiles)
            th += 1
        mt += 1
    _, tile, mt, tiles = best
    chunks = -(-D // 64)
    want = max(1, min(chunks, 132 // (B * tiles)))
    cpg = -(-chunks // want)
    fixed = _smem(mt, dp, 0)
    budget = 113 * 1024 if fixed + 4 * _BOX <= 113 * 1024 else _SMEM_BLOCK
    return {"tile": tile, "mt": mt, "tiles": tiles, "groups": -(-chunks // cpg),
            "stages": min(8, (budget - fixed) // _BOX)}


def prologue_tiled_ref(x, ln_w, ln_b, w_in, conv_k, tile=None, fault=None):
    """K5's function computed tile by tile as the kernel does.  x (B, H, W,
    dm); ln_w, ln_b (dm) or both None; w_in (D, dm); conv_k (D, 1, 3, 3).
    ``tile``: (TH, TW), by default the kernel's (:func:`prologue_plan`);
    ``fault``: one of :data:`PROLOGUE_FAULTS` or None.  Returns (B, H, W, D)
    in x's dtype."""
    cd = x.dtype
    B, H, W, dm = x.shape
    D = w_in.shape[0]
    TH, TW = tile or prologue_plan(B, H, W, dm, D)["tile"]
    ty, tx = -(-H // TH), -(-W // TW)
    # the halo pixels of every tile: (ty, tx, TH + 2, TW + 2) coordinates
    gy = (torch.arange(ty) * TH)[:, None, None, None] - 1 + torch.arange(TH + 2)[None, None, :, None]
    gx = (torch.arange(tx) * TW)[None, :, None, None] - 1 + torch.arange(TW + 2)[None, None, None, :]
    gy, gx = torch.broadcast_tensors(gy, gx)
    inside = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    interior = torch.zeros_like(inside)
    interior[:, :, 1:-1, 1:-1] = True
    rows = x[:, gy.clamp(0, H - 1), gx.clamp(0, W - 1)].float()  # (B, ty, tx, TH+2, TW+2, dm)
    if ln_w is None:
        y = rows
    else:
        y = _ln_rounded(rows.to(cd), ln_w, ln_b)
        if fault == "halo rows not normalised":
            y = torch.where(interior.to(x.device)[..., None], y, rows)
    outside = ~inside.to(x.device)[..., None]
    if fault == "halo clamped to the edge":
        pass
    elif fault == "u not zero outside" and ln_w is not None:
        # the rows outside the image as zero x rows: their LN is ln_b
        y = torch.where(outside, _ln_rounded(torch.zeros_like(rows).to(cd), ln_w, ln_b), y)
    else:
        y = y.masked_fill(outside, 0.0)
    u = _linear(y, w_in, cd)  # (B, ty, tx, TH+2, TW+2, D), fp32
    u = u.reshape(-1, TH + 2, TW + 2, D).permute(0, 3, 1, 2)
    a = F.conv2d(u, conv_k.to(cd).float(), groups=D)  # (B ty tx, D, TH, TW)
    out = F.silu(a).to(cd).reshape(B, ty, tx, D, TH, TW).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(B, ty * TH, tx * TW, D)[:, :H, :W].contiguous()
