"""Plain mirror of how the redesigned K3 ``expand_ln`` and K4 ``final_head``
tile their work (``csrc/expand.cu``), beside
:func:`tramba_tpu_torch.ops.fused_expand.expand_ln_ref` and
:func:`~tramba_tpu_torch.ops.fused_expand.final_head_ref`, which follow the
TPU kernels' own order.

* :func:`expand_plan`, :func:`head_plan`: the launchers' plans
  (``plan_expand``, ``plan_head``; the card reports them through
  ``fused_expand.expand_plan`` / ``head_plan``): the route (``wgmma`` in bf16
  where a warpgroup's columns fit its registers, else SIMT micro-tiles), the
  block's rows, the columns a warpgroup owns (or a SIMT chunk's), whether the
  two warpgroups split the columns or the rows, the shuffle groups a block,
  the grid and the ring's slots.
* :func:`expand_tiled_ref`: per block's group set, the block's columns
  (weight rows ``g0 co + [0, width)``, zeros past ``4 co``), the product
  summed k-slab by k-slab (64 a slab on the ``wgmma`` route, 32 on K3's SIMT
  one and 16 on K4's), each (row, group)'s statistics over its valid columns in two passes,
  the two warpgroups' column halves summed apart and then added where the
  plan splits the columns, and each row normalised and stored at its
  shuffled place.
* :func:`head_tiled_ref`: per slot, its product as above, the mean, then
  sum (h - m)^2 and sum (h - m) u with u = ln_w seg_w, the logit rstd sum (h -
  m) u + sum ln_b seg_w + seg_b.

Each takes ``fault``, a named mistake planted in the mirror, so that a check
can show it would see a kernel making it (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import torch

__all__ = ["EXPAND_FAULTS", "HEAD_FAULTS", "ROUTES", "expand_faults", "expand_plan",
           "expand_tiled_ref", "head_faults", "head_plan", "head_tiled_ref"]

ROUTES = ("wgmma", "simt")
# "p1 and p2 swapped": the row stored at (2h + p2, 2w + p1); "pad columns in
# the variance": the block's columns past the group's width (TMA zeros, or
# the next group's rows) left in both statistics' sums; "no last K chunk": the
# last k-slab left out of the product
EXPAND_FAULTS = ("p1 and p2 swapped", "pad columns in the variance", "no last K chunk")
# "no mean in the head sum": sum h u in place of sum (h - m) u
HEAD_FAULTS = ("no last K chunk", "no mean in the head sum", "pad columns in the variance")

_SMEM_BLOCK = 227 * 1024  # shared memory one block may use
_HALF_SM = 113 * 1024     # two blocks an SM below this
_BOX = 64 * 64 * 2        # bytes of one 64 x 64 bf16 TMA box
# k a ring stage (K3, K4), ring stages and BM x BN of the SIMT route
_SIMT_K3, _SIMT_K4, _SIMT_STAGES, _SIMT_TILE = 32, 16, 3, 8192
_EPS = 1e-5


def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def _ring_stages(fixed: int, stage: int, budget: int) -> int:
    return min(8, (budget - fixed) // stage) if budget > fixed else 0


def _plan(route, rows, wn, split, gpb, sets, M, stages, smem) -> dict:
    return dict(route=route, rows=rows, wn=wn, split=split, gpb=gpb, sets=sets,
                tiles=-(-M // rows), stages=stages, smem=smem)


def _slot_groups(tiles: int, bps: int) -> int:
    """K4's slot groups (``slot_groups``): the fewest waves x (slots a block +
    1), the fewer groups on a tie."""
    costs = [(-(-tiles * sets // (132 * bps)) * (16 // sets + 1), sets)
             for sets in (1, 2, 4, 8, 16)]
    return min(costs, key=lambda c: c[0])[1]


def _plan_simt(M: int, width: int, head: bool, elem: int):
    best = None
    for bm in (64, 32, 16):
        bn, ld = _SIMT_TILE // bm, (_SIMT_K4 if head else _SIMT_K3) + 16 // elem
        ncl = -(-width // bn)
        ring = _SIMT_STAGES * (bm + bn) * ld * elem
        smem = bm * width * 4 + bm * 16 * 4 + ring if head else ring + 2 * bm * 4
        if smem > _SMEM_BLOCK or (not head and ncl > 8):
            continue
        bps = 2 if 2 * smem <= 228 * 1024 else 1
        tiles = -(-M // bm)
        sets = _slot_groups(tiles, bps) if head else 4 * ncl
        cost = -(-tiles * sets // (132 * bps)) * (bm + 16) * bn * (ncl * (16 // sets + 1)
                                                                   if head else 1)
        if best is None or cost < best[0]:
            best = (cost, bm, bn, smem, sets)
    if best is None:
        return None
    _, bm, bn, smem, sets = best
    return _plan(1, bm, bn, 0, 1, sets, M, _SIMT_STAGES, smem)


def _plan_expand_wgmma(M: int, C: int, co: int):
    if co > 512 or C < 8:
        return None
    gpb = 2 if co <= 128 else 1
    ncol = gpb * co
    split = int(ncol > 256)
    rows = 64 if split else 128
    wn = _pad(ncol, 128) // 2 if split else _pad(ncol, 64)
    ncol_pad = 2 * wn if split else wn
    stage = (rows // 64 + ncol_pad // 64) * _BOX
    fixed = 1024 + 2 * 64 * 4
    out_tile = rows * (ncol_pad + 8) * 2
    fit = _ring_stages(fixed, stage, _SMEM_BLOCK)
    stages = max(3, min(fit, -(-C // 64) + 1))
    while stages < fit and stages * stage < out_tile:
        stages += 1
    if not (3 <= stages <= fit and stages * stage >= out_tile):
        return None
    return _plan(0, rows, wn, split, gpb, 4 // gpb, M, stages, fixed + stages * stage)


def _plan_head_wgmma(M: int, C: int):
    if C > 256 or C < 8:
        return None
    split = int(C > 128)
    rows = 64 if split else 128
    wn = 128 if split else _pad(C, 64)
    stage = (256 if split else wn) // 64 * _BOX
    fixed = 1024 + rows * _pad(C, 64) * 2 + rows * 16 * 4 + 256 * 4 + 3 * 2 * 64 * 4
    budget = _HALF_SM if wn == 64 and fixed + 4 * stage <= _HALF_SM else _SMEM_BLOCK
    stages = _ring_stages(fixed, stage, budget)
    if stages < 3:
        return None
    sets = _slot_groups(-(-M // rows), 2 if budget == _HALF_SM else 1)
    return _plan(0, rows, wn, split, 1, sets, M, stages, fixed + stages * stage)


def _check(C: int, dtype: torch.dtype, what: str) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: float32 or bfloat16, not {dtype}")
    elem = 2 if dtype == torch.bfloat16 else 4
    if C < 1 or C % (16 // elem):
        raise ValueError(f"{what}: C={C} must be a multiple of {16 // elem}")
    return elem


def expand_plan(M: int, C: int, co: int, dtype: torch.dtype) -> dict:
    """``plan_expand`` of ``csrc/expand.cu`` for M input pixels: {"route": 0
    (wgmma) or 1 (SIMT), "rows", "wn", "split", "gpb", "sets", "tiles",
    "stages", "smem"} (``fused_expand.PLAN_FIELDS``).  Raises for shapes K3
    does not take."""
    elem = _check(C, dtype, "expand_ln")
    plan = None
    if M >= 1 and co >= 1 and co % 2 == 0:
        plan = (_plan_expand_wgmma(M, C, co) if elem == 2 else None) or _plan_simt(M, co, False,
                                                                                  elem)
    if plan is None:
        raise ValueError(f"expand_ln: no plan for M={M}, C={C}, co={co}")
    return plan


def head_plan(M: int, C: int, dtype: torch.dtype) -> dict:
    """``plan_head`` of ``csrc/expand.cu``, as :func:`expand_plan`."""
    elem = _check(C, dtype, "final_head")
    plan = None
    if M >= 1:
        plan = (_plan_head_wgmma(M, C) if elem == 2 else None) or _plan_simt(M, C, True, elem)
    if plan is None:
        raise ValueError(f"final_head: no plan for M={M}, C={C}")
    return plan


def _block_width(plan: dict, width: int) -> int:
    """Columns a block computes for a group of ``width`` valid ones: the
    wgmma route's padded tile; the SIMT route keeps only the valid ones."""
    if plan["route"] == 1:
        return width
    return 2 * plan["wn"] if plan["split"] else plan["wn"]


def _block_product(xf, wf, row0, ncol, kc, drop_last):
    """x (M, C) @ w[row0 : row0 + ncol]^T in fp32, weight rows past w's end
    zero, summed k-slab by k-slab of kc."""
    C = xf.shape[1]
    rows = torch.arange(row0, row0 + ncol)
    wb = torch.zeros(ncol, C, dtype=torch.float32, device=wf.device)
    ok = rows < wf.shape[0]
    wb[ok] = wf[rows[ok]]
    nk = -(-C // kc)
    e = torch.zeros(xf.shape[0], ncol, dtype=torch.float32, device=xf.device)
    for k in range(nk - 1 if drop_last else nk):
        e += xf[:, k * kc:(k + 1) * kc] @ wb[:, k * kc:(k + 1) * kc].t()
    return e


def _row_sum(v, col0, plan, head=False):
    """Sum of v (M, n: block columns col0 + [0, n)) along each row, as the
    epilogue combines it: where the warpgroups split the block's columns,
    each half summed apart, then warpgroup 0's partial plus warpgroup 1's; on
    K3's SIMT route each block's chunk of ``wn`` columns apart, then the
    cluster's partials in rank order; on K4's SIMT route the whole row."""
    if plan["route"] == 1:
        if head:
            return v.sum(1)
        return sum(v[:, c:c + plan["wn"]].sum(1) for c in range(0, v.shape[1], plan["wn"]))
    if not plan["split"]:
        return v.sum(1)
    cut = min(max(plan["wn"] - col0, 0), v.shape[1])
    return v[:, :cut].sum(1) + v[:, cut:].sum(1)


def expand_faults(plan: dict, co: int) -> tuple:
    """The faults of :data:`EXPAND_FAULTS` that can change K3's output under
    ``plan``: padded columns exist only on the wgmma route where the block's
    tile is wider than its groups."""
    pads = plan["route"] == 0 and _block_width(plan, plan["gpb"] * co) > plan["gpb"] * co
    return tuple(f for f in EXPAND_FAULTS if f != "pad columns in the variance" or pads)


def head_faults(plan: dict, C: int) -> tuple:
    """The faults of :data:`HEAD_FAULTS` that can change K4's output."""
    pads = plan["route"] == 0 and _block_width(plan, C) > C
    return tuple(f for f in HEAD_FAULTS if f != "pad columns in the variance" or pads)


def expand_tiled_ref(x, w, ln_w, ln_b, plan=None, fault=None):
    """K3's function computed block by block as the kernel does.  x (B, H, W,
    C); w (4 co, C); ln_w, ln_b (co) fp32.  ``plan``: by default the kernel's
    (:func:`expand_plan`); ``fault``: one of :data:`EXPAND_FAULTS` or None.
    Returns (B, 2H, 2W, co) in x's dtype."""
    B, H, W, C = x.shape
    co, M = w.shape[0] // 4, B * H * W
    plan = plan or expand_plan(M, C, co, x.dtype)
    xf, wf = x.reshape(M, C).float(), w.float()
    gpb, kc = plan["gpb"], 64 if plan["route"] == 0 else _SIMT_K3
    ncol = _block_width(plan, gpb * co)
    out = torch.empty(B, 2 * H, 2 * W, co, dtype=torch.float32, device=x.device)
    for g0 in range(0, 4, gpb):
        e = _block_product(xf, wf, g0 * co, ncol, kc, fault == "no last K chunk")
        for gl in range(gpb):
            lo, hi = gl * co, (gl + 1) * co
            if fault == "pad columns in the variance" and gl == gpb - 1:
                hi = ncol  # the block's tail of padded columns left unmasked
            v = e[:, lo:hi]
            mean = _row_sum(v, lo, plan) / co
            d = v - mean[:, None]
            rstd = torch.rsqrt(_row_sum(d * d, lo, plan) / co + _EPS)
            y = d[:, :co] * rstd[:, None] * ln_w + ln_b
            p1, p2 = (g0 + gl) >> 1, (g0 + gl) & 1
            if fault == "p1 and p2 swapped":
                p1, p2 = p2, p1
            out[:, p1::2, p2::2, :] = y.reshape(B, H, W, co)
    return out.to(x.dtype)


def head_tiled_ref(x, w1, ln_w, ln_b, seg_w, seg_b, plan=None, fault=None):
    """K4's function computed slot by slot as the kernel does.  x (B, h, w,
    C); w1 (16 C, C); ln_w, ln_b, seg_w (C), seg_b (1) fp32.  ``plan``: by
    default the kernel's (:func:`head_plan`); ``fault``: one of
    :data:`HEAD_FAULTS` or None.  Returns (B, h, w, 16) in x's dtype."""
    B, h, w, C = x.shape
    M = B * h * w
    plan = plan or head_plan(M, C, x.dtype)
    xf, wf = x.reshape(M, C).float(), w1.float()
    kc = 64 if plan["route"] == 0 else _SIMT_K4
    ncol = _block_width(plan, C)
    u = torch.zeros(ncol, dtype=torch.float32, device=x.device)
    u[:C] = ln_w * seg_w  # zeros past C, as the kernel's u
    cst = (ln_b * seg_w).sum() + seg_b.sum()
    width = ncol if fault == "pad columns in the variance" else C
    seg = torch.empty(M, 16, dtype=torch.float32, device=x.device)
    for s in range(16):
        e = _block_product(xf, wf, s * C, ncol, kc, fault == "no last K chunk")[:, :width]
        mean = _row_sum(e, 0, plan, head=True) / C
        d = e - mean[:, None]
        rstd = torch.rsqrt(_row_sum(d * d, 0, plan, head=True) / C + _EPS)
        pu = _row_sum((e if fault == "no mean in the head sum" else d) * u[:width], 0, plan,
                      head=True)
        seg[:, s] = rstd * pu + cst
    return seg.reshape(B, h, w, 16).to(x.dtype)
