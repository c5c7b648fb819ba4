"""Plain mirror of how K1's projection launch tiles and splits its work
(``ss2d_proj_split_kernel`` in ``csrc/ss2d.cu``), beside
:func:`tramba_tpu_torch.ops.fused_ss2d.ss2d_proj_ref`, the plain fp32
product.

* :func:`proj_plan`: the launcher's plan (``plan_proj``; the card reports it
  through ``fused_ss2d.ss2d_proj_plan``): a block's rows (128, the two
  warpgroups splitting the rows, or 64, splitting the columns), the columns
  a warpgroup owns (the ``wgmma`` N), the column tiles, the row tiles, the
  ring's slots and the shared memory.
* :func:`split3`: the three bf16 terms of an fp32 tensor, v = h + m + l
  (exact): h = bf16(v), m = bf16(v - h), l = bf16(v - h - m), as the
  kernel splits the weight (once a weight version, into the scratch
  ``fused_ss2d.proj_weight_terms`` keeps) and an fp32 x (per slab).
* :func:`proj_tiled_ref`: per column tile, the tile's weight rows (zeros past
  N) split into their terms, x as it is (bf16) or split too (fp32), and the
  sum of the products the kernel runs (bf16 x: x h, x m, x l; fp32 x: the
  six whose terms reach 2^-24 of the whole), each bf16 x bf16 product exact
  in fp32; rows and columns past M and N dropped.

:func:`proj_tiled_ref` takes ``fault``, a named mistake planted in the mirror
(:data:`PROJ_FAULTS`), so that a check can show it would see a kernel making
it (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import torch

__all__ = ["PLAN_FIELDS", "PROJ_FAULTS", "PROJ_WNS", "proj_cols", "proj_fixed", "proj_plan",
           "proj_stage", "proj_tiled_ref", "split3"]

# fields of a plan, in the order the library reports them
PLAN_FIELDS = ("rows", "wn", "ctiles", "tiles", "stages", "smem")
PROJ_WNS = (32, 48, 72, 80, 96, 144)  # a warpgroup's columns (kProjWns)
_MAX_SPLIT_WN = 96                    # rows 64 up to this WN (kProjMaxSplitWn)
_SMEM_BLOCK = 227 * 1024              # shared memory one block may use
_HALF_SM = 113 * 1024                 # two blocks an SM below this
# "no second and third terms": the weight's (and fp32 x's) h term alone, one
# bf16 pass; "no last column tile": the last column tile's columns left
# unwritten (zeros); "row tiles from row 0": every row tile's products taken
# over the first tile's rows of x
PROJ_FAULTS = ("no second and third terms", "no last column tile", "row tiles from row 0")
# (x term, w term) of each product, in the kernel's order
_PAIRS = {torch.bfloat16: ((0, 2), (0, 1), (0, 0)),
          torch.float32: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}


def proj_cols(rows: int, wn: int) -> int:
    """A column tile's width: a warpgroup's ``wn`` at 128 rows, two at 64."""
    return wn if rows == 128 else 2 * wn


def proj_stage(rows: int, cols: int, f32x: bool) -> int:
    """Bytes of a ring slot (``proj_stage``): one k-slab of x's rows (bf16 128
    bytes a row, fp32 256) and of the weight's three terms (128 bytes a row)."""
    return rows * (256 if f32x else 128) + 3 * cols * 128


def proj_fixed(rows: int, f32x: bool) -> int:
    """Bytes beside the ring (``proj_fixed``): alignment and mbarriers, and for
    an fp32 x two buffers of its split terms."""
    return 2048 + (2 * 3 * rows * 128 if f32x else 0)


def proj_plan(M: int, D: int, N: int, dtype: torch.dtype) -> dict:
    """The plan of the projection of an (M, D) x onto N columns in x's
    ``dtype``: the fewest waves of blocks over 132 SMs (two blocks an SM
    where three ring slots fit in half of its shared memory) times a
    block's work ((rows + 32) x (columns + 48)), the fewer blocks on a tie;
    up to four ring slots.  {field: value} over :data:`PLAN_FIELDS`; raises
    for shapes the kernel does not take."""
    if dtype not in _PAIRS:
        raise TypeError(f"ss2d_proj: float32 or bfloat16 x, not {dtype}")
    f32x = dtype == torch.float32
    if M < 1 or N < 1 or D < 1 or D % (4 if f32x else 8):
        raise ValueError(f"ss2d_proj: M={M}, N={N} must be positive and D={D} a multiple of "
                         f"{4 if f32x else 8}")
    best = None
    for rows in (128, 64):
        for wn in PROJ_WNS:
            if rows == 64 and wn > _MAX_SPLIT_WN:
                continue
            cols = proj_cols(rows, wn)
            stage, fixed = proj_stage(rows, cols, f32x), proj_fixed(rows, f32x)
            two = wn <= 96 and not f32x and fixed + 3 * stage <= _HALF_SM
            budget = _HALF_SM if two else _SMEM_BLOCK
            if fixed + 2 * stage > budget:
                continue
            stages = min(4, (budget - fixed) // stage)
            ct, tiles = -(-N // cols), -(-M // rows)
            blocks, per = tiles * ct, 132 * (2 if two else 1)
            cost = -(-blocks // per) * (2 if two else 1) * (rows + 32) * (cols + 48)
            if best is None or (cost, blocks) < best[:2]:
                best = (cost, blocks, dict(rows=rows, wn=wn, ctiles=ct, tiles=tiles,
                                           stages=stages, smem=fixed + stages * stage))
    return best[2]


def split3(v: torch.Tensor) -> tuple:
    """(h, m, l): bf16 tensors with v = h + m + l exactly (normal fp32 v): h =
    bf16(v), m = bf16(v - h), l = bf16(v - h - m), each difference exact in
    fp32 and l exactly a bf16."""
    v = v.float()
    h = v.to(torch.bfloat16)
    r = v - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


def proj_tiled_ref(x, x_proj_w, plan=None, fault=None):
    """dbc (B, L, K, R+2), fp32, as the kernel tiles and splits it: x (B, L,
    D) fp32 or bf16, x_proj_w (K, R+2, D) fp32; ``plan`` (:func:`proj_plan`'s
    by default) gives the column tiles; ``fault`` one of
    :data:`PROJ_FAULTS` or None."""
    B, L, D = x.shape
    K, C, _ = x_proj_w.shape
    M, N = B * L, K * C
    plan = plan or proj_plan(M, D, N, x.dtype)
    rows, cols = plan["rows"], proj_cols(plan["rows"], plan["wn"])
    xm = x.reshape(M, D)
    xt = [t.float() for t in split3(xm)] if x.dtype == torch.float32 else [xm.float()]
    wt = [t.float() for t in split3(x_proj_w.reshape(N, D))]
    pairs = _PAIRS[x.dtype]
    if fault == "no second and third terms":
        pairs = ((0, 0),)
    elif fault == "row tiles from row 0":
        xt = [t[torch.arange(M, device=t.device) % rows] for t in xt]
    elif fault not in (None, "no last column tile"):
        raise ValueError(f"unknown fault {fault!r}")
    out = torch.zeros(M, N, device=x.device, dtype=torch.float32)
    for ct in range(plan["ctiles"]):
        if fault == "no last column tile" and ct == plan["ctiles"] - 1:
            continue
        n0, n1 = ct * cols, min(N, (ct + 1) * cols)
        acc = torch.zeros(M, n1 - n0, device=x.device, dtype=torch.float32)
        for xi, wi in pairs:
            acc = acc + xt[xi] @ wt[wi][n0:n1].t()
        out[:, n0:n1] = acc
    return out.reshape(B, L, K, C)
