"""Plain mirror of how the redesigned K11 ``ln_dwmlp`` (``csrc/mlp.cu``), K12
``sra`` and K13 ``window_attn`` (``csrc/attn.cu``, ``csrc/common.cuh``) split
their work, beside :func:`tramba_tpu_torch.ops.fused_mlp.ln_dwmlp_ref`,
:func:`tramba_tpu_torch.ops.fused_attn.sra_ref` and
:func:`tramba_tpu_torch.ops.fused_attn.window_attn_ref`, which follow the TPU
kernels' own order.

* :func:`dwmlp_plan`: ``plan_dwmlp`` and ``pick_dwmlp_splits`` (the card
  reports them through ``fused_mlp.dwmlp_plan``): fc2's output tiles a
  warpgroup, the ring's slots, blocks an SM, shared bytes, 8x8 tiles, hidden
  chunks of 64 and their splits over blocks; above d 384 the wide route's
  (K7's ``dwms_tile_kernel``).
* :func:`dwmlp_tiled_ref`: per 8x8 output tile, its 10 x 10 halo of fc1
  outputs (LN'd and projected per halo pixel, zero outside the image), the
  3x3 stencil and GELU per tile, fc2 summed chunk by chunk of 64 hidden
  channels within a split, then b2 and the splits' partial sums in order.
* :func:`sra_plan`: ``plan_sra`` (the card reports it through
  ``fused_attn.sra_plan``): head-width chunks of 64, warpgroups and query
  rows a block, blocks a row tile (the cluster that splits the heads), row
  tiles, key tiles held in registers, key chunks, ring slots, whether the
  merged heads share the LayerNorm's tile, blocks an SM, shared bytes; or,
  for shapes the one-launch block cannot hold, the wide route's (16 query
  rows a block, unpadded heads, keys a chunk).
* :func:`sra_tiled_ref`: per row tile of the plan's rows, per head of the
  cluster's blocks in turn: the LayerNorm of the tile's rows, q rounded, the
  scores over key tiles of 64 (the wide route: chunks of its keys; zero
  keys past Lk, masked), each row's max and sum (over key chunks, rescaled,
  where there are two passes), p rounded, p v rounded into the merged row;
  then the output projection and one rounding.
* :func:`front_plan`, :func:`window_plan`: K13's two launches (``plan_front``
  for the LN + qkv front; the attention launch's blocks a window, its
  shared bytes from ``fused_attn.window_smem``).
* :func:`window_tiled_ref`: launch (i) the LayerNorm and qkv projection of
  every pixel, heads padded to 16, q scaled, bf16; launch (ii) per window,
  per group of 48 query rows, per head in order: scores + bias (+ mask),
  softmax, p rounded, p v rounded into the merged row, then the output
  projection and one rounding.

Each tiled mirror takes ``fault``, a named mistake planted in it, so that a
check can show it would see a kernel making it (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops.fused_attn import (SRA_WIDE_ROWS, _pad_heads, _pad_out_proj, _scale,
                                             attn_plan, check_sra_shape, sra_least_slots,
                                             sra_smem, sra_wide_keys, sra_wide_smem, window_smem)
from tramba_tpu_torch.ops.fused_mlp import _ln_rounded

__all__ = ["DWMLP_FAULTS", "WINDOW_FAULTS", "cheapest_splits", "dwmlp_faults", "dwmlp_plan",
           "dwmlp_tiled_ref", "wave_splits",
           "front_plan", "window_faults", "window_plan", "window_tiled_ref", "SRA_FAULTS",
           "sra_faults", "sra_plan", "sra_tiled_ref"]

# "h not zero outside": the halo pixels past the image keep fc1's bias (LN of
# a zero row is zero, so h = b1 there); "halo cut at the tile edge": each
# tile's stencil sees zeros in place of its neighbours' pixels; "no last
# chunk": the last 64 hidden channels left out of fc2; "no last split": the
# last split's partial sums left out where the chunks are split over blocks
DWMLP_FAULTS = ("h not zero outside", "halo cut at the tile edge", "no last chunk",
                "no last split")
# "mask of window 0 everywhere": every window takes window 0's mask; "row
# groups from row 0": each block's query rows read from the window's first
# 48 (the rows it stores are right); "heads swapped in the merged row": head
# h's output at head nh - 1 - h's columns
WINDOW_FAULTS = ("mask of window 0 everywhere", "row groups from row 0",
                 "heads swapped in the merged row")

# "head slices swapped in the merged row": each block of a cluster writes its
# heads at the next block's heads' columns (without a cluster, head h at
# head nh - 1 - h's); "row tiles from row 0": each row tile's queries read
# from the image's first rows (the rows it stores are right); "padded keys
# not masked": the zero keys of the last key tile take part in the softmax;
# "no second key pass": on the two-pass route each key chunk's p normalised
# by that chunk's own max and sum
SRA_FAULTS = ("head slices swapped in the merged row", "row tiles from row 0",
              "padded keys not masked", "no second key pass")

SMS = 132                 # SMs of an H100
SMEM_BLOCK = 227 * 1024   # shared memory one block may use
HALF_SM = 113 * 1024      # two blocks an SM below this
_BOX = 64 * 64 * 2        # bytes of one 64 x 64 bf16 TMA box
_TILE, _HALO, _HALO_ROWS, _LDH = 8, 10, 104, 72  # K11: output tile side, halo side, As rows
_PARAMS = 64 + 64 + 64 * 9 // 2                  # K11: floats of one chunk's b1, c3, taps
_TILE_MAX_D = 384                                # K11: widest d of dwmlp_tile_kernel
_HALO7, _TAP_CHUNK = 14 * 14 * 64, 50 * 64       # K7: fp32 halo box, merged taps a chunk
_WIN_ROWS, _WIN_KEYS = 48, 144                   # K13: query rows a block, keys


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def cheapest_splits(blocks: int, slots: int, nchunks: int, block_s: float, M: int,
                    d: int) -> int:
    """``cheapest_splits`` of ``csrc/mlp.cu`` (K6's and K11's rule): the
    number of splits of ``nchunks`` hidden chunks over blocks whose waves of
    products (``block_s`` seconds a block) and fp32 partial sums cost least."""
    slots = max(1, slots)
    best, best_cost = 1, 0.0
    for s in range(1, min(16, nchunks) + 1):
        cost = ((blocks * s + slots - 1) // slots) * block_s / s + (
            8.0 * M * d * s / 2.5e12 if s > 1 else 0.0)
        if s == 1 or cost < best_cost:
            best, best_cost = s, cost
    cps = -(-nchunks // best)
    return -(-nchunks // cps)


def wave_splits(blocks: int, slots: int, nchunks: int) -> int:
    """``pick_splits`` of ``csrc/mlp.cu`` with ``below_a_wave`` (K7's rule):
    none unless the grid fills less than one wave, then the fewest splits
    that cut the wave-quantised time by more than 10% each, at most 8."""
    best, best_cost = 1, float(-(-blocks // slots))
    if blocks < slots:
        for s in range(2, min(8, nchunks) + 1):
            cost = -(-(blocks * s) // slots) / s
            if cost < 0.9 * best_cost:
                best, best_cost = s, cost
    cps = -(-nchunks // best)
    return -(-nchunks // cps)


def dwmlp_plan(B: int, H: int, W: int, d: int, hid: int, sms: int = SMS) -> dict:
    """``plan_dwmlp`` and ``pick_dwmlp_splits`` of ``csrc/mlp.cu``: {"NT",
    "stages", "per_sm", "smem", "tiles", "nchunks", "splits", "wide"}
    (``fused_mlp.DWMLP_PLAN_FIELDS``); above d 384 the wide route's
    ``dwms_tile_kernel`` plan (``ln_dwmlp_plan``).  Raises for shapes K11
    does not take."""
    if min(B, H, W) < 1 or d % 16 or hid % 16 or d < 16 or d > 512 or hid < 16:
        raise ValueError(f"ln_dwmlp: no plan for B={B}, {H}x{W}, d={d}, hid={hid}")
    nkd = -(-d // 64)
    tiles = -(-H // _TILE) * -(-W // _TILE)
    nchunks = -(-hid // 64)
    if d > _TILE_MAX_D:  # K7's tile kernel: two warpgroups, up to 4 output tiles each
        NT = -(-nkd // 2)
        stages = min(2 * NT, 5)
        smem = 1024 + 2 * 64 * 64 * 2 + stages * 2 * _BOX + 2 * _HALO7 * 4 + 2 * _TAP_CHUNK * 4
        per_sm = 1 if smem > HALF_SM else 2
        return dict(NT=NT, stages=stages, per_sm=per_sm, smem=smem, tiles=tiles,
                    nchunks=nchunks, splits=wave_splits(tiles * B, per_sm * sms, nchunks),
                    wide=1)
    NT = (nkd + 1) // 2
    fixed = (1024 + nkd * _HALO_ROWS * 128 + 2 * 64 * 128 + _HALO * _HALO * _LDH * 4
             + 2 * _PARAMS * 4)
    group = 2 * nkd
    budget = SMEM_BLOCK
    if NT == 1 and fixed + group * _BOX <= HALF_SM:
        budget = HALF_SM
    stages = min(16, (budget - min(budget, fixed)) // _BOX)
    per_sm = 1 if budget == SMEM_BLOCK else 2
    if NT > 3 or stages < group:
        raise ValueError(f"ln_dwmlp: no plan for d={d} (its tiles do not fit one block)")
    block_s = 2.0 * 64 * 64 * 64 * nchunks * (2.0 * nkd + nkd) / 2.5e12
    splits = cheapest_splits(tiles * B, per_sm * sms, nchunks, block_s, B * H * W, d)
    return dict(NT=NT, stages=stages, per_sm=per_sm, smem=fixed + stages * _BOX, tiles=tiles,
                nchunks=nchunks, splits=splits, wide=0)


def dwmlp_faults(plan: dict) -> tuple:
    """The faults of :data:`DWMLP_FAULTS` that bear on a call with ``plan``."""
    return tuple(f for f in DWMLP_FAULTS if f != "no last split" or plan["splits"] > 1)


def dwmlp_tiled_ref(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps=1e-6, splits=1, fault=None):
    """K11's tiling in plain PyTorch: the arguments of ``fused_mlp.ln_dwmlp``
    and the plan's ``splits``.  Returns (B, H, W, d) in x's dtype."""
    if fault is not None and fault not in DWMLP_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    cd = x.dtype
    B, H, W, d = x.shape
    hid = w1.shape[0]
    ty, tx = -(-H // _TILE), -(-W // _TILE)
    # fc1 of every halo pixel: the image inside a ring of one pixel around
    # its whole tiles, zero outside the image
    h = _ln_rounded(x, ln_w, ln_b, eps) @ w1.to(cd).float().t() + b1.float()
    hp = h.new_zeros(B, _TILE * ty + 2, _TILE * tx + 2, hid)
    if fault == "h not zero outside":
        hp += b1.float()
    hp[:, 1:H + 1, 1:W + 1] = h
    halos = hp.unfold(1, _HALO, _TILE).unfold(2, _HALO, _TILE)  # (B, ty, tx, hid, 10, 10)
    halos = halos.reshape(B * ty * tx, hid, _HALO, _HALO)
    if fault == "halo cut at the tile edge":
        halos = F.pad(halos[..., 1:-1, 1:-1], (1, 1, 1, 1))
    a = F.conv2d(halos, k3.to(cd).float(), c3.float(), groups=hid)  # (tiles, hid, 8, 8)
    g = F.gelu(a).to(cd).float()
    g = g.reshape(B, ty, tx, hid, _TILE, _TILE).permute(0, 1, 4, 2, 5, 3)
    g = g.reshape(B, ty * _TILE, tx * _TILE, hid)[:, :H, :W]
    # fc2 chunk by chunk, summed within a split; b2, then the splits in order
    w2c = w2.to(cd).float()
    nchunks = -(-hid // 64)
    cps = -(-nchunks // splits)
    parts = []
    for c_first in range(0, nchunks, cps):
        acc = g.new_zeros(B, H, W, d)
        for c in range(c_first, min(nchunks, c_first + cps)):
            if fault == "no last chunk" and c == nchunks - 1:
                continue
            acc = acc + g[..., 64 * c:64 * c + 64] @ w2c[:, 64 * c:64 * c + 64].t()
        parts.append(acc)
    if fault == "no last split" and len(parts) > 1:
        parts = parts[:-1]
    if len(parts) == 1:
        return (parts[0] + b2.float()).to(cd)
    out = b2.float().expand(B, H, W, d)
    for p in parts:
        out = out + p
    return out.to(cd)


def front_plan(M: int, d: int, hid: int) -> dict:
    """``plan_front`` of ``csrc/common.cuh`` for the forward front (K7's and
    K13's launch (i)): {"rows", "groups", "cps", "stages", "smem"}."""
    if d % 8 or hid % 16 or d < 8 or d > 1024 or hid < 16 or M < 1:
        raise ValueError(f"front: no plan for M={M}, d={d}, hid={hid}")
    dp, nchunks = _up(d, 64), -(-hid // 128)
    fixed, slot = 1024 + 64 * dp * 2, 2 * _BOX
    budget = HALF_SM if fixed + 4 * slot <= HALF_SM else SMEM_BLOCK
    stages = min(8, (budget - min(budget, fixed)) // slot)
    if stages < 3:
        raise ValueError(f"front: no plan for d={d} (its tiles do not fit one block)")
    rows = -(-M // 64)
    want = max(1, min(nchunks, (2 * SMS + rows - 1) // rows))
    cps = -(-nchunks // want)
    return dict(rows=rows, groups=-(-nchunks // cps), cps=cps, stages=stages,
                smem=fixed + stages * slot)


def window_plan(B: int, H: int, W: int, C: int, nh: int, w: int) -> dict:
    """K13's plan (``window_attn_plan`` of ``csrc/attn.cu``): the front's
    {"rows", "groups", "cps", "stages", "front_smem"}, the attention
    launch's "row_groups" (blocks a window) and "smem", and "blocks" (its
    grid).  Raises for shapes K13 does not take (as
    ``fused_attn.check_window_attn_shape``)."""
    N = w * w
    hd16, Cq, N16 = attn_plan(C, nh, N)
    if (min(B, H, W, w) < 1 or H % w or W % w or N16 != N or N > _WIN_KEYS or C % 8
            or hd16 not in (16, 32, 48, 64)):
        raise ValueError(f"window_attn: no plan for B={B}, {H}x{W}, C={C}, nh={nh}, w={w}")
    front = front_plan(B * H * W, C, 3 * Cq)
    smem = window_smem(Cq, hd16, N)
    if smem > SMEM_BLOCK:
        raise ValueError(f"window_attn: no plan for C={C}, nh={nh} (its tiles do not fit one "
                         "block)")
    row_groups = -(-N // _WIN_ROWS)
    return dict(rows=front["rows"], groups=front["groups"], cps=front["cps"],
                stages=front["stages"], front_smem=front["smem"], row_groups=row_groups,
                smem=smem, blocks=row_groups * B * (H // w) * (W // w))


def window_faults(N: int, nW: int, masked: bool) -> tuple:
    """The faults of :data:`WINDOW_FAULTS` that bear on windows of N tokens,
    nW windows an image, with or without a mask."""
    bears = {"mask of window 0 everywhere": masked and nW > 1,
             "row groups from row 0": N > _WIN_ROWS, "heads swapped in the merged row": True}
    return tuple(f for f in WINDOW_FAULTS if bears[f])


def window_tiled_ref(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps=1e-5, fault=None):
    """K13's split in plain PyTorch: the arguments of
    ``fused_attn.window_attn``.  Returns (B, H, W, C) in x's dtype."""
    if fault is not None and fault not in WINDOW_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    cd = x.dtype
    B, H, W, C = x.shape
    N = bias.shape[-1]
    w = int(round(N ** 0.5))
    nWh, nWw = H // w, W // w
    nW, hd = nWh * nWw, C // nh
    hd16, Cq, _ = attn_plan(C, nh, N)
    # (i) every pixel's LayerNorm and qkv projection, heads padded, q scaled
    wq, bq = _pad_heads(wqkv, nh, hd16, 3), _pad_heads(bqkv, nh, hd16, 3)
    qkv = _ln_rounded(x, ln_w, ln_b, eps) @ wq.to(cd).float().t() + bq.float()
    qkv = torch.cat([qkv[..., :Cq] * _scale(hd), qkv[..., Cq:]], -1).to(cd).float()
    # (ii) per window (batch-major), per group of 48 query rows, per head
    win = qkv.reshape(B, nWh, w, nWw, w, 3 * Cq).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(B * nW, N, 3, nh, hd16).permute(2, 0, 3, 1, 4)  # (3, G, nh, N, hd16)
    q, k, v = win[0], win[1], win[2]
    wmask = None
    if mask is not None:
        m = mask.float()
        if fault == "mask of window 0 everywhere":
            m = m[:1].expand(nW, N, N)
        wmask = m.repeat(B, 1, 1)  # (G, N, N): window g % nW
    os = q.new_zeros(B * nW, N, Cq)
    for r0 in range(0, N, _WIN_ROWS):
        rows = torch.arange(r0, min(N, r0 + _WIN_ROWS))
        src = rows - r0 if fault == "row groups from row 0" else rows
        for h in range(nh):
            s = q[:, h, src] @ k[:, h].transpose(-1, -2) + bias[h, src].float()
            if wmask is not None:
                s = s + wmask[:, src]
            p = torch.softmax(s, dim=-1).to(cd).float()
            col = nh - 1 - h if fault == "heads swapped in the merged row" else h
            os[:, rows, col * hd16:(col + 1) * hd16] = (p @ v[:, h]).to(cd).float()
    wpq, bpq = (wp, bp) if Cq == C else _pad_out_proj(wp, bp, nh, hd16)
    out = os @ wpq.to(cd).float().t() + bpq.float()
    out = out.reshape(B, nWh, nWw, w, w, Cq).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, Cq)
    return out[..., :C].to(cd)


_SRA_RING = 8                    # K12: most ring slots


def sra_plan(B: int, N: int, C: int, nh: int, Lk: int, sms: int = SMS) -> dict:
    """``plan_sra`` of ``csrc/attn.cu``: {"nq", "nwg", "rows", "cluster",
    "tiles", "kt", "chunks", "stages", "alias", "per_sm", "smem", "blocks"}
    (``fused_attn.SRA_PLAN_FIELDS``).  Raises for shapes K12 does not take
    (as ``fused_attn.check_sra_shape``).  Two warpgroups (128 rows a block,
    one block an SM) up to C 192 with 64-wide heads, else one (two blocks an
    SM where 113 KB hold them); the cluster size d, a divisor of nh up to
    8, with the fewest waves per unit of work, ceil(tiles d / (sms per_sm))
    / d, the smallest such; the merged heads in the LayerNorm's tile where
    each block takes one head and Cq = C rounded up to 64.  Where that block
    cannot hold the shape, the wide route: 16 query rows a block and head,
    the heads unpadded, the most keys a chunk that fit (``wide`` 1)."""
    if min(B, N) < 1:
        raise ValueError(f"sra: no plan for B={B}, N={N}")
    hdp, Cq, wide = check_sra_shape(C, nh, Lk)
    if wide:  # three launches; the fields of the attention launch
        keys, rows = sra_wide_keys(hdp), SRA_WIDE_ROWS
        tiles = -(-N // rows)
        return dict(nq=0, nwg=0, rows=rows, cluster=1, tiles=tiles, kt=0,
                    chunks=-(-Lk // keys), stages=0, alias=0, per_sm=0,
                    smem=sra_wide_smem(hdp, keys), blocks=B * tiles * nh, wide=1, keys=keys)
    nq, Cp, ktiles = hdp // 64, _up(C, 64), -(-Lk // 64)
    least = sra_least_slots(hdp)
    nwg = 2 if C <= 192 and nq == 1 and sra_smem(C, Cq, 128, least) <= SMEM_BLOCK else 1
    rows = 64 * nwg
    tiles = -(-N // rows)
    kt_max = min(ktiles, 4 if nq == 1 else 2)
    best = None
    for d in range(1, min(8, nh) + 1):
        if nh % d:
            continue
        alias = d == nh and Cq == Cp
        fixed = sra_smem(C, Cq, rows, 0, alias)
        if fixed + least * _BOX > SMEM_BLOCK:
            continue
        two = nwg == 1 and fixed + (kt_max * nq + 1) * _BOX <= HALF_SM
        per_sm = 2 if two else 1
        cost = -(-(B * tiles * d) // (sms * per_sm)) / d
        if best is not None and cost >= best[0]:
            continue
        stages = min(_SRA_RING, ((HALF_SM if two else SMEM_BLOCK) - fixed) // _BOX)
        best = (cost, d, int(alias), per_sm, stages, fixed + stages * _BOX)
    _, cluster, alias, per_sm, stages, smem = best
    kt = kt_max
    while kt > 1 and stages < kt * nq + 1:
        kt -= 1
    return dict(nq=nq, nwg=nwg, rows=rows, cluster=cluster, tiles=tiles, kt=kt,
                chunks=-(-ktiles // kt), stages=stages, alias=alias, per_sm=per_sm, smem=smem,
                blocks=B * tiles * cluster, wide=0, keys=64 * kt)


def sra_faults(plan: dict, N: int, nh: int, Lk: int) -> tuple:
    """The faults of :data:`SRA_FAULTS` that bear on a K12 call with ``plan``."""
    unit = plan["keys"] if plan["wide"] else 64  # keys a tile
    bears = {"head slices swapped in the merged row": nh > 1,
             "row tiles from row 0": N > plan["rows"], "padded keys not masked": Lk % unit != 0,
             "no second key pass": plan["chunks"] > 1}
    return tuple(f for f in SRA_FAULTS if bears[f])


def sra_tiled_ref(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6, plan=None, fault=None):
    """K12's tiling in plain PyTorch: the arguments of ``fused_attn.sra`` and
    its plan (:func:`sra_plan` of the call's shape unless given).  Returns
    (B, N, C) in x's dtype."""
    if fault is not None and fault not in SRA_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    cd = x.dtype
    B, N, C = x.shape
    Lk, hd = k.shape[2], C // nh
    plan = plan or sra_plan(B, N, C, nh, Lk)
    rows, cluster, chunks, ck = plan["rows"], plan["cluster"], plan["chunks"], plan["keys"]
    hdp = hd if plan["wide"] else 64 * plan["nq"]
    unit = ck if plan["wide"] else 64  # keys a tile
    # the tile's rows normalised; a row tile's queries (faulty: the image's
    # first rows)
    y = _ln_rounded(x, ln_w, ln_b, eps)
    src = torch.arange(N, device=x.device)
    if fault == "row tiles from row 0":
        src = (src % rows).clamp_max(N - 1)
    y = y[:, src]
    wqp, bqp = _pad_heads(wq, nh, hdp).to(cd).float(), _pad_heads(bq, nh, hdp).float()
    pad = (0, hdp - hd, 0, -(-Lk // unit) * unit - Lk)  # zero head columns, keys to a tile
    kp, vp = (torch.nn.functional.pad(t.to(cd).float(), pad) for t in (k, v))
    valid = torch.arange(kp.shape[2], device=x.device) < Lk
    if fault == "padded keys not masked":
        valid = torch.ones_like(valid)
    os = y.new_zeros(B, N, nh * hdp)
    # each block of a cluster its heads in turn (rank r: heads r, r + cluster, ...)
    for h in sorted(range(nh), key=lambda h: (h % cluster, h)):
        q = ((y @ wqp[h * hdp:(h + 1) * hdp].t() + bqp[h * hdp:(h + 1) * hdp]) * _scale(hd))
        s = q.to(cd).float() @ kp[:, h].transpose(-1, -2)
        s = s.masked_fill(~valid, float("-inf"))
        if chunks == 1:
            p = torch.softmax(s, -1)
        elif fault == "no second key pass":  # each chunk by its own statistics
            p = torch.cat([torch.softmax(s[..., c:c + ck], -1) for c in range(0, s.shape[-1], ck)],
                          -1)
        else:  # pass 1: the rescaled running max and sum over the chunks
            m = torch.full_like(s[..., 0], float("-inf"))
            sm = torch.zeros_like(m)
            for c in range(0, s.shape[-1], ck):
                n = torch.maximum(m, s[..., c:c + ck].amax(-1))
                sm = sm * torch.exp(m - n) + torch.exp(s[..., c:c + ck] - n[..., None]).sum(-1)
                m = n
            p = torch.exp(s - m[..., None]) / sm[..., None]
        col = h
        if fault == "head slices swapped in the merged row":
            col = ((h % cluster + 1) % cluster + h - h % cluster if cluster > 1 else nh - 1 - h)
        os[..., col * hdp:(col + 1) * hdp] = (p.to(cd).float() @ vp[:, h]).to(cd).float()
    wpp = _pad_heads(wp.t(), nh, hdp).t().to(cd).float()
    return (os @ wpp.t() + bp.float()).to(cd)
