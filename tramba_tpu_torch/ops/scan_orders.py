"""Scan orders of the SS2D directions: gather tables and their inverses.

Port of ``tramba_tpu/ops/scan_orders.py``, every order of its ``get_order``:
``raster`` (K=4), ``line`` (K=8: raster plus the Helix Bresenham lines),
``line4`` (K=4, the lines alone), ``dilation`` and ``window`` (K=4 each), the
spiral, Hilbert and wrap-around diagonal orders (``spiral``, ``hilbert``,
``diagonal``, K=4; ``spiral8`` and ``diagonal8``, K=8, raster first) and the
ablation orders ``ab1`` / ``ab2`` (one or two base directions repeated to
K=4).  The generators are the same numpy code, so the tables are byte-equal
to the JAX package's.  ``line``, ``line4``, ``window``, ``spiral`` and
``spiral8`` take square maps only; the others any H x W.

A direction k reads flat pixel ``idx[k, t]`` at sequence position t.  The
merge is the scatter-add of the reference (``SpiralLine.py:109-133``), written
as gathers from a multi-slot inverse table ``inv[k, m, l]``: the sequence
positions that visited pixel l, padded with L.  Line orders visit some pixels
several times and miss others; a missed pixel gets 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "ScanOrder",
    "get_order",
    "order_tables",
    "cross_scan",
    "cross_merge",
    "raster_tables",
    "line_tables",
    "dilation_tables",
    "window_tables",
    "spiral_tables",
    "hilbert_tables",
    "diagonal_tables",
    "ab_tables",
]


def raster_tables(H: int, W: int) -> np.ndarray:
    """Row-major, column-major (transposed read), and both reversed."""
    L = H * W
    k0 = np.arange(L, dtype=np.int64)
    k1 = (k0 % H) * W + (k0 // H)
    return np.stack([k0, k1, k0[::-1], k1[::-1]]).astype(np.int32)


def _bresenham(x0: int, y0: int, x1: int, y1: int) -> list:
    """Integer line rasterization (SpiralLine.py:3-24 semantics)."""
    pts = []
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    while True:
        pts.append((x0, y0))
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy
    return pts


def line_tables(H: int, W: int) -> np.ndarray:
    """The 4 Helix Bresenham diagonal-line orders (SpiralLine.py:27-82): two
    interleaved families, each also reversed line by line.  Square maps only;
    flat index ``x + y * H`` as the reference (SpiralLine.py:103)."""
    if H != W:
        raise ValueError(f"line (Helix) scan orders are defined on square maps only "
                         f"(got {H}x{W}); use 'raster', 'window' or 'dilation'")
    fam0, fam0_flip, fam1, fam1_flip = [], [], [], []

    def add(fam, flip, pts):
        fam.extend(pts)
        flip.extend(pts[::-1])

    for start_row in range(0, H, 2):
        add(fam0, fam0_flip, _bresenham(0, start_row, H - 1, W - 1 - start_row))
    for start_col in range(0 if H % 2 == 0 else 2, W, 2):
        add(fam0, fam0_flip, _bresenham(start_col, W - 1, H - 1 - start_col, 0))
    for start_row in range(1, H, 2):
        add(fam1, fam1_flip, _bresenham(0, start_row, H - 1, W - 1 - start_row))
    if H % 2 != 0:
        add(fam1, fam1_flip, _bresenham(0, W - 1, H - 1, 0))
    for start_col in range(1, W, 2):
        add(fam1, fam1_flip, _bresenham(start_col, W - 1, H - 1 - start_col, 0))

    out = []
    for pts in (fam0, fam0_flip, fam1, fam1_flip):
        a = np.asarray(pts, dtype=np.int64)
        assert a.shape[0] == H * W, (a.shape, H, W)
        out.append(a[:, 0] + a[:, 1] * H)
    return np.stack(out).astype(np.int32)


def dilation_tables(H: int, W: int, rate: int = 4) -> np.ndarray:
    """The raster orders, each regrouped into ``rate`` interleaved passes
    (Dilation.py:3-45): positions = p (mod rate) first, then p+1, ..."""
    L = H * W
    base = raster_tables(H, W)
    phase = np.arange(L) % rate
    order = np.concatenate([np.where(phase == p)[0] for p in range(rate)])
    return base[:, order].astype(np.int32)


def window_tables(H: int, W: int, window: int) -> np.ndarray:
    """Window-partitioned raster orders (Window.py:3-35): horizontal (row-major
    windows, row-major inside), vertical (transposed), both reversed.  Square
    maps only: the reference's flat index is ``p0 * H + p1`` (Window.py:56),
    which on an H != W map misses pixels or overruns the map."""
    if H != W:
        raise ValueError(f"window scan orders are defined on square maps only (got {H}x{W})")
    if not (0 < window <= H and H % window == 0):
        raise ValueError(f"window {window} does not tile a {H}x{W} map")
    horiz, vert = [], []
    for i in range(0, H, window):
        for j in range(0, W, window):
            horiz.extend((i + x, j + y) for x in range(window) for y in range(window))
            vert.extend((j + x, i + y) for y in range(window) for x in range(window))
    tabs = []
    for pts in (horiz, horiz[::-1], vert, vert[::-1]):
        a = np.asarray(pts, dtype=np.int64)
        tabs.append(a[:, 0] * H + a[:, 1])
    return np.stack(tabs).astype(np.int32)


def spiral_tables(H: int, W: int) -> np.ndarray:
    """The clockwise inward spiral from the top-left corner, its transpose
    (counter-clockwise) and both reversed (Spiral.py:3-86, ``CrossScan_Spiral``
    csms6s.py:264-369).  Square maps only: the transpose is taken as ``j * W
    + i``, which on an H != W map misses pixels (16x12) or overruns the map
    (4x8)."""
    if H != W:
        raise ValueError(f"spiral scan orders are defined on square maps only (got {H}x{W})")
    order = []
    top, bottom, left, right = 0, H - 1, 0, W - 1
    while top <= bottom and left <= right:
        order.extend(top * W + j for j in range(left, right + 1))
        order.extend(i * W + right for i in range(top + 1, bottom + 1))
        if top < bottom:
            order.extend(bottom * W + j for j in range(right - 1, left - 1, -1))
        if left < right:
            order.extend(i * W + left for i in range(bottom - 1, top, -1))
        top, bottom, left, right = top + 1, bottom - 1, left + 1, right - 1
    cw = np.asarray(order, dtype=np.int64)
    assert cw.shape[0] == H * W
    i, j = np.divmod(cw, W)
    ccw = j * W + i
    return np.stack([cw, ccw, cw[::-1], ccw[::-1]]).astype(np.int32)


def _gilbert2d(width: int, height: int):
    """The generalized Hilbert curve over a width x height rectangle (the
    gilbert algorithm of Hilbert.py): (x, y) pairs, each cell once."""

    def sgn(v):
        return (v > 0) - (v < 0)

    def generate(x, y, ax, ay, bx, by):
        w, h = abs(ax + ay), abs(bx + by)
        dax, day, dbx, dby = sgn(ax), sgn(ay), sgn(bx), sgn(by)
        if h == 1:
            for _ in range(w):
                yield (x, y)
                x, y = x + dax, y + day
            return
        if w == 1:
            for _ in range(h):
                yield (x, y)
                x, y = x + dbx, y + dby
            return
        ax2, ay2, bx2, by2 = ax // 2, ay // 2, bx // 2, by // 2
        w2, h2 = abs(ax2 + ay2), abs(bx2 + by2)
        if 2 * w > 3 * h:
            if (w2 % 2) and (w > 2):
                ax2, ay2 = ax2 + dax, ay2 + day
            yield from generate(x, y, ax2, ay2, bx, by)
            yield from generate(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
        else:
            if (h2 % 2) and (h > 2):
                bx2, by2 = bx2 + dbx, by2 + dby
            yield from generate(x, y, bx2, by2, ax2, ay2)
            yield from generate(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
            yield from generate(x + (ax - dax) + (bx2 - dbx), y + (ay - day) + (by2 - dby),
                                -bx2, -by2, -(ax - ax2), -(ay - ay2))

    if width >= height:
        yield from generate(0, 0, width, 0, 0, height)
    else:
        yield from generate(0, 0, 0, height, width, 0)


def hilbert_tables(H: int, W: int) -> np.ndarray:
    """The Hilbert curve, its vertical flip and both reversed
    (``CrossScan_Hilbert`` csms6s.py:372-474, Hilbert.py:370-380)."""
    pts = np.asarray(list(_gilbert2d(W, H)), dtype=np.int64)  # (L, 2) as (x, y)
    flat = pts[:, 1] * W + pts[:, 0]
    flipped = (H - 1 - pts[:, 1]) * W + pts[:, 0]
    return np.stack([flat, flipped, flat[::-1], flipped[::-1]]).astype(np.int32)


def diagonal_tables(H: int, W: int) -> np.ndarray:
    """Wrap-around anti-diagonals (row r's columns shifted by r) and main
    diagonals (shifted by -r), each read column by column, and both reversed
    (csms6s.py:478-528)."""
    rows = np.repeat(np.arange(H), W).reshape(H, W)
    cols = np.tile(np.arange(W), H).reshape(H, W)
    anti = (rows * W + (cols + rows) % W).T.reshape(-1)
    diag = (rows * W + (cols - rows) % W).T.reshape(-1)
    return np.stack([anti, diag, anti[::-1], diag[::-1]]).astype(np.int32)


def ab_tables(H: int, W: int, ndir: int = 1) -> np.ndarray:
    """The ablation orders (csms6s.py:678-737): row-major four times
    (``ndir`` 1), or row-major and the transposed read, twice (``ndir`` 2)."""
    L = H * W
    k0 = np.arange(L, dtype=np.int32)
    if ndir == 1:
        return np.stack([k0, k0, k0, k0])
    k1 = raster_tables(H, W)[1]
    return np.stack([k0, k1, k0, k1]).astype(np.int32)


class ScanOrder:
    """K directions with their gather table and multi-slot inverse table.

    idx : (K, L) int32, position t of direction k reads pixel idx[k, t].
    inv : (K, max_mult, L) int32, the positions that read pixel l; padding
          slots hold L.
    """

    def __init__(self, idx: np.ndarray):
        idx = np.asarray(idx, dtype=np.int32)
        K, L = idx.shape
        self.K, self.L = K, L
        counts = np.zeros((K, L), dtype=np.int64)
        for k in range(K):
            np.add.at(counts[k], idx[k].astype(np.int64), 1)
        max_mult = int(counts.max())
        inv = np.full((K, max_mult, L), L, dtype=np.int32)
        fill = np.zeros((K, L), dtype=np.int64)
        for k in range(K):
            for p in range(L):
                l = int(idx[k, p])
                inv[k, fill[k, l], l] = p
                fill[k, l] += 1
        self.max_mult = max_mult
        self.is_permutation = max_mult == 1 and bool((counts == 1).all())
        self.idx = idx
        self.inv = inv


@functools.lru_cache(maxsize=None)
def get_order(kind: str, H: int, W: int, param: int = 0) -> ScanOrder:
    """``raster`` (K=4), ``line`` (K=8), ``line4`` (K=4), ``dilation`` (K=4,
    param = rate, default 4), ``window`` (K=4, param = window size),
    ``spiral``, ``hilbert``, ``diagonal``, ``ab1``, ``ab2`` (K=4), or
    ``spiral8`` / ``diagonal8`` (K=8, raster first)."""
    if kind == "raster":
        t = raster_tables(H, W)
    elif kind == "line":
        t = np.concatenate([raster_tables(H, W), line_tables(H, W)], axis=0)
    elif kind == "line4":
        t = line_tables(H, W)
    elif kind == "dilation":
        t = dilation_tables(H, W, param or 4)
    elif kind == "window":
        t = window_tables(H, W, param)
    elif kind == "spiral":
        t = spiral_tables(H, W)
    elif kind == "spiral8":
        t = np.concatenate([raster_tables(H, W), spiral_tables(H, W)], axis=0)
    elif kind == "hilbert":
        t = hilbert_tables(H, W)
    elif kind == "diagonal":
        t = diagonal_tables(H, W)
    elif kind == "diagonal8":
        t = np.concatenate([raster_tables(H, W), diagonal_tables(H, W)], axis=0)
    elif kind in ("ab1", "ab2"):
        t = ab_tables(H, W, int(kind[2]))
    else:
        raise ValueError(f"unknown scan order kind: {kind}")
    return ScanOrder(t)


@functools.lru_cache(maxsize=None)
def _tables_on(kind: str, H: int, W: int, param: int, device: str):
    order = get_order(kind, H, W, param)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (order.idx, order.inv))


def order_tables(kind: str, H: int, W: int, param: int, device) -> tuple:
    """(idx, inv) of an order as int32 tensors on ``device`` (cached)."""
    return _tables_on(kind, H, W, param, str(torch.device(device)))


def cross_scan(x: torch.Tensor, kind: str, H: int, W: int, param: int = 0) -> torch.Tensor:
    """(B, L, D) -> (B, K, L, D): the K directional sequences of an H x W map
    (``cross_scan``, ``tramba_tpu/ops/scan_orders.py:629``), one gather
    whose backward is one scatter-add."""
    idx, _ = order_tables(kind, H, W, param, x.device)
    B, L, D = x.shape
    return x.index_select(1, idx.reshape(-1).long()).reshape(B, *idx.shape, D)


def cross_merge(ys: torch.Tensor, kind: str, H: int, W: int, param: int = 0) -> torch.Tensor:
    """(B, K, L, D) -> (B, L, D): the K directional sequences summed back to
    their pixels (``cross_merge``, :634), the transpose of :func:`cross_scan`:
    one scatter-add in fp32 through the gather table (its backward is one
    gather), rounded once to ys's dtype."""
    idx, _ = order_tables(kind, H, W, param, ys.device)
    B, K, L, D = ys.shape
    y = ys.new_zeros((B, L, D), dtype=torch.float32)
    return y.index_add(1, idx.reshape(-1).long(), ys.float().reshape(B, K * L, D)).to(ys.dtype)
