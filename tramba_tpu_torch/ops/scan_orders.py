"""Scan orders of the SS2D directions: gather tables and their inverses.

Port of ``tramba_tpu/ops/scan_orders.py`` for the four orders the Tramba-V
inference path runs: ``raster`` (K=4), ``line`` (K=8: raster plus the Helix
Bresenham lines), ``dilation`` and ``window`` (K=4 each).  The generators are
the same numpy code, so the tables are byte-equal to the JAX package's.

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
    "raster_tables",
    "line_tables",
    "dilation_tables",
    "window_tables",
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
    """``raster`` (K=4), ``line`` (K=8), ``dilation`` (K=4, param = rate,
    default 4) or ``window`` (K=4, param = window size)."""
    if kind == "raster":
        t = raster_tables(H, W)
    elif kind == "line":
        t = np.concatenate([raster_tables(H, W), line_tables(H, W)], axis=0)
    elif kind == "dilation":
        t = dilation_tables(H, W, param or 4)
    elif kind == "window":
        t = window_tables(H, W, param)
    else:
        raise NotImplementedError(
            f"scan order {kind!r} is not ported yet (ROADMAP.md, Queue 1 item 11)")
    return ScanOrder(t)


@functools.lru_cache(maxsize=None)
def _tables_on(kind: str, H: int, W: int, param: int, device: str):
    order = get_order(kind, H, W, param)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (order.idx, order.inv))


def order_tables(kind: str, H: int, W: int, param: int, device) -> tuple:
    """(idx, inv) of an order as int32 tensors on ``device`` (cached)."""
    return _tables_on(kind, H, W, param, str(torch.device(device)))
