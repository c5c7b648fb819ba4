"""Gather tables of the SS2D scan orders Tramba-V and Tramba-S run.

A frozen copy of the orders of Tramba's reference (``SpiralLine.py``,
``Dilation.py``, ``Window.py``): direction k reads flat pixel ``idx[k, t]``
at sequence position t.  ``raster`` (K=4), ``line`` (K=8: raster, then the
four Helix Bresenham line orders), ``window`` and ``dilation`` (K=4 each).
The merge is the scatter-add of the reference: a pixel that a line order
visits twice gets both outputs, one it misses gets none.
"""

from __future__ import annotations

import functools

import numpy as np


def raster(H: int, W: int) -> np.ndarray:
    """Row-major, column-major (the transposed read), and both reversed."""
    k0 = np.arange(H * W, dtype=np.int64)
    k1 = (k0 % H) * W + (k0 // H)
    return np.stack([k0, k1, k0[::-1], k1[::-1]])


def _bresenham(x0: int, y0: int, x1: int, y1: int) -> list:
    pts = []
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    while True:
        pts.append((x0, y0))
        if x0 == x1 and y0 == y1:
            return pts
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


def lines(H: int, W: int) -> np.ndarray:
    """The Helix orders (SpiralLine.py:27-82) on a square map: two
    interleaved families of diagonal lines, each also reversed line by line;
    flat index ``x + y * H``."""
    if H != W:
        raise ValueError(f"line orders need a square map, got {H}x{W}")
    fams = [[], [], [], []]

    def add(f, pts):
        fams[f].extend(pts)
        fams[f + 1].extend(pts[::-1])

    for r in range(0, H, 2):
        add(0, _bresenham(0, r, H - 1, W - 1 - r))
    for c in range(0 if H % 2 == 0 else 2, W, 2):
        add(0, _bresenham(c, W - 1, H - 1 - c, 0))
    for r in range(1, H, 2):
        add(2, _bresenham(0, r, H - 1, W - 1 - r))
    if H % 2:
        add(2, _bresenham(0, W - 1, H - 1, 0))
    for c in range(1, W, 2):
        add(2, _bresenham(c, W - 1, H - 1 - c, 0))
    out = []
    for pts in fams:
        a = np.asarray(pts, dtype=np.int64)
        if a.shape[0] != H * W:
            raise AssertionError(f"a line family covers {a.shape[0]} of {H * W} positions")
        out.append(a[:, 0] + a[:, 1] * H)
    return np.stack(out)


def dilation(H: int, W: int, rate: int) -> np.ndarray:
    """The raster orders, each regrouped into ``rate`` interleaved passes."""
    phase = np.arange(H * W) % rate
    order = np.concatenate([np.where(phase == p)[0] for p in range(rate)])
    return raster(H, W)[:, order]


def window(H: int, W: int, w: int) -> np.ndarray:
    """Window-partitioned raster orders on a square map: row-major windows
    read row-major, the transposed read, both reversed; flat ``p0 * H + p1``."""
    if H != W or H % w:
        raise ValueError(f"window {w} does not tile a {H}x{W} map")
    horiz, vert = [], []
    for i in range(0, H, w):
        for j in range(0, W, w):
            horiz.extend((i + x, j + y) for x in range(w) for y in range(w))
            vert.extend((j + x, i + y) for y in range(w) for x in range(w))
    return np.stack([np.asarray(p, dtype=np.int64) @ np.array([H, 1])
                     for p in (horiz, horiz[::-1], vert, vert[::-1])])


@functools.lru_cache(maxsize=None)
def order(kind: str, H: int, W: int, param: int = 0) -> np.ndarray:
    """(K, L) int64 gather table of ``kind``."""
    if kind == "raster":
        return raster(H, W)
    if kind == "line":
        return np.concatenate([raster(H, W), lines(H, W)])
    if kind == "dilation":
        return dilation(H, W, param or 4)
    if kind == "window":
        return window(H, W, param)
    raise ValueError(f"no reference for scan order {kind!r}")
