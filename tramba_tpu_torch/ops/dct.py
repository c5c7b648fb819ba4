"""2-D DCT quadrants of the DFVSS guides, as plain matrix products.

Port of ``tramba_tpu/ops/dct.py:59-74`` ``dct2d_quadrants``.  JAX computes
it outside any Pallas kernel, so it stays ``torch.matmul`` here.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["dct_basis", "dct2d_quadrants"]


@functools.lru_cache(maxsize=None)
def _basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: B[v, j] = cos(pi*(0.5+j)*v/n)/sqrt(n) (*sqrt2, v>0)."""
    j = np.arange(n)[None, :]
    v = np.arange(n)[:, None]
    b = np.cos(np.pi * (0.5 + j) * v / n) / np.sqrt(n)
    b[1:] *= np.sqrt(2.0)
    return b.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis_on(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_basis_np(n)).to(device)


def dct_basis(n: int, device) -> torch.Tensor:
    return _basis_on(n, str(torch.device(device)))


def dct2d_quadrants(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) quadrants of the orthonormal 2-D DCT-II of NHWC ``x``:
    low from the first halves of the basis rows, high from the last halves.
    Each is (B, H/2, W/2, C)."""
    B, H, W, C = x.shape
    bw = dct_basis(W, x.device).to(x.dtype)
    bh = dct_basis(H, x.device).to(x.dtype)
    ylo = torch.einsum("bhwc,vw->bhvc", x, bw[: W // 2])
    low = torch.einsum("bhvc,kh->bkvc", ylo, bh[: H // 2])
    yhi = torch.einsum("bhwc,vw->bhvc", x, bw[W // 2:])
    high = torch.einsum("bhvc,kh->bkvc", yhi, bh[H // 2:])
    return high, low
