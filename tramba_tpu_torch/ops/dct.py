"""Orthonormal 2-D DCT-II of NHWC maps, as plain matrix products.

Port of ``tramba_tpu/ops/dct.py``: the full-map transform and its inverse
(``dct2d``, ``idct2d``), the DFVSS guides' quadrants (``dct2d_quadrants``,
and ``split_high_low`` of a full transform), and the JPEG-style per-block
transform and its inverse (``block_dct2d``, ``block_idct2d``).  JAX computes
them outside any Pallas kernel, so they stay ``torch.einsum`` here.  Each
runs on the input's device and in its dtype, the bf16 model's included
(``nn/freq.py:54-57``): the basis is cast to it.  Only ``dct2d_quadrants``
has a caller in the models.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["basis_np", "dct_basis", "dct2d", "idct2d", "dct2d_quadrants", "split_high_low",
           "block_dct2d", "block_idct2d"]


@functools.lru_cache(maxsize=None)
def basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: B[v, j] = cos(pi*(0.5+j)*v/n)/sqrt(n) (*sqrt2, v>0)."""
    j = np.arange(n)[None, :]
    v = np.arange(n)[:, None]
    b = np.cos(np.pi * (0.5 + j) * v / n) / np.sqrt(n)
    b[1:] *= np.sqrt(2.0)
    return b.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis_on(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(basis_np(n)).to(device)


def dct_basis(n: int, device) -> torch.Tensor:
    return _basis_on(n, str(torch.device(device)))


def _bases(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bases over x's H and W axes, on its device and in its dtype."""
    return (dct_basis(x.shape[1], x.device).to(x.dtype),
            dct_basis(x.shape[2], x.device).to(x.dtype))


def dct2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II of NHWC ``x`` over its H and W axes."""
    bh, bw = _bases(x)
    y = torch.einsum("bhwc,vw->bhvc", x, bw)
    return torch.einsum("bhvc,kh->bkvc", y, bh)


def idct2d(y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`dct2d` (the basis is orthonormal: its transpose)."""
    bh, bw = _bases(y)
    x = torch.einsum("bkvc,kh->bhvc", y, bh)
    return torch.einsum("bhvc,vw->bhwc", x, bw)


def dct2d_quadrants(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) quadrants of the orthonormal 2-D DCT-II of NHWC ``x``:
    low from the first halves of the basis rows, high from the last halves.
    Each is (B, H/2, W/2, C)."""
    H, W = x.shape[1:3]
    bh, bw = _bases(x)
    ylo = torch.einsum("bhwc,vw->bhvc", x, bw[: W // 2])
    low = torch.einsum("bhvc,kh->bkvc", ylo, bh[: H // 2])
    yhi = torch.einsum("bhwc,vw->bhvc", x, bw[W // 2:])
    high = torch.einsum("bhvc,kh->bkvc", yhi, bh[H // 2:])
    return high, low


def split_high_low(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) quadrants of NHWC DCT coefficients at half resolution:
    low the top-left (low spatial frequencies), high the bottom-right."""
    H, W = coeffs.shape[1:3]
    return coeffs[:, H // 2:, W // 2:], coeffs[:, : H // 2, : W // 2]


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    B, H, W, C = x.shape
    if H % block or W % block:
        raise ValueError(f"H and W ({H}, {W}) must be multiples of the block {block}")
    return x.reshape(B, H // block, block, W // block, block, C)


def block_dct2d(x: torch.Tensor, block: int = 8) -> torch.Tensor:
    """The 2-D DCT of each ``block`` x ``block`` tile of NHWC ``x`` (JPEG's),
    in place of the tile; H and W are multiples of ``block``."""
    b = dct_basis(block, x.device).to(x.dtype)
    y = torch.einsum("bipjqc,vq->bipjvc", _blocks(x, block), b)
    return torch.einsum("bipjvc,kp->bikjvc", y, b).reshape(x.shape)


def block_idct2d(y: torch.Tensor, block: int = 8) -> torch.Tensor:
    """The inverse of :func:`block_dct2d`."""
    b = dct_basis(block, y.device).to(y.dtype)
    x = torch.einsum("bikjvc,kp->bipjvc", _blocks(y, block), b)
    return torch.einsum("bipjvc,vq->bipjqc", x, b).reshape(y.shape)
