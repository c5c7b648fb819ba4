"""JPEG-style frequency features of an image (the reference's alternative
data path, ``data/dct.py`` + ``data/freq_dataloader.py``).

The port's own copy of ``tramba_tpu/data/freq.py`` (numpy only), on the
port's DCT basis (``ops/dct.py``): YCbCr conversion, an 8x8 block DCT giving
192 coefficient channels at 1/8 resolution, split into high and low
96-channel halves (each plane's last and first 32 coefficients), normalized
by per-channel statistics and then divided by 7.  ``FreqStats`` files are a
pickled dict of four fp32 arrays, so either package reads the other's.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np

from tramba_tpu_torch.ops.dct import basis_np

__all__ = ["rgb_to_ycbcr", "block_dct_features", "freq_decompose", "FreqStats",
           "compute_freq_stats"]

_YCBCR = np.asarray(
    [[0.257, 0.564, 0.098], [-0.148, -0.291, 0.439], [0.439, -0.368, -0.071]], np.float32
)
_SHIFT = np.asarray([16.0, 128.0, 128.0], np.float32)
_KEYS = ("high_mean", "high_std", "low_mean", "low_std")


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB in [0, 255] -> YCbCr (data/dct.py:6-26 matrix)."""
    return rgb @ _YCBCR.T + _SHIFT


def block_dct_features(image: np.ndarray, block: int = 8) -> np.ndarray:
    """(H, W, 3) raw-pixel image -> (H/8, W/8, 192) DCT coefficient maps;
    channel 64 p + 8 u + v is plane p's coefficient (u, v) (data/dct.py:50-52)."""
    ycc = rgb_to_ycbcr(image.astype(np.float32))
    H, W, _ = ycc.shape
    b = basis_np(block)
    x = ycc.reshape(H // block, block, W // block, block, 3)
    y = np.einsum("ipjqc,vq->ipjvc", x, b)
    y = np.einsum("ipjvc,up->iujvc", y, b)
    y = y.transpose(0, 2, 4, 1, 3).reshape(H // block, W // block, 3 * block * block)
    return y.astype(np.float32)


def freq_decompose(freq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(..., 192) -> (high (..., 96), low (..., 96)), each plane's halves
    (freq_dataloader.py:76-83)."""
    planes = [freq[..., i * 64:(i + 1) * 64] for i in range(3)]
    high = np.concatenate([p[..., 32:] for p in planes], axis=-1)
    low = np.concatenate([p[..., :32] for p in planes], axis=-1)
    return high, low


class FreqStats:
    """Per-channel normalization statistics of the high and low halves."""

    def __init__(self, high_mean, high_std, low_mean, low_std):
        self.high_mean = np.asarray(high_mean, np.float32)
        self.high_std = np.asarray(high_std, np.float32)
        self.low_mean = np.asarray(low_mean, np.float32)
        self.low_std = np.asarray(low_std, np.float32)

    @classmethod
    def load(cls, path: str) -> "FreqStats":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(*(d[k] for k in _KEYS))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({k: getattr(self, k) for k in _KEYS}, f)

    def normalize(self, high: np.ndarray, low: np.ndarray, div: float = 7.0):
        h = (high - self.high_mean) / self.high_std / div
        l = (low - self.low_mean) / self.low_std / div
        return h.astype(np.float32), l.astype(np.float32)


def compute_freq_stats(images) -> FreqStats:
    """Per-channel mean and std of the high and low halves over raw images."""
    sums = None
    n = 0
    for img in images:
        high, low = freq_decompose(block_dct_features(np.asarray(img, np.float32)))
        hs, ls = high.reshape(-1, high.shape[-1]), low.reshape(-1, low.shape[-1])
        parts = (hs.sum(0), ls.sum(0), (hs ** 2).sum(0), (ls ** 2).sum(0))
        sums = parts if sums is None else tuple(s + p for s, p in zip(sums, parts))
        n += hs.shape[0]
    h_sum, l_sum, h_sq, l_sq = sums
    h_mean, l_mean = h_sum / n, l_sum / n
    h_std = np.sqrt(np.maximum(h_sq / n - h_mean ** 2, 1e-12))
    l_std = np.sqrt(np.maximum(l_sq / n - l_mean ** 2, 1e-12))
    return FreqStats(h_mean, h_std, l_mean, l_std)
