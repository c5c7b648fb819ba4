"""Salient-object-detection metric suite (streaming, float64).

The port's own copy of ``tramba_tpu/eval/metrics.py`` (numpy and scipy only).

Implements the metric definitions the reference evaluates with
(``Evaluation/metrics.py``): MAE (per-image min-max-normalized prediction),
S-measure (Fan et al. 2017), E-measure (adaptive + 256-threshold curve,
Fan et al. 2018), F-measure with beta^2 = 0.3 (adaptive + curve) with FNR,
and the distance-weighted F-measure (Margolin et al. 2014).

All per-image scores are computed in one pass over a (pred, gt) pair and
averaged across the dataset in float64, matching the reference protocol
(per-image streaming then mean — BASELINE.md protocol notes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.ndimage import convolve, distance_transform_edt

_EPS = 1e-16


def _prepare(pred: np.ndarray, gt: np.ndarray):
    gt = gt.astype(bool)
    pred = pred.astype(np.float64)
    if pred.max() != pred.min():
        pred = (pred - pred.min()) / (pred.max() - pred.min())
    return pred, gt


def _adaptive_threshold(pred: np.ndarray) -> float:
    return min(2.0 * pred.mean(), 1.0)


def _threshold_histograms(pred: np.ndarray, gt: np.ndarray):
    """Cumulative fg/bg pixel counts for thresholds 255..0 (256 bins)."""
    q = (pred * 255).astype(np.uint8)
    bins = np.linspace(0, 256, 257)
    fg, _ = np.histogram(q[gt], bins=bins)
    bg, _ = np.histogram(q[~gt], bins=bins)
    return np.cumsum(fg[::-1]), np.cumsum(bg[::-1])


def mae_score(pred: np.ndarray, gt: np.ndarray) -> float:
    pred, gt = _prepare(pred, gt)
    return float(np.mean(np.abs(pred - gt)))


def f_measures(pred: np.ndarray, gt: np.ndarray, beta: float = 0.3):
    """Returns (adaptive_f, f_curve[256], precision[256], recall[256])."""
    pred, gt = _prepare(pred, gt)
    thr = _adaptive_threshold(pred)
    binary = pred >= thr
    inter = np.count_nonzero(binary & gt)
    if inter == 0:
        adp = 0.0
    else:
        p = inter / np.count_nonzero(binary)
        r = inter / np.count_nonzero(gt)
        adp = (1 + beta) * p * r / (beta * p + r)

    tp, fp = _threshold_histograms(pred, gt)
    ps = np.maximum(tp + fp, 1)
    total_fg = max(np.count_nonzero(gt), 1)
    precision = tp / ps
    recall = tp / total_fg
    num = (1 + beta) * precision * recall
    den = np.where(num == 0, 1.0, beta * precision + recall)
    return adp, num / den, precision, recall


def s_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    pred, gt = _prepare(pred, gt)
    y = gt.mean()
    if y == 0:
        return float(1 - pred.mean())
    if y == 1:
        return float(pred.mean())

    def s_object(p, mask):
        vals = p[mask]
        x, sx = vals.mean(), vals.std()
        return 2 * x / (x * x + 1 + sx + _EPS)

    obj = y * s_object(pred, gt) + (1 - y) * s_object(1 - pred, ~gt)

    # region: 4-quadrant SSIM around the GT centroid (1-indexed rounding)
    h, w = gt.shape
    if gt.sum() == 0:
        cx, cy = round(w / 2), round(h / 2)
    else:
        area = gt.sum()
        cx = round((gt.sum(axis=0) * np.arange(w)).sum() / area)
        cy = round((gt.sum(axis=1) * np.arange(h)).sum() / area)
    cx, cy = int(cx) + 1, int(cy) + 1

    def ssim(p, g):
        n = p.size
        x, yv = p.mean(), g.mean()
        sx = ((p - x) ** 2).sum() / (n - 1)
        sy = ((g - yv) ** 2).sum() / (n - 1)
        sxy = ((p - x) * (g - yv)).sum() / (n - 1)
        a = 4 * x * yv * sxy
        b = (x * x + yv * yv) * (sx + sy)
        if a != 0:
            return a / (b + _EPS)
        return 1.0 if b == 0 else 0.0

    gtf = gt.astype(np.float64)
    region = 0.0
    for (rs, cs, wgt) in (
        ((0, cy), (0, cx), cx * cy / (h * w)),
        ((0, cy), (cx, w), cy * (w - cx) / (h * w)),
        ((cy, h), (0, cx), (h - cy) * cx / (h * w)),
        ((cy, h), (cx, w), None),
    ):
        sl = (slice(*rs), slice(*cs))
        wgt = wgt if wgt is not None else 1 - (cx * cy + cy * (w - cx) + (h - cy) * cx) / (h * w)
        region += wgt * ssim(pred[sl], gtf[sl])
    return float(max(0.0, alpha * obj + (1 - alpha) * region))


def _em_from_counts(fg_fg, fg_bg, gt_fg, size):
    """Enhanced-alignment value from part counts (vectorized over thresholds)."""
    pred_fg = fg_fg + fg_bg
    pred_bg = size - pred_fg
    bg_fg = gt_fg - fg_fg
    bg_bg = pred_bg - bg_fg
    mean_pred = pred_fg / size
    mean_gt = gt_fg / size
    parts = (fg_fg, fg_bg, bg_fg, bg_bg)
    combos = (
        (1 - mean_pred, 1 - mean_gt),
        (1 - mean_pred, 0 - mean_gt),
        (0 - mean_pred, 1 - mean_gt),
        (0 - mean_pred, 0 - mean_gt),
    )
    total = 0.0
    for part, (dp, dg) in zip(parts, combos):
        align = 2 * dp * dg / (dp * dp + dg * dg + _EPS)
        total = total + ((align + 1) ** 2 / 4) * part
    return total / (size - 1 + _EPS)


def e_measures(pred: np.ndarray, gt: np.ndarray):
    """Returns (adaptive_e, e_curve[256])."""
    pred, gt = _prepare(pred, gt)
    gt_fg = np.count_nonzero(gt)
    size = gt.size

    thr = _adaptive_threshold(pred)
    binary = pred >= thr
    fg_fg = np.count_nonzero(binary & gt)
    fg_bg = np.count_nonzero(binary & ~gt)
    if gt_fg == 0:
        adp = (size - fg_fg - fg_bg) / (size - 1 + _EPS)
    elif gt_fg == size:
        adp = (fg_fg + fg_bg) / (size - 1 + _EPS)
    else:
        adp = _em_from_counts(float(fg_fg), float(fg_bg), gt_fg, size)

    tp, fp = _threshold_histograms(pred, gt)
    if gt_fg == 0:
        curve = (size - tp - fp) / (size - 1 + _EPS)
    elif gt_fg == size:
        curve = (tp + fp) / (size - 1 + _EPS)
    else:
        curve = _em_from_counts(tp.astype(np.float64), fp.astype(np.float64), gt_fg, size)
    return float(adp), curve


def weighted_f_measure(pred: np.ndarray, gt: np.ndarray, beta: float = 1.0) -> float:
    pred, gt = _prepare(pred, gt)
    if not gt.any():
        return 0.0
    dst, idx = distance_transform_edt(~gt, return_indices=True)
    err = np.abs(pred - gt)
    err_t = err.copy()
    bg = ~gt
    err_t[bg] = err_t[idx[0][bg], idx[1][bg]]

    # MATLAB fspecial('gaussian', 7, 5)
    y, x = np.ogrid[-3 : 4, -3 : 4]
    k = np.exp(-(x * x + y * y) / 50.0)
    k[k < np.finfo(k.dtype).eps * k.max()] = 0
    k /= k.sum()
    ea = convolve(err_t, k, mode="constant", cval=0)
    min_e_ea = np.where(gt & (ea < err), ea, err)
    weight = np.where(~gt, 2 - np.exp(np.log(0.5) / 5 * dst), 1.0)
    ew = min_e_ea * weight
    tpw = gt.sum() - ew[gt].sum()
    fpw = ew[~gt].sum()
    r = 1 - ew[gt].mean()
    p = tpw / (tpw + fpw + _EPS)
    return float((1 + beta) * r * p / (r + beta * p + _EPS))


class SODMetrics:
    """Streaming aggregator over a dataset; mirrors evaluate_TSOD.py outputs."""

    def __init__(self):
        self._mae = []
        self._sm = []
        self._wfm = []
        self._adp_f = []
        self._f_curves = []
        self._p_curves = []
        self._r_curves = []
        self._adp_e = []
        self._e_curves = []

    @staticmethod
    def compute_one(pred: np.ndarray, gt: np.ndarray) -> tuple:
        """Pure per-image metric bundle — safe to run on worker threads
        (numpy/scipy release the GIL); feed the result to :meth:`append`."""
        adp_f, f_curve, p, r = f_measures(pred, gt)
        adp_e, e_curve = e_measures(pred, gt)
        return (mae_score(pred, gt), s_measure(pred, gt),
                weighted_f_measure(pred, gt), adp_f, f_curve, p, r, adp_e, e_curve)

    def append(self, bundle: tuple):
        (mae, sm, wfm, adp_f, f_curve, p, r, adp_e, e_curve) = bundle
        self._mae.append(mae)
        self._sm.append(sm)
        self._wfm.append(wfm)
        self._adp_f.append(adp_f)
        self._f_curves.append(f_curve)
        self._p_curves.append(p)
        self._r_curves.append(r)
        self._adp_e.append(adp_e)
        self._e_curves.append(e_curve)

    def step(self, pred: np.ndarray, gt: np.ndarray):
        """pred: float saliency in [0, 1]; gt: binary mask (any numeric/bool)."""
        self.append(self.compute_one(pred, gt))

    @property
    def count(self) -> int:
        return len(self._mae)

    def precision_recall_curves(self):
        return (np.mean(self._p_curves, axis=0), np.mean(self._r_curves, axis=0))

    def results(self) -> Dict[str, float]:
        f_curve = np.mean(np.asarray(self._f_curves, np.float64), axis=0)
        e_curve = np.mean(np.asarray(self._e_curves, np.float64), axis=0)
        r_curve = np.mean(np.asarray(self._r_curves, np.float64), axis=0)
        return {
            "MAE": float(np.mean(self._mae)),
            "Smeasure": float(np.mean(self._sm)),
            "wFmeasure": float(np.mean(self._wfm)),
            "adpFm": float(np.mean(self._adp_f)),
            "meanFm": float(f_curve.mean()),
            "maxFm": float(f_curve.max()),
            "adpEm": float(np.mean(self._adp_e)),
            "meanEm": float(e_curve.mean()),
            "maxEm": float(e_curve.max()),
            "fnr": float(np.mean(1.0 - np.asarray(self._r_curves, np.float64))),
        }
