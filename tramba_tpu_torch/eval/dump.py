"""Saliency-map dump (test_TSOD.py semantics) and offline scoring of dumped
maps (Evaluation/evaluate_TSOD.py semantics) for the PyTorch model.

Port of ``tramba_tpu/eval/dump.py``.  Dump (:29-61): run the model over a
test split, bilinear-resize the full-resolution logits back to each image's
original size, apply the sigmoid, save uint8 PNGs.  Score (:64-90): read the
dumped maps beside their GT masks, stream the metric suite, save the PR
curves, format the results row; numpy only, no tensor.  Data loading and
the metrics are the port's copies of the JAX package's numpy-only modules
(``data/pipeline.py``, ``eval/metrics.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import cv2
import numpy as np
import torch
from PIL import Image

from tramba_tpu_torch.data.pipeline import BatchLoader, SODDataset, natural_sort
from tramba_tpu_torch.eval.metrics import SODMetrics
from tramba_tpu_torch.utils.profiling import span

__all__ = ["dump_saliency_maps", "model_device", "evaluate_maps", "format_results_row"]


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """``device`` where given, else the device of the model's first parameter
    (the CPU for a model without parameters)."""
    if device is not None:
        return torch.device(device)
    param = next(model.parameters(), None)
    return param.device if param is not None else torch.device("cpu")


@torch.no_grad()
def dump_saliency_maps(model: torch.nn.Module, data_root: str, save_path: str,
                       img_size: int = 384, sets: Sequence[str] = ("Test",),
                       batch_size: int = 8, device=None) -> int:
    """Writes ``<save_path>/<name>.png`` for every image of ``sets`` under
    ``data_root`` ({set}/image + {set}/mask); returns the number written.
    The images go to ``device``, by default the model's own
    (:func:`model_device`).  A batch is the spans ``dump.load`` (waiting on
    the loader), ``dump.copy_in``, the model's, ``dump.to_host`` and
    ``dump.write``."""
    device = model_device(model, device)
    os.makedirs(save_path, exist_ok=True)
    ds = SODDataset(data_root, list(sets), img_size, mode="test")
    loader = BatchLoader(ds, batch_size=batch_size, shuffle=False)
    count, batches = 0, iter(loader)
    while True:
        with span("dump.load"):
            batch = next(batches, None)
        if batch is None:
            return count
        with span("dump.copy_in"):
            images = torch.from_numpy(batch["image"]).to(device)
        head = model(images)[-1][..., 0]
        with span("dump.to_host"):
            logits = head.float().cpu().numpy()
        with span("dump.write"):
            for i, name in enumerate(batch["name"]):
                w, h = batch["shape"][i]  # PIL (W, H)
                up = cv2.resize(logits[i], (w, h), interpolation=cv2.INTER_LINEAR)
                pred = 1.0 / (1.0 + np.exp(-up))
                cv2.imwrite(os.path.join(save_path, name + ".png"),
                            (pred * 255).astype(np.uint8))
                count += 1


def evaluate_maps(salmap_root: str, gt_root: str, save_pr_dir: Optional[str] = None) -> dict:
    """Scores every map of ``salmap_root`` that has a GT mask of the same
    file name in ``gt_root`` (natural order), streaming :class:`SODMetrics`;
    returns its results and ``count``.  With ``save_pr_dir`` it also writes
    the PR curves there as ``precision.npy`` and ``recall.npy`` (fp32)."""
    sal_files = {f for f in os.listdir(salmap_root) if f.endswith((".jpg", ".png"))}
    gt_files = {f for f in os.listdir(gt_root) if f.endswith((".jpg", ".png"))}
    metrics = SODMetrics()
    for f in natural_sort(sorted(sal_files & gt_files)):
        sal = np.asarray(Image.open(os.path.join(salmap_root, f)).convert("L"), np.float32)
        gt = np.asarray(Image.open(os.path.join(gt_root, f)).convert("L"), np.float32)
        if gt.shape != sal.shape:
            raise ValueError(f"{f}: map {sal.shape} and mask {gt.shape} differ in size")
        metrics.step(sal / 255.0, gt / (gt.max() + 1e-8))
    results = metrics.results()
    results["count"] = metrics.count
    if save_pr_dir is not None:
        p, r = metrics.precision_recall_curves()
        np.save(os.path.join(save_pr_dir, "precision.npy"), p.astype(np.float32))
        np.save(os.path.join(save_pr_dir, "recall.npy"), r.astype(np.float32))
    return results


def format_results_row(model_name: str, dataset: str, r: dict) -> str:
    """The results row of evaluate_TSOD.py:104-113: adpFm, maxFm, meanFm,
    adpEm, maxEm, meanEm, Smeasure and MAE, each rounded to 4 places."""
    cols = [r["adpFm"], r["maxFm"], r["meanFm"], r["adpEm"], r["maxEm"], r["meanEm"],
            r["Smeasure"], r["MAE"]]
    return (f"model: {model_name} | dataset: {dataset} || "
            + " & ".join(str(round(c, 4)) for c in cols))
