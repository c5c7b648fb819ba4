"""Saliency-map dump (test_TSOD.py semantics) for the PyTorch model.

Port of ``tramba_tpu/eval/dump.py:29-61``: run the model over a test split,
bilinear-resize the full-resolution logits back to each image's original
size, apply the sigmoid, save uint8 PNGs.  Data loading is the port's copy
of the JAX package's numpy-only pipeline (``data/pipeline.py``).
"""

from __future__ import annotations

import os
from typing import Sequence

import cv2
import numpy as np
import torch

from tramba_tpu_torch.data.pipeline import BatchLoader, SODDataset

__all__ = ["dump_saliency_maps"]


@torch.no_grad()
def dump_saliency_maps(model: torch.nn.Module, data_root: str, save_path: str,
                       img_size: int = 384, sets: Sequence[str] = ("Test",),
                       batch_size: int = 8, device="cpu") -> int:
    """Writes ``<save_path>/<name>.png`` for every image of ``sets`` under
    ``data_root`` ({set}/image + {set}/mask); returns the number written."""
    os.makedirs(save_path, exist_ok=True)
    ds = SODDataset(data_root, list(sets), img_size, mode="test")
    loader = BatchLoader(ds, batch_size=batch_size, shuffle=False)
    count = 0
    for batch in loader:
        images = torch.from_numpy(batch["image"]).to(device)
        logits = model(images)[-1][..., 0].float().cpu().numpy()
        for i, name in enumerate(batch["name"]):
            w, h = batch["shape"][i]  # PIL (W, H)
            up = cv2.resize(logits[i], (w, h), interpolation=cv2.INTER_LINEAR)
            pred = 1.0 / (1.0 + np.exp(-up))
            cv2.imwrite(os.path.join(save_path, name + ".png"), (pred * 255).astype(np.uint8))
            count += 1
    return count
