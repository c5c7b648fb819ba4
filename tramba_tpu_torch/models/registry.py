"""Model registry: the reference method names (``get_model.py:2-31``).

Port of ``tramba_tpu/models/registry.py``.  Tramba-V, Tramba-S (Swin-B)
and Tramba-P (PVTv2-b4) are ported; Tramba-R and BaseUMamba raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tramba_tpu_torch.models.tramba import TrambaEnc, TrambaV
from tramba_tpu_torch.nn.init import init_weights

__all__ = ["build", "METHODS"]

METHODS = ("Tramba-V-TSOD", "Tramba-V-SOD", "Tramba-S-TSOD", "Tramba-S-SOD", "Tramba-P-TSOD",
           "Tramba-P-SOD")

_ENC_BY_LETTER = {"S": "swin", "P": "pvt"}

_NOT_PORTED = {
    "BaseUMamba-SOD": "ROADMAP.md Queue 1 item 9 (BaseUMamba)",
    **{f"Tramba-R-{t}": "ROADMAP.md Queue 1 item 10 (encoder variants: Tramba-R)"
       for t in ("TSOD", "SOD")},
}


def build(method: str, img_size: int = 384, *, device="cpu", seed: Optional[int] = 0,
          dtype: torch.dtype = torch.float32, **overrides) -> nn.Module:
    """Build ``method`` in eval mode on ``device``, computing in ``dtype``
    (``torch.float32``, or ``torch.bfloat16``: JAX ``build(...,
    dtype=jnp.bfloat16)``, the forward ``bench.py`` times).  Parameters are
    fp32 in both, so one state dict serves both.  The weights are drawn on
    the CPU from ``torch.Generator().manual_seed(seed)`` and then moved, so a
    seed gives the same weights on every device; ``seed=None`` leaves torch's
    default init (for a checkpoint to overwrite).  ``overrides`` cut the
    model down for tests: Tramba-V's dims, enc_depths, dec_depths; Tramba-S's
    and -P's enc_config (a dict over ``swin_b_384_config`` /
    ``pvt_v2_b4_config``) and dec_depths."""
    if method in _NOT_PORTED:
        raise NotImplementedError(f"{method} is not ported yet: {_NOT_PORTED[method]}")
    if method not in METHODS:
        raise ValueError(f"unknown method: {method!r}; known: {METHODS + tuple(_NOT_PORTED)}")
    if method.startswith("Tramba-V-"):
        model = TrambaV(img_size=img_size, dtype=dtype, **overrides)
    else:
        model = TrambaEnc(_ENC_BY_LETTER[method.split("-")[1]], img_size, dtype, **overrides)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
