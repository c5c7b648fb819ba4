"""Model registry: the reference method names (``get_model.py:2-31``).

Port of ``tramba_tpu/models/registry.py``.  Tramba-V, Tramba-S (Swin-B),
Tramba-P (PVTv2-b4) and Tramba-R (ResNet-50) are ported; BaseUMamba raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tramba_tpu_torch.models.tramba import TrambaEnc, TrambaV
from tramba_tpu_torch.nn.init import init_weights

__all__ = ["build", "METHODS"]

METHODS = ("Tramba-V-TSOD", "Tramba-V-SOD", "Tramba-S-TSOD", "Tramba-S-SOD", "Tramba-P-TSOD",
           "Tramba-P-SOD", "Tramba-R-TSOD", "Tramba-R-SOD")

_ENC_BY_LETTER = {"S": "swin", "P": "pvt", "R": "resnet"}

_NOT_PORTED = {"BaseUMamba-SOD": "ROADMAP.md Queue 1 item 9 (BaseUMamba)"}


def build(method: str, img_size: int = 384, *, device="cpu", seed: Optional[int] = 0,
          dtype: torch.dtype = torch.float32, ssm_backend: Optional[str] = None,
          **overrides) -> nn.Module:
    """Build ``method`` in eval mode on ``device``, computing in ``dtype``
    (``torch.float32``, or ``torch.bfloat16``: JAX ``build(...,
    dtype=jnp.bfloat16)``, the forward ``bench.py`` times).  Parameters are
    fp32 in both, so one state dict serves both.  The weights are drawn on
    the CPU from ``torch.Generator().manual_seed(seed)`` and then moved, so a
    seed gives the same weights on every device; ``seed=None`` leaves torch's
    default init (for a checkpoint to overwrite).  ``ssm_backend`` goes to
    every SS2D (JAX ``build(..., ssm_backend=...)``; ``nn/ssm.BACKENDS``);
    the parameters do not depend on it.  ``overrides`` cut the
    model down for tests: Tramba-V's dims, enc_depths, dec_depths; Tramba-S's,
    -P's and -R's enc_config (a dict over ``swin_b_384_config`` /
    ``pvt_v2_b4_config`` / ``resnet50_config``), dec_depths and
    dec_drop_path."""
    if method in _NOT_PORTED:
        raise NotImplementedError(f"{method} is not ported yet: {_NOT_PORTED[method]}")
    if method not in METHODS:
        raise ValueError(f"unknown method: {method!r}; known: {METHODS + tuple(_NOT_PORTED)}")
    if method.startswith("Tramba-V-"):
        model = TrambaV(img_size=img_size, dtype=dtype, ssm_backend=ssm_backend, **overrides)
    else:
        model = TrambaEnc(_ENC_BY_LETTER[method.split("-")[1]], img_size, dtype,
                          ssm_backend=ssm_backend, **overrides)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
