"""NaN / Inf guards (the reference's ``check_nan_inf``, csms6s.py:763-768).

Port of ``tramba_tpu/utils/debug.py``, on tensors of any device.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

__all__ = ["check_nan_inf", "tree_check_finite"]


def check_nan_inf(name: str, x: torch.Tensor, raise_on_bad: bool = True) -> torch.Tensor:
    """Prints (and, with ``raise_on_bad``, raises FloatingPointError) when
    ``x`` holds NaN or Inf; returns ``x``.  Reads the tensor back to the host,
    so it waits for the card."""
    bad = int((~torch.isfinite(x)).sum().item())
    if bad:
        msg = f"{name}: {bad} non-finite values (shape {tuple(x.shape)})"
        print(msg)
        if raise_on_bad:
            raise FloatingPointError(msg)
    return x


def tree_check_finite(tree: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                      prefix: str = "params") -> bool:
    """True when every tensor of ``tree`` (a module's state dict, or a
    mapping of names to tensors) is finite; prints each one that is not."""
    items = tree.state_dict() if isinstance(tree, torch.nn.Module) else tree
    clean = True
    for name, t in items.items():
        if torch.is_tensor(t) and t.is_floating_point() and not torch.isfinite(t).all().item():
            print(f"{prefix}.{name}: non-finite values")
            clean = False
    return clean
