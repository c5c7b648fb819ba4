"""Optimizer policy: Adam with optax semantics, the encoder at 0.1x LR, step decay.

Port of ``tramba_tpu/train/optim.py``: ``optax.multi_transform`` of two
``optax.adam(schedule, mu_dtype=...)``, one for the parameters whose name
contains "encoder" (``vssm_encoder.*``) at ``lr * 0.1``, one for the rest
(reference ``train.py:266-280``).  ``torch.optim.Adam`` cannot keep its first
moment in bf16 (``run.py:71``'s default), so the step is written out, with
optax's order of operations: in fp32,

    mu   = (1 - b1) g + b1 mu        (b1 mu in mu's dtype, b1 rounded to it)
    nu   = (1 - b2) g^2 + b2 nu
    upd  = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
    p   += -lr(s) upd

where n counts Adam updates and s the schedule's own steps (both per group,
from 0), and mu is then stored in its dtype.  The update is elementwise over
the parameters, as XLA runs it for the JAX package: plain torch ops.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from tramba_tpu_torch.utils.profiling import span

__all__ = ["step_decay_schedule", "encoder_label", "Adam", "make_optimizer",
           "fast_forward_schedule"]


def step_decay_schedule(base_lr: float, decay_epochs: Sequence[int], decay_factors,
                        steps_per_epoch: int):
    """step -> fp32 lr = base * the factor of the last decay epoch passed
    (utils/lr.py:11-14: factors are absolute multipliers, not cumulative)."""
    if not hasattr(decay_factors, "__len__"):
        decay_factors = [decay_factors] * len(decay_epochs)
    if len(decay_epochs) != len(decay_factors):
        raise ValueError(f"{len(decay_epochs)} decay epochs but {len(decay_factors)} factors")
    pairs = sorted(zip([int(e) for e in decay_epochs], [float(f) for f in decay_factors]))

    def schedule(step: int) -> np.float32:
        epoch = step // steps_per_epoch
        factor = np.float32(1.0)
        for e, f in pairs:
            if epoch >= e:
                factor = np.float32(f)
        return np.float32(base_lr) * factor

    return schedule


def encoder_label(name: str) -> str:
    """'encoder' for a parameter whose name contains it, else 'rest'."""
    return "encoder" if "encoder" in name.lower() else "rest"


class Adam:
    """Adam over named parameter groups with optax's arithmetic (module doc).

    ``groups``: {label: (schedule, [(name, parameter), ...])}.  State per
    group: ``count`` (Adam updates) and ``sched_count`` (schedule steps);
    per parameter: ``mu`` (``mu_dtype``) and ``nu`` (fp32)."""

    def __init__(self, groups: Dict[str, Tuple[object, Sequence[Tuple[str, torch.Tensor]]]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32):
        self.groups = {k: (sched, list(named)) for k, (sched, named) in groups.items()}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype
        self.count = {k: 0 for k in self.groups}
        self.sched_count = {k: 0 for k in self.groups}
        self.mu, self.nu = {}, {}
        for _, named in self.groups.values():
            for name, p in named:
                self.mu[name] = torch.zeros_like(p, dtype=mu_dtype)
                self.nu[name] = torch.zeros_like(p, dtype=torch.float32)

    def lr(self, label: str) -> float:
        """The LR the group's next step applies."""
        return float(self.groups[label][0](self.sched_count[label]))

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient, as ``torch._foreach``
        ops over each group (no host sync: the LR and bias corrections are
        host scalars from the counters); the span ``optim.step``."""
        with span("optim.step"):
            b1, b2 = self.b1, self.b2
            for label, (sched, named) in self.groups.items():
                named = [(n, p) for n, p in named if p.grad is not None]
                n = self.count[label] + 1
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
                step_size = -float(sched(self.sched_count[label]))
                self.count[label] = n
                self.sched_count[label] += 1
                if not named:
                    continue
                params = [p for _, p in named]
                grads = [p.grad.float() for p in params]
                nus = [self.nu[name] for name, _ in named]
                # b1 mu in mu's dtype, b1 rounded to it first as JAX rounds a
                # weak Python scalar, then the sum in fp32 (optax's update_moment)
                b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
                mus = [m.float() for m in
                       torch._foreach_mul([self.mu[name] for name, _ in named], b1_mu)]
                torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
                torch._foreach_mul_(nus, b2)
                torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                            1 - b2))
                upd = torch._foreach_div(mus, bc1)
                den = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.eps)
                torch._foreach_div_(upd, den)
                torch._foreach_mul_(upd, step_size)
                torch._foreach_add_(params, upd)
                for (name, _), m in zip(named, mus):
                    self.mu[name] = m.to(self.mu_dtype)

    def zero_grad(self) -> None:
        for _, named in self.groups.values():
            for _, p in named:
                p.grad = None

    def state_dict(self) -> dict:
        return {"count": dict(self.count), "sched_count": dict(self.sched_count),
                "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        for key in ("count", "sched_count"):
            if set(state[key]) != set(self.groups):
                raise KeyError(f"optimizer state has groups {sorted(state[key])}, "
                               f"expected {sorted(self.groups)}")
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.mu):
                raise KeyError(f"optimizer state {key} does not name this model's parameters")
        self.count = dict(state["count"])
        self.sched_count = dict(state["sched_count"])
        for name in self.mu:
            self.mu[name] = state["mu"][name].to(self.mu[name].device, self.mu_dtype)
            self.nu[name] = state["nu"][name].to(self.nu[name].device, torch.float32)


def make_optimizer(named_params: Iterable[Tuple[str, torch.Tensor]], base_lr: float = 1e-4,
                   decay_epochs: Sequence[int] = (60,), decay_rate=0.2,
                   steps_per_epoch: int = 1, encoder_lr_scale: float = 0.1,
                   mu_dtype: torch.dtype = torch.float32) -> Adam:
    """The two-group Adam of ``tramba_tpu/train/optim.py:86-105``."""
    named = list(named_params)
    groups = {
        "encoder": (step_decay_schedule(base_lr * encoder_lr_scale, decay_epochs, decay_rate,
                                        steps_per_epoch),
                    [(n, p) for n, p in named if encoder_label(n) == "encoder"]),
        "rest": (step_decay_schedule(base_lr, decay_epochs, decay_rate, steps_per_epoch),
                 [(n, p) for n, p in named if encoder_label(n) == "rest"]),
    }
    return Adam(groups, mu_dtype=mu_dtype)


def fast_forward_schedule(opt: Adam, step: int) -> None:
    """Set every group's schedule counter to ``step`` for a weights-only
    resume, so the first resumed step trains at the LR of its epoch; Adam's
    own counter stays at 0 with the fresh moments
    (``tramba_tpu/train/optim.py:38-67``)."""
    for label in opt.sched_count:
        opt.sched_count[label] = int(step)
