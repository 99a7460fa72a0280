"""Optimizer + learning-rate schedules (``rangeclip_tpu/training/optim.py``).

Reference: train_util.py:493-544 — Adam(lr, weight_decay) with one of
  * MultiStepLR(milestones=learning_schedule, gamma=0.1) — note the
    reference quirk: the extra entries of ``learning_rates`` are NEVER used
    by this scheduler, only lr[0] * 0.1^k;
  * CosineAnnealingLR(T_max=last epoch, eta_min=learning_rates[-1]);
  * ReduceLROnPlateau(mode=min, factor=0.1, patience=5,
    min_lr=learning_rates[-1]).

The optimizer is ``torch.optim.Adam`` with its ``weight_decay``: L2 added to
the gradient (NOT AdamW), on every parameter (norm scales and the
log-temperatures included), eps outside the square root — the JAX chain
add_decayed_weights -> scale_by_adam -> scale(-1) with the learning rate
multiplied in by the train step.  The learning rate is set per step.

The frozen-encoder finetune (the JAX ``make_optimizer(freeze_encoder=True)``,
an ``optax.multi_transform`` with ``set_to_zero`` on the encoder) is Adam over
:func:`optimized_parameters`: the encoder's parameters are not the
optimizer's, so no step, weight decay included, touches them.

The schedules are copies of the JAX package's, pinned to them by a test.
All are stepped per EPOCH (train_util.py:409) and produce a plain float.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence

import torch
from torch import nn


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam(b1=0.9, b2=0.999, eps=1e-8) with torch-style L2 decay; the
    learning rate is set per step (:func:`set_learning_rate`)."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def optimized_parameters(model: nn.Module, freeze_encoder: bool = False
                         ) -> List[nn.Parameter]:
    """The parameters the optimizer updates: all of ``model``'s, or with
    ``freeze_encoder`` all but those under ``model.encoder``."""
    return [p for name, p in model.named_parameters()
            if not (freeze_encoder and name.startswith("encoder."))]


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class MultiStepSchedule:
    """lr = lr0 * gamma^{#milestones passed} (torch MultiStepLR)."""

    def __init__(self, lr0: float, milestones: Sequence[int], gamma: float = 0.1):
        self.lr0 = lr0
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def __call__(self, epoch: int) -> float:
        k = sum(1 for m in self.milestones if epoch >= m)
        return self.lr0 * (self.gamma**k)

    def step_metric(self, metric: float) -> None:  # uniform interface
        pass


class CosineAnnealingSchedule:
    """lr(e) = eta_min + (lr0 - eta_min) * (1 + cos(pi e / T_max)) / 2."""

    def __init__(self, lr0: float, t_max: int, eta_min: float = 0.0):
        self.lr0 = lr0
        self.t_max = t_max
        self.eta_min = eta_min

    def __call__(self, epoch: int) -> float:
        return self.eta_min + (self.lr0 - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)
        ) / 2

    def step_metric(self, metric: float) -> None:
        pass


class ReduceOnPlateauSchedule:
    """torch ReduceLROnPlateau(mode=min, factor, patience, min_lr).

    Call ``step_metric(val_loss)`` once per epoch, then ``__call__`` for the
    current lr.
    """

    def __init__(self, lr0: float, factor: float = 0.1, patience: int = 5,
                 min_lr: float = 0.0):
        self.lr = lr0
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def __call__(self, epoch: int) -> float:
        return self.lr

    def step_metric(self, metric: float) -> None:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0


def make_lr_schedule(
    scheduler_type: str,
    learning_rates: Sequence[float],
    learning_schedule: Sequence[int],
):
    if scheduler_type == "multi_step":
        return MultiStepSchedule(learning_rates[0], learning_schedule, gamma=0.1)
    elif scheduler_type == "cosine_annealing":
        return CosineAnnealingSchedule(
            learning_rates[0], learning_schedule[-1], eta_min=learning_rates[-1]
        )
    elif scheduler_type == "reduce_on_plateau":
        return ReduceOnPlateauSchedule(
            learning_rates[0], factor=0.1, patience=5, min_lr=learning_rates[-1]
        )
    else:
        raise ValueError(f"Unsupported scheduler type: {scheduler_type}")
