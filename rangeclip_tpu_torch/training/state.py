"""Train state (``rangeclip_tpu/training/state.py``): the model (its
parameters, the learnable log-temperatures and the BatchNorm running
statistics), the optimizer and the step counter.  Where JAX carries an
immutable pytree through a jitted step, the port updates the model and the
optimizer in place."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.training.optim import (
    make_optimizer,
    optimized_parameters,
)


@dataclasses.dataclass
class TrainState:
    model: DepthUNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(config: DepthUNetConfig, device: torch.device,
                       weight_decay: float = 0.0, seed: int = 0,
                       model: Optional[DepthUNet] = None) -> TrainState:
    """A model with random weights from ``seed`` (or ``model``), in train
    mode on ``device``, and a fresh Adam over its parameters (without the
    encoder's when its config freezes the encoder)."""
    if model is None:
        model = DepthUNet(config, device=device,
                          generator=torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    params = optimized_parameters(model, model.config.freeze_encoder)
    return TrainState(model, make_optimizer(params, weight_decay))
