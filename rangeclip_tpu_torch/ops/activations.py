"""Activation-function factory (``rangeclip_tpu/ops/activations.py``).

Same substring matching and branch order as the reference factory
('leaky_relu' is tested before 'relu'), with its leaky slope of 0.20; the
blocks' own default is leaky ReLU with slope 0.10.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]

DEFAULT_ACTIVATION = "leaky_relu_010"


def _leaky_relu_010(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.10)


def _leaky_relu_020(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.20)


def activation_func(name: str) -> Activation:
    if "linear" in name:
        return None
    elif "leaky_relu" in name:
        return _leaky_relu_020
    elif "relu" in name:
        return F.relu
    elif "elu" in name:
        return F.elu
    elif "sigmoid" in name:
        return torch.sigmoid
    else:
        raise ValueError(f"Unsupported activation function: {name}")


def resolve_activation(act) -> Activation:
    """A name, a callable or None -> a callable or None."""
    if act == DEFAULT_ACTIVATION:
        return _leaky_relu_010
    if act is None or callable(act):
        return act
    return activation_func(act)
