"""Weight initializers with torch's fan conventions
(``rangeclip_tpu/ops/initializers.py``).

fan_in and fan_out come from the torch weight layout: conv [out, in, kh, kw],
conv-transpose [in, out, kh, kw] (so fan_in = out * kh * kw), linear
[out, in].  "kaiming_uniform" is torch's default U(-1/sqrt(fan_in), ...);
biases use torch's default U(-1/sqrt(fan_in), ...), with the fan_in of
their layer's weight.  Values are drawn on the CPU from a
``torch.Generator`` and copied to the parameter's device, so one seed gives
the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

VALID = ("kaiming_uniform", "kaiming_normal", "xavier_normal",
         "xavier_uniform")


def fans(weight: torch.Tensor):
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _fill(param: torch.Tensor, draw) -> None:
    with torch.no_grad():
        param.copy_(draw(torch.empty(param.shape, dtype=torch.float32)))


def init_weight_(weight: torch.Tensor, name: str,
                 generator: Optional[torch.Generator] = None) -> None:
    fan_in, fan_out = fans(weight)
    if name == "kaiming_uniform":
        bound = 1.0 / math.sqrt(fan_in)
        _fill(weight, lambda t: t.uniform_(-bound, bound, generator=generator))
    elif name == "kaiming_normal":
        std = math.sqrt(2.0 / fan_in)
        _fill(weight, lambda t: t.normal_(0.0, std, generator=generator))
    elif name == "xavier_normal":
        std = math.sqrt(2.0 / (fan_in + fan_out))
        _fill(weight, lambda t: t.normal_(0.0, std, generator=generator))
    elif name == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        _fill(weight, lambda t: t.uniform_(-bound, bound, generator=generator))
    else:
        raise ValueError(f"Unsupported weight initializer: {name!r} "
                         f"(expected one of {VALID})")


def init_bias_(bias: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    _fill(bias, lambda t: t.uniform_(-bound, bound, generator=generator))
