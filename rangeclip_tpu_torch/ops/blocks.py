"""The blocks of the ResNet UNet (``rangeclip_tpu/ops/blocks.py``).

NCHW modules, run in ``channels_last``.  Module and parameter names follow
the reference's state-dict keys (``conv``, ``batch_norm``, ``projection``,
``upsample``), so reference checkpoints load with ``strict=True``.

Parameters stay float32.  A block computes in the dtype of its input: conv
weights are cast to it, and BatchNorm normalises in float32 and casts back,
as the JAX blocks do with a bf16 compute dtype.  In train mode BatchNorm
updates its running statistics as flax does (:class:`BatchNorm2d`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops.activations import (
    DEFAULT_ACTIVATION,
    resolve_activation,
)
from rangeclip_tpu_torch.ops.initializers import init_bias_, init_weight_
from rangeclip_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype (bias-free)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, conv.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running statistics follow flax's
    ``BatchNorm(momentum=0.9)`` (blocks.py:89-96): 0.9 * old + 0.1 * batch,
    with the BIASED batch variance in f32, where torch's module takes the
    unbiased one.  Normalisation (batch statistics in train mode, running
    ones in eval mode) is torch's own; ``num_batches_tracked`` counts as
    before."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        C = x.shape[1]
        n = x.numel() // C
        if n == 1:
            # one value per channel, which F.batch_norm refuses and flax
            # normalises to exactly the bias: x - mean is 0
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            shape = (1, -1, 1, 1)
            y = ((x - mean.reshape(shape))
                 * torch.rsqrt(var.reshape(shape) + self.eps)
                 * self.weight.reshape(shape) + self.bias.reshape(shape))
            var, mean = var.detach(), mean.detach()
        else:
            # momentum 1 into fresh buffers: the kernel hands back the
            # batch mean and the unbiased variance it normalised with, so
            # no second pass over x is needed for the statistics
            mean = torch.zeros(C, dtype=torch.float32, device=x.device)
            var = torch.zeros(C, dtype=torch.float32, device=x.device)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                             1.0, self.eps)
            var = var * ((n - 1) / n)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Module):
    """conv(pad=k//2, no bias) -> optional BatchNorm -> activation
    (blocks.py:108-147)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride,
                              padding=kernel_size // 2, bias=False,
                              device=device)
        init_weight_(self.conv.weight, weight_initializer, generator)
        # torch momentum 0.1 == flax momentum 0.9
        self.batch_norm = (BatchNorm2d(features, eps=1e-5, momentum=0.1,
                                       device=device)
                           if use_batch_norm else None)
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv, x)
        if self.batch_norm is not None:
            x = self.batch_norm(x.float()).to(x.dtype)
        return self.act(x) if self.act is not None else x


class ResNetBlock(nn.Module):
    """act(conv2(conv1(x)) + proj?(x)) (blocks.py:382-429).

    The reference instantiates the 1x1 ``projection`` in every block but
    applies it only when the stride or the channel count changes; the
    unused ones are kept so that its state dicts load strictly."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        self.conv1 = Conv2d(in_channels, features, 3, stride, **common)
        self.conv2 = Conv2d(features, features, 3, 1, **common)
        self.projection = Conv2d(in_channels, features, 1, stride,
                                 weight_initializer, activation=None,
                                 device=device, generator=generator)
        self.use_projection = stride != 1 or in_channels != features
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        out = out + (self.projection(x) if self.use_projection else x)
        return self.act(out) if self.act is not None else out


class ResNetBottleneckBlock(nn.Module):
    """act(conv3(conv2(conv1(x))) + proj?(x)), conv3 to 4 * features
    (blocks.py:432-478).  The projection applies when the stride or the
    channel count of the residual sum changes (the actual shapes, not
    conv2's).  An unused projection is kept, as in the basic block, at the
    [features, features] shape that the JAX package's reference export
    (``torch_interop.export_reference_checkpoint``) writes for it, so that
    its ``.pth`` files load strictly."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        out = self.expansion * features
        self.conv1 = Conv2d(in_channels, features, 1, 1, **common)
        self.conv2 = Conv2d(features, features, 3, stride, **common)
        self.conv3 = Conv2d(features, out, 1, 1, **common)
        self.use_projection = stride != 1 or in_channels != out
        proj = (in_channels, out) if self.use_projection else (features,
                                                               features)
        self.projection = Conv2d(*proj, 1, stride, weight_initializer,
                                 activation=None, device=device,
                                 generator=generator)
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        out = out + (self.projection(x) if self.use_projection else x)
        return self.act(out) if self.act is not None else out


class DecoderBlock(nn.Module):
    """ConvTranspose(k2, s2, bias) upsample -> bilinear resize to the skip
    if shapes differ -> concat -> two 3x3 convs (blocks.py:707-757)."""

    def __init__(self, in_channels: int, features: int,
                 skip_channels: int = 0,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(in_channels, features, 2, stride=2,
                                           bias=True, device=device)
        init_weight_(self.upsample.weight, weight_initializer, generator)
        init_bias_(self.upsample.bias, features * 4, generator)
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        self.conv1 = Conv2d(features + skip_channels, features, 3, 1,
                            **common)
        self.conv2 = Conv2d(features, features, 3, 1, **common)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.conv_transpose2d(x, self.upsample.weight.to(x.dtype),
                               self.upsample.bias.to(x.dtype), stride=2)
        if skip is not None:
            if x.shape[2:] != skip.shape[2:]:
                x = resize_bilinear_align_corners_nchw(x, skip.shape[2:])
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))
