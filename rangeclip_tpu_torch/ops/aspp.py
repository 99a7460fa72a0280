"""ASPP with GroupNorm, as used inside the depth encoder
(``rangeclip_tpu/ops/aspp.py``).

Branches with dilation 1 (a 1x1 conv) and 6/12/18 (3x3, padding = dilation),
each conv(bias=False) -> GroupNorm(32, eps 1e-5) -> ReLU; a global-average-
pool branch broadcast back to the map (a bilinear align_corners upsample of
a 1x1 map is a broadcast); concat -> 1x1 projection -> GN -> ReLU -> L2
normalisation over channels.  The ``nn.Sequential`` indices reproduce the
reference's state-dict keys: ``branches.{k}.{0,1}``, ``global_pool.{1,2}``
(index 0 is the pooling) and ``project.{0,1}``.

Inside ``ops/blocks.spatial_rows`` the map is this rank's rows: the
dilated branches fetch their halo (at H/32 it may span several ranks or
be all padding), GroupNorm's sums and the pooled mean run over every
rank's rows, and the pooled branch, the same on every rank, stays local.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops import blocks
from rangeclip_tpu_torch.ops.blocks import conv2d, spatial_mean
from rangeclip_tpu_torch.ops.initializers import init_weight_
from rangeclip_tpu_torch.utils.math import l2_normalize


def _conv_gn_relu(in_channels: int, features: int, kernel_size: int,
                  dilation: int, num_groups: int, device, generator):
    padding = dilation if kernel_size > 1 else 0
    conv = nn.Conv2d(in_channels, features, kernel_size, padding=padding,
                     dilation=dilation, bias=False, device=device)
    init_weight_(conv.weight, "kaiming_uniform", generator)
    return [conv, nn.GroupNorm(num_groups, features, eps=1e-5, device=device),
            nn.ReLU()]


def group_norm(y: torch.Tensor, gn: nn.GroupNorm,
               rows_sharded: bool = True) -> torch.Tensor:
    """flax's GroupNorm on NCHW f32: per group mean and E[x^2] - mean^2
    (clamped at 0), then (x - mean) * (rsqrt(var + eps) * scale) + bias.
    The order matters for groups of one value (a 1x1 map with one channel
    per group): x - mean is exactly 0 there and the output exactly the
    bias, where ``torch.group_norm``'s x * a + b leaves rounding noise
    that a later L2 normalisation blows up.  Inside ``blocks.spatial_rows``
    a ``rows_sharded`` map's sums of x and x^2 are taken over every rank's
    rows, over the global count, in the same order of operations."""
    N, C, H, W = y.shape
    g = y.reshape(N, gn.num_groups, C // gn.num_groups, H, W)
    shards = blocks._SPATIAL if rows_sharded else None
    if shards is None:
        mean = g.mean(dim=(2, 3, 4), keepdim=True)
        mean_sq = (g * g).mean(dim=(2, 3, 4), keepdim=True)
    else:
        count = C // gn.num_groups * shards.height(W) * W
        sums = shards.sum(torch.stack([g.sum(dim=(2, 3, 4), keepdim=True),
                                       (g * g).sum(dim=(2, 3, 4),
                                                   keepdim=True)]))
        mean, mean_sq = sums[0] / count, sums[1] / count
    var = (mean_sq - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + gn.eps) * gn.weight.reshape(
        1, gn.num_groups, C // gn.num_groups, 1, 1)
    out = (g - mean) * mul + gn.bias.reshape(1, gn.num_groups,
                                             C // gn.num_groups, 1, 1)
    return out.reshape(N, C, H, W)


def _apply(conv: nn.Conv2d, gn: nn.GroupNorm, x: torch.Tensor,
           rows_sharded: bool = True) -> torch.Tensor:
    """conv in ``x``'s dtype, GroupNorm in float32 (:func:`group_norm`),
    ReLU."""
    y = conv2d(conv, x)
    return F.relu(group_norm(y.float(), gn, rows_sharded).to(x.dtype))


class ASPP(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 dilation_rates: Sequence[int] = (1, 6, 12, 18),
                 num_groups: int = 32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*_conv_gn_relu(
                in_channels, features, 3 if rate > 1 else 1, rate,
                num_groups, device, generator))
            for rate in dilation_rates)
        self.global_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            *_conv_gn_relu(in_channels, features, 1, 1, num_groups, device,
                           generator))
        self.project = nn.Sequential(*_conv_gn_relu(
            (len(dilation_rates) + 1) * features, features, 1, 1, num_groups,
            device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [_apply(branch[0], branch[1], x) for branch in self.branches]
        pooled = spatial_mean(x)[:, :, None, None]
        # a 1x1 map, the same on every spatial rank: its norm stays local
        pooled = _apply(self.global_pool[1], self.global_pool[2], pooled,
                        rows_sharded=False)
        outs.append(pooled.expand(-1, -1, *x.shape[2:]))
        out = _apply(self.project[0], self.project[1], torch.cat(outs, dim=1))
        return l2_normalize(out, dim=1)
