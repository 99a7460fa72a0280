"""ResNet depth encoder (``rangeclip_tpu/models/encoder.py``).

7x7 stride-2 conv, 3x3 stride-2 max-pool (pad 1), four groups of ResNet
blocks (groups 2-4 stride 2 on their first block): basic blocks for
ResNet-18 and 34, bottleneck blocks with 4x expansion for ResNet-50; a
global-pool MLP projection head giving an L2-normalised embedding, and ASPP
on the last feature map.  Every conv block takes BatchNorm, InstanceNorm
(``use_instance_norm``, JAX's ``DepthEncoder`` field) or neither; the ASPP
keeps its GroupNorm either way, as in JAX.  State-dict keys follow the
reference: ``conv1``, ``blocks.{g}.{b}`` (with ``conv3`` in a
bottleneck), ``projection_head.{0,2}``, ``aspp``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops.aspp import ASPP
from rangeclip_tpu_torch.ops.blocks import (
    Conv2d,
    ResNetBlock,
    ResNetBottleneckBlock,
    max_pool2d,
    spatial_mean,
)
from rangeclip_tpu_torch.ops.initializers import init_bias_, init_weight_
from rangeclip_tpu_torch.utils.math import l2_normalize

_BLOCKS = {18: ((2, 2, 2, 2), ResNetBlock, 1),
           34: ((3, 4, 6, 3), ResNetBlock, 1),
           50: ((3, 4, 6, 3), ResNetBottleneckBlock, 4)}


class DepthEncoder(nn.Module):
    def __init__(self, n_layer: int = 18,
                 n_filters: Sequence[int] = (32, 64, 128, 256, 512),
                 embedding_dim: int = 512, input_channels: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation: str = "relu", use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        if n_layer not in _BLOCKS:
            raise ValueError("Only supports 18, 34, 50 layer architecture")
        n_blocks, block_cls, expansion = _BLOCKS[n_layer]
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        self.conv1 = Conv2d(input_channels, n_filters[0], 7, 2, **common)
        self.blocks = nn.ModuleList()
        in_ch = n_filters[0]
        # the channels of the skip list that forward returns
        self.feature_channels = [in_ch]
        for g, (n_filter, n_block) in enumerate(zip(n_filters[1:],
                                                    n_blocks)):
            group = nn.ModuleList()
            for b in range(n_block):
                stride = 2 if (b == 0 and g > 0) else 1
                group.append(block_cls(in_ch, n_filter, stride, **common))
                in_ch = n_filter * expansion
            self.blocks.append(group)
            self.feature_channels.append(in_ch)
        final = in_ch
        self.projection_head = nn.Sequential(
            nn.Linear(final, final, device=device), nn.ReLU(),
            nn.Linear(final, embedding_dim, device=device))
        for linear in (self.projection_head[0], self.projection_head[2]):
            init_weight_(linear.weight, "kaiming_uniform", generator)
            init_bias_(linear.bias, final, generator)
        self.aspp = ASPP(final, embedding_dim, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
        """x: [B, C_in, H, W].  Returns (embedding [B, D], the skip list
        [conv1@H/2, g1@H/4, g2@H/8, g3@H/16, g4@H/32], ASPP map @H/32).
        Inside ``ops/blocks.spatial_rows`` ``x`` and the maps are this
        rank's rows and the embedding pools every rank's."""
        features = []
        x = self.conv1(x)
        features.append(x)
        x = max_pool2d(x, 3, 2, 1)
        for group in self.blocks:
            for block in group:
                x = block(x)
            features.append(x)
        fc1, fc2 = self.projection_head[0], self.projection_head[2]
        h = spatial_mean(x)
        h = F.relu(F.linear(h, fc1.weight.to(h.dtype), fc1.bias.to(h.dtype)))
        h = F.linear(h, fc2.weight.to(h.dtype), fc2.bias.to(h.dtype))
        return l2_normalize(h, dim=-1), features, self.aspp(x)
