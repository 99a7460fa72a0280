"""UNet depth decoder (``rangeclip_tpu/models/decoder.py``).

One DecoderBlock per decoder filter count; the first has no skip, later ones
concatenate the reversed encoder features without the deepest.  Then the
bias-free 3x3 ``output_conv`` to the embedding dim, with no activation and
no norm.  The blocks take BatchNorm, InstanceNorm (``use_instance_norm``)
or neither.
The final nearest upsample and L2 normalisation are per-pixel and live in
``DepthUNet``.  State-dict keys follow the reference: ``up_blocks.{i}``,
``output_conv``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from rangeclip_tpu_torch.ops.blocks import Conv2d, DecoderBlock


class DepthDecoder(nn.Module):
    def __init__(self, n_filters: Sequence[int] = (512, 256, 128, 64, 32),
                 skip_channels: Sequence[int] = (256, 128, 64, 32),
                 in_channels: int = 512, embedding_dim: int = 512,
                 weight_initializer: str = "kaiming_uniform",
                 activation: str = "relu", use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        if len(skip_channels) != len(n_filters) - 1:
            raise ValueError(
                f"Mismatch in number of skip features and decoder blocks: "
                f"{len(skip_channels)} vs {len(n_filters) - 1}")
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        self.up_blocks = nn.ModuleList()
        for i, n_filter in enumerate(n_filters):
            skip = skip_channels[i - 1] if i > 0 else 0
            self.up_blocks.append(
                DecoderBlock(in_channels, n_filter, skip, **common))
            in_channels = n_filter
        self.output_conv = Conv2d(n_filters[-1], embedding_dim, 3, 1,
                                  weight_initializer, activation=None,
                                  device=device, generator=generator)

    def forward(self, x: torch.Tensor, encoder_features: List[torch.Tensor],
                apply_head: bool = True) -> torch.Tensor:
        """x: the ASPP map.  Returns the raw output-conv field [B, D, H/2,
        W/2], or with ``apply_head=False`` the last block's features
        [B, n_filters[-1], H/2, W/2]."""
        skips = encoder_features[:-1][::-1]
        x = self.up_blocks[0](x)
        for block, skip in zip(self.up_blocks[1:], skips):
            x = block(x, skip)
        return self.output_conv(x) if apply_head else x
