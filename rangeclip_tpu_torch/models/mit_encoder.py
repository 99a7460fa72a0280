"""SegFormer-style hierarchical transformer depth encoder, MiT
(``rangeclip_tpu/models/mit_encoder.py``), with the ResNet encoder's
contract: (global embedding, the stage features, the ASPP map), the
features NCHW.

Four stages, each an overlapped patch embedding (a 7x7 stride-4 conv, then
3x3 stride-2 ones) and LayerNorm, MiT blocks, and a LayerNorm; stage s
gives the feature at H / 2^(s+2).  A block is pre-LN efficient attention
(K and V from a map shrunk by a strided ``sr`` conv and ``sr_norm`` where
the stage's reduction ratio is above 1) and a pre-LN Mix-FFN (dense, 3x3
depthwise conv, tanh-approximated GELU as ``jax.nn.gelu``'s default,
dense).  Every LayerNorm has eps 1e-6.  Then a global-pool MLP projection
head (L2-normalised) and ASPP on the last stage.

Inside a stage the tokens stay NHWC, so dense layers and LayerNorms act on
the last axis; the convolutions see the NCHW view.

Under a grid's 'spatial' axis (inside ``ops/blocks.spatial_rows``; JAX's
GSPMD partitions the same flax module when its mesh shards H) each rank
holds its rows of every stage.  The patch embeddings, the Mix-FFN's
depthwise conv and ``sr`` run through the entered ``parallel/halo.
RowShards`` (their halo rows from the neighbours); LayerNorms and dense
layers act per token.  Attention keeps its queries local and gathers the
map K and V are made from (after ``sr`` and ``sr_norm``, or the block's
normed input where the ratio is 1) whole, in global row order, once a
block (``RowShards.whole``: its backward returns each row's gradient to
its owner), then applies ``k`` and ``v`` to every token.  The global pool
sums over the spatial ranks.  State-dict names follow
this module tree (``patch_embed.{s}``, ``blocks.{s}.{i}``, ``norm.{s}``,
``projection_head.{0,2}``, ``aspp``); the reference ``.pth`` layout has no
MiT, and ``models/interop.state_dict_from_jax`` carries the JAX names here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops import blocks as block_lib
from rangeclip_tpu_torch.ops.aspp import ASPP
from rangeclip_tpu_torch.ops.transformer import (
    attention,
    init_lecun_,
    layer_norm,
    linear,
)
from rangeclip_tpu_torch.utils.math import l2_normalize

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)  # MiT-B0
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    layer_norm_eps: float = EPS


def _fit_heads(dim: int, heads: int) -> int:
    """Largest head count <= ``heads`` that divides ``dim``."""
    h = min(heads, dim)
    while dim % h != 0:
        h -= 1
    return h


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (with its bias) on NHWC ``x`` in ``x``'s dtype -> NHWC (on
    this rank's rows inside ``blocks.spatial_rows``)."""
    x = x.permute(0, 3, 1, 2)
    weight, bias = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    shards = block_lib._SPATIAL
    if shards is not None:
        y = shards.conv2d(x, weight, bias, conv.stride, conv.padding,
                          conv.dilation, conv.groups)
    else:
        y = F.conv2d(x, weight, bias, conv.stride, conv.padding,
                     groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def whole_map(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` itself, or inside ``blocks.spatial_rows`` every rank's
    rows of its map in global order (``RowShards.whole``)."""
    shards = block_lib._SPATIAL
    if shards is None:
        return x
    return shards.whole(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int,
                 stride: int, device: Optional[torch.device] = None):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride,
                              padding=patch_size // 2, device=device)
        self.norm = nn.LayerNorm(dim, eps=EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.norm, conv_nhwc(self.proj, x))


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.heads = heads
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, nn.Linear(dim, dim, device=device))
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio, device=device)
            self.sr_norm = nn.LayerNorm(dim, eps=EPS, device=device)
        else:
            self.sr = self.sr_norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        Dh = C // self.heads
        q = linear(self.q, x).reshape(B, H * W, self.heads, Dh)
        kv = x
        if self.sr is not None:
            kv = layer_norm(self.sr_norm, conv_nhwc(self.sr, x))
        kv = whole_map(kv)  # K and V over every token of the image
        n_kv = kv.shape[1] * kv.shape[2]
        k = linear(self.k, kv).reshape(B, n_kv, self.heads, Dh)
        v = linear(self.v, kv).reshape(B, n_kv, self.heads, Dh)
        out = attention(q, k, v).reshape(B, H, W, C)
        return linear(self.proj, out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        hidden = dim * mlp_ratio
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                                device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.dwconv, linear(self.fc1, x))
        return linear(self.fc2, F.gelu(h, approximate="tanh"))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS, device=device)
        self.attn = EfficientAttention(dim, heads, sr_ratio, device)
        self.norm2 = nn.LayerNorm(dim, eps=EPS, device=device)
        self.ffn = MixFFN(dim, mlp_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x))
        return x + self.ffn(layer_norm(self.norm2, x))


class MiTDepthEncoder(nn.Module):
    """4-stage MiT encoder with the ``DepthEncoder`` return contract."""

    def __init__(self, config: MiTConfig = MiTConfig(),
                 embedding_dim: int = 512, input_channels: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = tuple(config.embed_dims)
        self.feature_channels = dims
        self.patch_embed = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self.norm = nn.ModuleList()
        in_ch = input_channels
        for s, dim in enumerate(dims):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            self.patch_embed.append(
                OverlapPatchEmbed(in_ch, dim, patch, stride, device))
            heads = _fit_heads(dim, config.num_heads[s])
            self.blocks.append(nn.ModuleList(
                MiTBlock(dim, heads, config.sr_ratios[s], config.mlp_ratio,
                         device) for _ in range(config.depths[s])))
            self.norm.append(nn.LayerNorm(dim, eps=EPS, device=device))
            in_ch = dim
        self.projection_head = nn.Sequential(
            nn.Linear(dims[-1], dims[-1], device=device), nn.ReLU(),
            nn.Linear(dims[-1], embedding_dim, device=device))
        if generator is not None:
            init_lecun_(self, generator)
        self.aspp = ASPP(dims[-1], embedding_dim, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
        """x: [B, C_in, H, W].  Returns (embedding [B, D], the stage
        features [H/4, H/8, H/16, H/32] NCHW, ASPP map @H/32); this rank's
        rows of each inside ``blocks.spatial_rows``."""
        x = x.permute(0, 2, 3, 1)
        features = []
        for embed, blocks, norm in zip(self.patch_embed, self.blocks,
                                       self.norm):
            x = embed(x)
            for block in blocks:
                x = block(x)
            x = layer_norm(norm, x)
            features.append(x.permute(0, 3, 1, 2))
        h = block_lib.spatial_mean(x.permute(0, 3, 1, 2))
        h = linear(self.projection_head[2],
                   F.relu(linear(self.projection_head[0], h)))
        return l2_normalize(h, dim=-1), features, self.aspp(features[-1])
