"""CLIP text and vision towers, ViT-B/32 by default
(``rangeclip_tpu/models/clip/model.py``).

  Text tower: token + position embeddings -> pre-LN transformer layers
  (quick_gelu MLP, causal mask) -> final LayerNorm -> the hidden state at
  the highest token id (CLIP's end-of-text token) -> projection without
  bias.

  Vision tower: patch conv (no bias) on NHWC pixels + class token +
  position embeddings -> pre-LN -> transformer layers (no mask) -> LN on
  the class token -> projection without bias; with ``return_patches`` the
  patch tokens go through the same LN and projection instead, on the
  patch grid.

Submodule names are those of HF's ``CLIPTextTransformer`` /
``CLIPVisionTransformer`` (``embeddings``, ``encoder.layers.{i}.self_attn``,
``mlp.fc1``, ``pre_layrnorm`` in HF's spelling), so an HF CLIP state dict
loads with ``strict=True`` once its ``text_model.`` / ``vision_model.``
prefix is stripped (``convert.py``).

Numerics follow the JAX towers: attention scores and softmax in float32
with an additive -1e9 causal mask, probabilities cast back to the values'
dtype, both products accumulated in float32; LayerNorm eps 1e-5, computed
in float32.  ``CLIPConfig.dtype`` is the compute dtype (None: float32);
parameters stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops.transformer import (
    attention,
    init_lecun_,
    layer_norm,
    linear,
)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_heads: int = 12
    vision_layers: int = 12
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    dtype: Optional[torch.dtype] = None


CLIP_VIT_B32 = CLIPConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(width, width, device=device))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, W = x.shape
        split = (B, L, self.heads, W // self.heads)
        q = linear(self.q_proj, x).reshape(split)
        k = linear(self.k_proj, x).reshape(split)
        v = linear(self.v_proj, x).reshape(split)
        out = attention(q, k, v, mask).reshape(B, L, W)
        return linear(self.out_proj, out)


class MLP(nn.Module):
    def __init__(self, width: int, device: Optional[torch.device] = None):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width, device=device)
        self.fc2 = nn.Linear(4 * width, width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, quick_gelu(linear(self.fc1, x)))


class TransformerLayer(nn.Module):
    def __init__(self, width: int, heads: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=eps, device=device)
        self.self_attn = MultiHeadAttention(width, heads, device)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps, device=device)
        self.mlp = MLP(width, device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(self.layer_norm1, x), mask)
        return x + self.mlp(layer_norm(self.layer_norm2, x))


class Encoder(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, eps: float,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(width, heads, eps, device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TextEmbeddings(nn.Module):
    def __init__(self, config: CLIPConfig,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.text_width, device=device)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.text_width, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        return (self.token_embedding.weight[input_ids.long()]
                + self.position_embedding.weight[None, :L])


class CLIPTextTower(nn.Module):
    def __init__(self, config: CLIPConfig = CLIP_VIT_B32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embeddings = TextEmbeddings(config, device)
        self.encoder = Encoder(config.text_width, config.text_heads,
                               config.text_layers, config.layer_norm_eps,
                               device)
        self.final_layer_norm = nn.LayerNorm(
            config.text_width, eps=config.layer_norm_eps, device=device)
        self.text_projection = nn.Linear(config.text_width,
                                         config.projection_dim, bias=False,
                                         device=device)
        if generator is not None:
            init_lecun_(self, generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] int -> text features [B, projection_dim]."""
        B, L = input_ids.shape
        dtype = self.config.dtype or torch.float32
        x = self.embeddings(input_ids).to(dtype)
        causal = torch.full((L, L), -1e9, dtype=torch.float32,
                            device=x.device).triu(1)
        x = self.encoder(x, causal)
        x = layer_norm(self.final_layer_norm, x)
        # the hidden state at the end-of-text token, CLIP's highest id
        pooled = x[torch.arange(B, device=x.device), input_ids.argmax(-1)]
        return linear(self.text_projection, pooled)


class VisionEmbeddings(nn.Module):
    def __init__(self, config: CLIPConfig,
                 device: Optional[torch.device] = None):
        super().__init__()
        W, P = config.vision_width, config.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(W, device=device))
        self.patch_embedding = nn.Conv2d(3, W, P, stride=P, bias=False,
                                         device=device)
        n_pos = (config.image_size // P) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, W, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> tokens [B, 1 + n_patches, width]."""
        x = pixel_values.permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embedding.weight.to(x.dtype),
                     stride=self.patch_embedding.stride)
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = self.position_embedding.weight
        if x.shape[1] != pos.shape[0]:
            raise ValueError(
                f"{x.shape[1]} tokens ({tuple(pixel_values.shape[1:3])} "
                f"pixels) against a position table of {pos.shape[0]}")
        return x + pos.to(x.dtype)[None]


class CLIPVisionTower(nn.Module):
    def __init__(self, config: CLIPConfig = CLIP_VIT_B32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        eps = config.layer_norm_eps
        self.embeddings = VisionEmbeddings(config, device)
        # HF's spelling, kept so that its state dicts load strictly
        self.pre_layrnorm = nn.LayerNorm(config.vision_width, eps=eps,
                                         device=device)
        self.encoder = Encoder(config.vision_width, config.vision_heads,
                               config.vision_layers, eps, device)
        self.post_layernorm = nn.LayerNorm(config.vision_width, eps=eps,
                                           device=device)
        self.visual_projection = nn.Linear(config.vision_width,
                                           config.projection_dim, bias=False,
                                           device=device)
        if generator is not None:
            init_lecun_(self, generator)

    def forward(self, pixel_values: torch.Tensor,
                return_patches: bool = False) -> torch.Tensor:
        """pixel_values [B, H, W, 3], CLIP-normalised -> image features
        [B, projection_dim]; with ``return_patches`` the projected patch
        tokens [B, H / patch, W / patch, projection_dim] (the MaskCLIP
        dense probe)."""
        dtype = self.config.dtype or torch.float32
        x = self.embeddings(pixel_values.to(dtype))
        x = self.encoder(layer_norm(self.pre_layrnorm, x))
        if return_patches:
            B, H, W, _ = pixel_values.shape
            P = self.config.patch_size
            patches = linear(self.visual_projection,
                             layer_norm(self.post_layernorm, x[:, 1:]))
            return patches.reshape(B, H // P, W // P, -1)
        return linear(self.visual_projection,
                      layer_norm(self.post_layernorm, x[:, 0]))
