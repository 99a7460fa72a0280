"""Layers of the transformer encoders (the CLIP towers, the MiT encoder)
in a compute dtype: dense and LayerNorm applied in the input's dtype with
float32 parameters, and attention as the JAX modules' two batched products
(``rangeclip_tpu/models/clip/model.py:72-79``,
``rangeclip_tpu/models/mit_encoder.py:95-100``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` computed in float32, returned in ``x``'s dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] -> [B, Lq, H, Dh] in q's
    dtype: float32 scores scaled by 1/sqrt(Dh), an additive float32
    ``mask``, softmax in float32, the probabilities cast to v's dtype, and
    float32 accumulation of the second product."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def init_lecun_(module: nn.Module, generator: torch.Generator,
                embedding_std: float = 0.02) -> None:
    """Seeded random weights, drawn on the CPU and copied to each
    parameter's device: LayerNorms 1 and 0, biases 0, embeddings and 1-D
    parameters N(0, embedding_std), other weights N(0, 1/fan_in) (flax's
    lecun_normal scale; a grouped conv's fan_in is its group's)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.is_meta:  # no storage to fill
                continue
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            else:
                std = (embedding_std
                       if p.dim() == 1 or isinstance(owner, nn.Embedding)
                       else 1.0 / math.sqrt(math.prod(p.shape[1:])))
                p.copy_(torch.empty(p.shape).normal_(0.0, std,
                                                     generator=generator))
