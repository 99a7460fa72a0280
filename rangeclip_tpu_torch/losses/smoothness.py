"""Total-variation smoothness regulariser (``rangeclip_tpu/losses/
smoothness.py``): the L1 distance between horizontally and vertically
adjacent pixel embeddings, mean-reduced, summed over the two directions."""

from __future__ import annotations

from typing import Optional

import torch

from rangeclip_tpu_torch.ops.kernels.tv_rowtile import (
    kernel_applicable,
    tv_plain,
)
from rangeclip_tpu_torch.parallel.kernel_shard import (
    global_sum,
    sharded_tv_rowtile,
)
from rangeclip_tpu_torch.parallel.mesh import world


def total_variation_loss(pixel_embeddings: torch.Tensor, upsample: int = 1,
                         sample_weight: Optional[torch.Tensor] = None,
                         group=None) -> torch.Tensor:
    """TV of [B, H, W, D] (NHWC), or with ``upsample=s`` the exact TV of its
    nearest xs upsample (each native difference appears s times per
    direction: mean_full = mean_native * (W - 1) / (s W - 1)).

    ``sample_weight``: optional [B] 0/1 weights; the value is
    TV(x * w) * B / sum(w), the exact TV of the valid sub-batch.

    Dispatch as in JAX: a CUDA field that passes ``kernel_applicable`` runs
    the ``tv_rowtile`` kernels (weights folded in per image); everything
    else the plain formulation with its hand-derived VJP (+1 at ties).

    ``group``: the field is this rank's row block of the global batch (the
    gate reads this local shape), and the value is this rank's share of
    the global batch's TV: its rows' TV over the number of ranks, times the
    global ``B / sum(w)``."""
    ranks = 1 if group is None else world(group)
    scale = None
    if sample_weight is not None:
        n = global_sum(sample_weight.float().sum(), group).clamp_min(1.0)
        scale = n.new_tensor(float(pixel_embeddings.shape[0] * ranks)) / n
    if (pixel_embeddings.device.type == "cuda"
            and kernel_applicable(tuple(pixel_embeddings.shape),
                                  pixel_embeddings.dtype)):
        loss = sharded_tv_rowtile(pixel_embeddings, sample_weight,
                                  int(upsample), group)
        return loss if scale is None else loss * scale
    if sample_weight is not None:
        w = sample_weight.to(pixel_embeddings.dtype)
        pixel_embeddings = pixel_embeddings * w[:, None, None, None]
    loss = tv_plain(pixel_embeddings, int(upsample))
    if group is not None:
        loss = loss / ranks
    return loss if scale is None else loss * scale
