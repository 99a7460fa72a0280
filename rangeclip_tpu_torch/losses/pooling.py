"""Per-item masked average pooling (``rangeclip_tpu/losses/pooling.py``:
``per_item_masked_pooling``, what the train step calls).  No kernel: the
JAX function is a plain contraction.  ``masked_average_pooling`` and its
kernel are reached by no entry point yet (ROADMAP Queue 2)."""

from __future__ import annotations

import torch


def per_item_masked_pooling(pixel_embeddings: torch.Tensor,
                            segmentation_map: torch.Tensor,
                            labels: torch.Tensor,
                            upsample: int = 1) -> torch.Tensor:
    """Item b's area embedding averages its pixels where
    ``segmentation[b] == labels[b]``.

    Args:
      pixel_embeddings: [B, H, W, D].
      segmentation_map: [B, H, W], or [B, s*H, s*W] with ``upsample=s``:
        pooling the nearest xs upsampled field over the full-res mask equals
        pooling the native field weighted by each pixel's child count.
      labels: [B] int.

    Returns [B, D] f32; zero rows where the label covers no pixel."""
    mask = (segmentation_map == labels[:, None, None]).float()
    if upsample > 1:
        B, Hs, Ws = mask.shape
        mask = mask.reshape(B, Hs // upsample, upsample, Ws // upsample,
                            upsample).sum(dim=(2, 4))
    sums = torch.einsum("bhw,bhwd->bd", mask, pixel_embeddings.float())
    counts = mask.sum(dim=(1, 2))[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1.0),
                       torch.zeros_like(sums))
