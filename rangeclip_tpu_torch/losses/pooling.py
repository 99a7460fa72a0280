"""Masked average pooling of pixel embeddings over segmentation masks
(``rangeclip_tpu/losses/pooling.py``): the batch-global
``masked_average_pooling`` (reference model.py:15-56), whose segment sums
run the ``masked_pooling`` kernel on CUDA tensors, and the per-item
``per_item_masked_pooling`` the train and val steps call (a plain
contraction, no kernel)."""

from __future__ import annotations

import torch

from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
    masked_pooling_plain,
)
from rangeclip_tpu_torch.parallel.kernel_shard import sharded_masked_pooling


def masked_average_pooling(pixel_embeddings: torch.Tensor,
                           segmentation_map: torch.Tensor,
                           object_indices: torch.Tensor,
                           use_pallas: str = "auto",
                           group=None) -> torch.Tensor:
    """For each object id, the mean of the pixel embeddings labelled with it
    across the whole batch.

    Args:
      pixel_embeddings: [B, H, W, D] (f32 or bf16; summed in f32).
      segmentation_map: [B, H, W] int.
      object_indices: [N] int (duplicates allowed).
      use_pallas: JAX's names.  'auto' and 'always' take the
        ``masked_pooling`` kernel for CUDA tensors and its plain version for
        CPU tensors; 'never' is the JAX package's XLA path, the dense
        [N, B*H*W] match product, on either device.
      group: a process group over whose ranks' rows (each rank's
        ``pixel_embeddings`` and ``segmentation_map`` its block of the
        global batch) the means are taken (JAX ``pooling.py:46-48``: the
        sums and counts all-reduced, ``parallel/kernel_shard.py``); the
        kernel route only.

    Returns [N, D] f32; zero rows for objects absent from the batch."""
    if use_pallas not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    if use_pallas == "never":
        if group is not None:
            raise ValueError("masked_average_pooling over a group takes "
                             "the kernel route, not use_pallas='never'")
        B, H, W, D = pixel_embeddings.shape
        sums, counts = masked_pooling_plain(
            pixel_embeddings.reshape(B * H * W, D),
            segmentation_map.reshape(B * H * W), object_indices)
    else:
        sums, counts = sharded_masked_pooling(
            pixel_embeddings, segmentation_map, object_indices, group)
    counts = counts[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1.0),
                       torch.zeros_like(sums))


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
