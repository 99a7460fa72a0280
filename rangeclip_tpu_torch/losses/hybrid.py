"""Hybrid loss: W_text * L_text + W_image * L_image + W_smooth * L_smooth
(``rangeclip_tpu/losses/hybrid.py``), in the native-resolution mode the
train step uses (``label_upsample=s``): the decoder's native field with
full-resolution labels, every term commuting exactly with the nearest xs
upsample.  The pixel sampling is the histogram of uniform draws in slot
order, as on the JAX package's kernel path (``pixel_sampler="auto"``), or
multinomial counts drawn by binomial splitting (``"multinomial"``, opt-in:
the same law, another realisation of it).

Over a process group or a grid (``group``: the global-batch step and
sharded validation) the field and labels are this rank's block of the
global batch (its images and, under a 'spatial' axis, their rows), the
draws are the global batch's (:class:`Draws`), and every term comes back
as this rank's share: the totals of the ranks holding pixels (the 'batch'
group) add up to the loss of the global batch (``losses/infonce.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from rangeclip_tpu_torch.losses.infonce import (
    area_image_infonce,
    build_contrast_mask,
    pixel_text_infonce,
    sample_pixel_multiplicities,
    sample_pixel_multiplicities_multinomial,
)
from rangeclip_tpu_torch.losses.smoothness import total_variation_loss
from rangeclip_tpu_torch.parallel.kernel_shard import global_sum


PIXEL_SAMPLERS = ("auto", "histogram", "multinomial")


@dataclasses.dataclass(frozen=True)
class HybridLossConfig:
    w_text: float = 1.0
    w_image: float = 0.5
    w_smooth: float = 2e2
    percent_image_sampling: float = 0.7
    k_distractors: int = 50
    # packed-contrast CE capacity (bf16 only); None disables packing
    contrast_capacity: Optional[int] = 128
    # opt-in: rescale the CE weights so every present class weighs the same
    class_balanced: bool = False
    # "auto" (== "histogram"): the histogram of uniform draws;
    # "multinomial": counts by binomial splitting (hybrid.py:36-49)
    pixel_sampler: str = "auto"

    def __post_init__(self):
        if self.pixel_sampler not in PIXEL_SAMPLERS:
            raise ValueError(f"pixel_sampler {self.pixel_sampler!r}, "
                             f"expected one of {PIXEL_SAMPLERS}")


@dataclasses.dataclass
class Draws:
    """The random inputs of one loss call (the JAX key's draws, injectable):
    ``pixels`` [B, n] draw indices in [0, H*W) of the histogram sampler,
    ``counts`` [B, H*W] of the multinomial one, ``gumbel`` (medium/hard,
    random) noise, each [C].  None fields are drawn from a generator.
    Under a process group ``pixels`` and ``counts`` hold the global
    batch's rows, of which each rank keeps its own."""

    pixels: Optional[torch.Tensor] = None
    gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    counts: Optional[torch.Tensor] = None


def class_balance(labels: torch.Tensor, valid: torch.Tensor,
                  num_classes: int, group=None) -> torch.Tensor:
    """Rescale ``valid`` so every present class carries equal total weight,
    sum preserved (hybrid.py:215-227).  Labels outside [0, C) get weight 0
    here, where JAX's gather fills them with NaN.  Under ``group`` the [C]
    counts are every rank's."""
    flat_l = labels.reshape(-1).long()
    flat_v = valid.reshape(-1).float()
    inside = (flat_l >= 0) & (flat_l < num_classes)
    safe = torch.where(inside, flat_l, 0)
    counts = torch.zeros(num_classes, dtype=torch.float32,
                         device=valid.device)
    counts.index_add_(0, safe, torch.where(inside, flat_v, 0.0))
    if group is not None:
        counts = global_sum(counts, group)
    present = counts > 0
    n_present = present.float().sum().clamp_min(1.0)
    mult = torch.where(present,
                       counts.sum() / (n_present * counts.clamp_min(1e-9)),
                       torch.zeros_like(counts))
    return (flat_v * torch.where(inside, mult[safe], 0.0)).reshape(
        valid.shape)


def compute_hybrid_loss(
    pixel_embeddings: torch.Tensor,
    target_indices: torch.Tensor,
    candidate_text_embeddings: torch.Tensor,
    medium_matrix: torch.Tensor,
    hard_matrix: torch.Tensor,
    temperature_text: torch.Tensor,
    temperature_image: torch.Tensor,
    pct_medium: float,
    pct_hard: float,
    area_embeddings: Optional[torch.Tensor] = None,
    image_embeddings: Optional[torch.Tensor] = None,
    area_valid: Optional[torch.Tensor] = None,
    sample_weight: Optional[torch.Tensor] = None,
    config: HybridLossConfig = HybridLossConfig(),
    label_upsample: int = 1,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full hybrid loss (hybrid.py:77-264).

    Args:
      pixel_embeddings: [B, h, w, D] normalised field (native resolution
        when ``label_upsample`` = s > 1).
      target_indices: [B, h*s, w*s] int labels.
      candidate_text_embeddings: [C, D] frozen text table (un-normalised).
      medium_matrix / hard_matrix: [C, C] bool similarity sets.
      pct_medium / pct_hard: curriculum fractions (host floats).
      area_embeddings / image_embeddings / area_valid: [B, D], [B, D], [B]
        for the area-image term (None disables it).
      sample_weight: optional [B] 0/1 mask of padded batch items.
      draws / generator: the random inputs (see :class:`Draws`).
      group: a process group of more than one rank, whose ranks hold equal
        blocks of the global batch's images, or a ``parallel/mesh.Grid``;
        the losses in the result are this rank's shares (the temperatures
        and weights are not).

    Returns (total, info dict of f32 scalars).
    """
    cfg = config
    num_classes = candidate_text_embeddings.shape[0]
    s = label_upsample
    B, h, w = pixel_embeddings.shape[:3]
    if tuple(target_indices.shape) != (B, h * s, w * s):
        raise ValueError(f"native field {tuple(pixel_embeddings.shape)} x{s} "
                         f"vs labels {tuple(target_indices.shape)}")
    draws = draws or Draws()
    zero = pixel_embeddings.new_zeros((), dtype=torch.float32)

    text_loss = zero
    if cfg.w_text > 0:
        if cfg.pixel_sampler == "multinomial":
            # one binomial call per tree level; nothing to hoist out of a
            # loop, which JAX does only for XLA's while_loop
            valid, labels = sample_pixel_multiplicities_multinomial(
                target_indices, cfg.percent_image_sampling, slots=s,
                counts=draws.counts, generator=generator, group=group)
        else:
            valid, labels = sample_pixel_multiplicities(
                target_indices, cfg.percent_image_sampling, slots=s,
                draws=draws.pixels, generator=generator, group=group)
        if sample_weight is not None:
            S, N = valid.shape
            valid = (valid.reshape(S, B, N // B)
                     * sample_weight.float()[None, :, None]).reshape(S, N)
        contrast_mask = build_contrast_mask(
            labels, valid, num_classes, medium_matrix, hard_matrix,
            cfg.k_distractors, pct_medium, pct_hard, draws.gumbel, generator,
            group)
        if cfg.class_balanced:
            valid = class_balance(labels, valid, num_classes, group)
        text_loss = pixel_text_infonce(
            pixel_embeddings, labels, valid,
            candidate_text_embeddings.to(pixel_embeddings.device),
            contrast_mask, temperature_text, cfg.contrast_capacity, group)

    image_loss = zero
    if (cfg.w_image > 0 and area_embeddings is not None
            and image_embeddings is not None):
        if area_valid is None:
            area_valid = torch.ones(area_embeddings.shape[0],
                                    device=area_embeddings.device)
        image_loss = area_image_infonce(area_embeddings, image_embeddings,
                                        area_valid, temperature_image, group)

    smooth_loss = zero
    if cfg.w_smooth > 0:
        smooth_loss = total_variation_loss(pixel_embeddings, upsample=s,
                                           sample_weight=sample_weight,
                                           group=group)

    total = (cfg.w_text * text_loss + cfg.w_image * image_loss
             + cfg.w_smooth * smooth_loss)
    const = lambda v: zero.new_tensor(v)  # noqa: E731
    info = {
        "total_loss": total,
        "text_contrastive_loss": text_loss,
        "image_contrastive_loss": image_loss,
        "smoothness_loss": smooth_loss,
        "temperature_text": temperature_text,
        "temperature_image": temperature_image,
        "W_text": const(cfg.w_text),
        "W_image": const(cfg.w_image),
        "W_smooth": const(cfg.w_smooth),
    }
    return total, info
