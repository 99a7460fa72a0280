"""InfoNCE losses (``rangeclip_tpu/losses/infonce.py``), in the form the JAX
package's kernel path takes: pixel multiplicities from a histogram of
uniform draws in slot order, the contrast set as a [C] mask with Gumbel
top-n distractors under dynamic thresholds, and the fused pixel-text CE
(packed when the live set fits).  Kernels run for CUDA tensors
(``histogram``, ``class_presence``, ``pixel_text_ce``), plain versions for
CPU tensors.

``jax.random`` cannot be reproduced in torch: every draw (pixel indices,
Gumbel noise) can be passed in, so tests feed both sides the same arrays;
without them the draws come from a ``torch.Generator``.  Not ported:
``sample_pixels`` (the multiplicity form replaces it) and the opt-in
multinomial sampler (a measured negative on the TPU).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.ops.kernels.class_presence import class_presence
from rangeclip_tpu_torch.ops.kernels.histogram import histogram
from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import fused_pixel_text_ce
from rangeclip_tpu_torch.utils.math import l2_normalize

NEG_INF = -1e30
LANES = 128  # the JAX package's capacity rounding (a TPU lane multiple)


def n_draws(height: int, width: int, percent: float = 0.7) -> int:
    """Draws per image: int(percent * H * W), clipped to [1, H * W]."""
    n_total = height * width
    return max(min(int(percent * n_total), n_total), 1)


def draw_pixels(batch: int, height: int, width: int, percent: float,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """[B, n] int32 uniform draws with replacement in [0, H * W)."""
    return torch.randint(0, height * width,
                         (batch, n_draws(height, width, percent)),
                         generator=generator, dtype=torch.int32,
                         device=device)


def sample_pixel_multiplicities(
    target: torch.Tensor,
    percent: float = 0.7,
    slots: int = 1,
    draws: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiplicity-weighted uniform pixel sampling (infonce.py:74-142).

    Args:
      target: [B, H, W] int labels.
      draws: [B, n] int draw indices in [0, H * W) (default: drawn from
        ``generator`` on the target's device).
      slots: s; the draws are remapped to slot-major positions before the
        histogram (infonce.py:109-114), as the TPU path does.

    Returns:
      slots == 1: (weights [B*H*W] f32 = multiplicity * (label > 0),
                   labels [B*H*W] int32);
      slots == s: (weights [s*s, B*h*w], labels [s*s, B*h*w]), slot (a, c)
                  = full-res pixel (s*i+a, s*j+c) of native pixel (i, j).
    """
    B, H, W = target.shape
    n_total = H * W
    if draws is None:
        draws = draw_pixels(B, H, W, percent, generator, target.device)
    idx = draws.to(device=target.device, dtype=torch.int64)
    s = slots
    if s > 1:
        h, w = H // s, W // s
        y, x = idx // W, idx % W
        idx = ((y % s) * s + (x % s)) * (h * w) + (y // s) * w + (x // s)
    counts = histogram(idx.to(torch.int32).contiguous(), n_total)
    target = target.to(torch.int32)
    if s > 1:
        labels = target.reshape(B, h, s, w, s).permute(2, 4, 0, 1, 3)
        labels = labels.reshape(s * s, B * h * w)
        counts = counts.reshape(B, s * s, h * w).transpose(0, 1)
        weights = counts.reshape(s * s, B * h * w) * (labels > 0)
        return weights, labels.contiguous()
    labels = target.reshape(B * n_total)
    return counts.reshape(B * n_total) * (labels > 0), labels


def sample_gumbel(num_classes: int,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """[C] standard Gumbel noise."""
    u = torch.rand(num_classes, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def distractor_counts(k_distractors: int, pct_medium: float,
                      pct_hard: float) -> Tuple[int, int, int]:
    """(n_medium, n_hard, n_rand): floor(k * pct) in f32, as JAX computes
    them (infonce.py:281-284); host numbers, so no device sync."""
    k = np.float32(k_distractors)
    n_medium = int(np.floor(k * np.float32(pct_medium)))
    n_hard = int(np.floor(k * np.float32(pct_hard)))
    return n_medium, n_hard, k_distractors - n_medium - n_hard


def _draw(pool: torch.Tensor, n: int, gumbel: torch.Tensor) -> torch.Tensor:
    """Pool members whose Gumbel score ranks in the top n: a dynamic
    threshold on static shapes (n == 0 draws nothing; a pool smaller than n
    is taken whole)."""
    C = pool.shape[0]
    scores = torch.where(pool, gumbel, -math.inf)
    sorted_desc = torch.sort(scores, descending=True).values
    thresh = sorted_desc[min(max(n - 1, 0), C - 1)]
    return pool & (scores >= thresh) & (n > 0)


def build_contrast_mask(
    labels: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
    medium_matrix: torch.Tensor,
    hard_matrix: torch.Tensor,
    k_distractors: int = 50,
    pct_medium: float = 0.0,
    pct_hard: float = 0.75,
    gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[C] bool contrast-set mask (infonce.py:233-308): present labels, plus
    n_medium + n_hard distractors drawn from the pooled similarity sets of
    the present labels, plus n_rand from the remaining classes.

    ``gumbel``: (noise of the medium/hard draw, noise of the random draw),
    each [C]; default drawn from ``generator``.  Presence runs through the
    ``class_presence`` kernel on CUDA tensors."""
    C = num_classes
    device = labels.device
    present = class_presence(labels.reshape(-1).to(torch.int32).contiguous(),
                             valid.reshape(-1).to(torch.float32).contiguous(),
                             C)
    present_f = present.float()
    n_medium, n_hard, n_rand = distractor_counts(k_distractors, pct_medium,
                                                 pct_hard)
    medium_union = (present_f @ medium_matrix.to(device, torch.float32)) > 0
    hard_union = (present_f @ hard_matrix.to(device, torch.float32)) > 0
    pool = (((medium_union & (n_medium > 0)) | (hard_union & (n_hard > 0)))
            & ~present)
    if gumbel is None:
        gumbel = (sample_gumbel(C, generator, device),
                  sample_gumbel(C, generator, device))
    g_mh, g_rand = (g.to(device, torch.float32) for g in gumbel)
    chosen_mh = _draw(pool, n_medium + n_hard, g_mh)
    chosen_rand = _draw(~present & ~chosen_mh, n_rand, g_rand)
    return present | chosen_mh | chosen_rand


def pack_contrast_set(contrast_mask: torch.Tensor,
                      text_normalized: torch.Tensor, capacity: int):
    """(class_ids [K] int32, table [K, D], packed_mask [K] bool): the first
    K members' ascending global ids (sentinel C in padded slots), their
    rows and the slot validity (infonce.py:311-332).  A cumsum and a
    scatter, no host sync."""
    C = contrast_mask.shape[0]
    device = contrast_mask.device
    member = contrast_mask.bool()
    pos = torch.cumsum(member.to(torch.int64), 0) - 1
    slot = torch.where(member & (pos < capacity), pos, capacity)
    # non-members (and members past the capacity) land in a spare slot
    ids = torch.full((capacity + 1,), C, dtype=torch.int32, device=device)
    ids.scatter_(0, slot, torch.arange(C, dtype=torch.int32, device=device))
    ids = ids[:capacity]
    table = text_normalized[ids.clamp(0, C - 1).long()]
    return ids.contiguous(), table, ids < C


def capacity_of(contrast_capacity: Optional[int]) -> Optional[int]:
    """The JAX rounding of the packed capacity (infonce.py:390-392):
    max(128, ceil(K / 128) * 128), None when packing is off."""
    if contrast_capacity is None:
        return None
    return max(LANES, -(-contrast_capacity // LANES) * LANES)


def pixel_text_infonce(
    samples: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    text_embeddings: torch.Tensor,
    contrast_mask: torch.Tensor,
    temperature: torch.Tensor,
    contrast_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Masked cross-entropy over pixel x text similarities (infonce.py:335-
    438, the kernel branch): ``samples`` [N, D] or the [B, h, w, D] field,
    ``labels``/``valid`` [N] or slots [S, N].  Returns 0 when fewer than 2
    contrast classes or no valid samples exist.

    The table is normalised in f32 and cast to the samples' dtype.  bf16
    samples with a capacity K < C score the packed member table when the
    live set fits (n_contrast <= K) and the full table otherwise, the choice
    read on the device.  PRECONDITION of the packed branch: every valid
    label is a member (``build_contrast_mask`` guarantees it)."""
    n_contrast = contrast_mask.sum(dtype=torch.int32)
    n_valid = valid.sum()
    ok = (n_contrast > 1) & (n_valid > 0)
    text_n = l2_normalize(text_embeddings.float(), dim=-1)
    C = text_n.shape[0]
    K = capacity_of(contrast_capacity)
    packed = None
    if K is not None and K < C and samples.dtype == torch.bfloat16:
        ids, ptable, pmask = pack_contrast_set(contrast_mask, text_n, K)
        packed = (ptable.to(samples.dtype), pmask, ids, n_contrast <= K)
    ce_sum = fused_pixel_text_ce(samples, temperature, labels, valid,
                                 text_n.to(samples.dtype), contrast_mask,
                                 packed)
    loss = ce_sum / n_valid.clamp_min(1.0)
    return torch.where(ok, loss, torch.zeros_like(loss))


def area_image_infonce(area_embeddings: torch.Tensor,
                       image_embeddings: torch.Tensor, valid: torch.Tensor,
                       temperature: torch.Tensor) -> torch.Tensor:
    """Diagonal-label InfoNCE between area and image embeddings with a
    validity mask over instances (infonce.py:463-490); 0 with fewer than 2
    valid instances."""
    area_n = l2_normalize(area_embeddings.float(), dim=-1)
    img_n = l2_normalize(image_embeddings.float(), dim=-1)
    logits = (area_n @ img_n.T) / temperature
    logits = torch.where(valid[None, :] > 0, logits,
                         torch.full_like(logits, NEG_INF))
    ce = torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)
    n_valid = valid.sum()
    loss = (ce * valid).sum() / n_valid.clamp_min(1.0)
    return torch.where(n_valid > 1, loss, torch.zeros_like(loss))
