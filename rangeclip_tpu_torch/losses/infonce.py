"""InfoNCE losses (``rangeclip_tpu/losses/infonce.py``), in the form the JAX
package's kernel path takes: pixel multiplicities from a histogram of
uniform draws in slot order, the contrast set as a [C] mask with Gumbel
top-n distractors under dynamic thresholds, and the fused pixel-text CE
(packed when the live set fits).  Kernels run for CUDA tensors
(``histogram``, ``class_presence``, ``pixel_text_ce``), plain versions for
CPU tensors.

``jax.random`` cannot be reproduced in torch: every draw (pixel indices,
Gumbel noise) can be passed in, so tests feed both sides the same arrays;
without them the draws come from a ``torch.Generator``.  The opt-in
multinomial sampler (``multinomial_counts``: the same law as the histogram,
drawn by binomial splitting) holds to JAX in law and in its slot layout.
Not ported: ``sample_pixels`` (the multiplicity form replaces it).

Over a process group or a grid (``group``, the global-batch step) each rank
holds its block of the global batch: its data block of the images and, on
a grid with a 'spatial' axis, its block of their rows.  The draws are made
for the whole global batch, the same on every rank, and each keeps its
images and rows; presence and the valid counts are taken over every rank
holding pixels (``parallel/kernel_shard.py``), and the losses come back as
this rank's share, its rows' partial sum over the global denominator, so
that the ranks' shares add up to the loss of the global batch.  The image
contrast is image-level: one share per data block.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.parallel.kernel_shard import (
    sharded_ce_sum,
    sharded_class_presence,
    sharded_histogram,
)
from rangeclip_tpu_torch.parallel.halo import active_shards
from rangeclip_tpu_torch.parallel.mesh import as_grid
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
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiplicity-weighted uniform pixel sampling (infonce.py:74-142).

    Args:
      target: [B, H, W] int labels.
      draws: [B, n] int draw indices in [0, H * W) (default: drawn from
        ``generator`` on the target's device).
      slots: s; the draws are remapped to slot-major positions before the
        histogram (infonce.py:109-114), as the TPU path does.
      group: ``target`` is this rank's block and ``draws`` [n_data * B,
        n] the global batch's images (drawn so when None); each rank
        histograms its own images over their whole H * W pixels and, on a
        spatial grid, keeps its rows of the counts.

    Returns:
      slots == 1: (weights [B*H*W] f32 = multiplicity * (label > 0),
                   labels [B*H*W] int32);
      slots == s: (weights [s*s, B*h*w], labels [s*s, B*h*w]), slot (a, c)
                  = full-res pixel (s*i+a, s*j+c) of native pixel (i, j).
    """
    grid = as_grid(group)
    shards = active_shards(grid)
    B, H, W = target.shape
    if shards is not None:
        H = shards.height(W)  # the whole image's; target holds a block
    n_total = H * W
    if draws is None:
        rows = B * (1 if grid is None else grid.n_data)
        draws = draw_pixels(rows, H, W, percent, generator, target.device)
    idx = draws.to(device=target.device, dtype=torch.int64)
    s = slots
    if s > 1:
        h, w = H // s, W // s
        y, x = idx // W, idx % W
        idx = ((y % s) * s + (x % s)) * (h * w) + (y // s) * w + (x // s)
    counts = sharded_histogram(idx.to(torch.int32), n_total, grid)
    return _slot_layout(target, counts, s, shards)


def _slot_layout(target: torch.Tensor, counts: torch.Tensor, s: int,
                 shards) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, labels) of the samplers from per-image counts [B, H * W]
    over the whole images (slot-major when s > 1): a spatial rank keeps
    the counts of its rows, those of ``target``."""
    B, H_local, W = target.shape
    w = W // s
    if shards is not None:
        H = shards.height(W)
        lo, hi = shards.owned(H // s)
        counts = counts.reshape(B, s * s, H // s, w)[:, :, lo:hi]
    target = target.to(torch.int32)
    h = H_local // s
    if s > 1:
        labels = target.reshape(B, h, s, w, s).permute(2, 4, 0, 1, 3)
        labels = labels.reshape(s * s, B * h * w)
        counts = counts.reshape(B, s * s, h * w).transpose(0, 1)
        weights = counts.reshape(s * s, B * h * w) * (labels > 0)
        return weights, labels.contiguous()
    labels = target.reshape(B * H_local * W)
    return counts.reshape(B * H_local * W) * (labels > 0), labels


def multinomial_counts(n: int, n_bins: int, batch: int = 1,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Exact Multinomial(n, uniform over n_bins) counts without a scatter
    (infonce.py:145-182): binary binomial splitting.  The root holds n
    balls; at each of ceil(log2(n_bins)) levels every node splits its count
    Binomial(count, w_left / w) between its children, where w counts the
    real (non-padding) leaves below, so bin counts that are not a power of
    two stay exact.  One ``torch.binomial`` call per level, drawn from
    ``generator``.

    Returns [batch, n_bins] float32 counts; each row sums to exactly n."""
    levels = max((n_bins - 1).bit_length(), 0)
    padded = 1 << levels
    # real-leaf weight under each node, per level (computed bottom-up)
    leaf = np.zeros((padded,), np.float64)
    leaf[:n_bins] = 1.0
    weights_per_level = []
    w = leaf
    for _ in range(levels):
        w = w.reshape(-1, 2).sum(axis=1)
        weights_per_level.append(w)
    counts = torch.full((batch, 1), float(n), dtype=torch.float32,
                        device=device)
    for lev in range(levels - 1, -1, -1):
        w_pair = (weights_per_level[lev - 1] if lev > 0 else leaf
                  ).reshape(-1, 2)
        p = w_pair[:, 0] / np.maximum(w_pair.sum(axis=1), 1.0)
        prob = torch.from_numpy(p.astype(np.float32)).to(device)
        left = torch.binomial(counts, prob.expand_as(counts),
                              generator=generator)
        counts = torch.stack([left, counts - left], dim=-1).reshape(batch, -1)
    return counts[:, :n_bins]


def sample_pixel_multiplicities_multinomial(
    target: torch.Tensor,
    percent: float = 0.7,
    slots: int = 1,
    counts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter-free sampler (infonce.py:184-231): per-image counts
    drawn from the Multinomial law of with-replacement sampling
    (:func:`multinomial_counts`), the same estimator in distribution as
    :func:`sample_pixel_multiplicities`.

    Args:
      target: [B, H, W] int labels (H, W divisible by ``slots``).
      counts: [B, H * W] counts (default: drawn from ``generator`` on the
        target's device).  Bin b of an image is, slot-major, slot (a, c) of
        native pixel (i, j): multinomial bins are exchangeable, so that
        assignment is free and no full-resolution transpose is needed.
      group: ``target`` is this rank's block and ``counts`` [n_data * B,
        H * W] the global batch's images (drawn so when None); each rank
        keeps its images and, on a spatial grid, their rows.

    Returns the contract of :func:`sample_pixel_multiplicities`."""
    grid = as_grid(group)
    shards = active_shards(grid)
    B, H, W = target.shape
    if shards is not None:
        H = shards.height(W)
    n_total = H * W
    if counts is None:
        rows = B * (1 if grid is None else grid.n_data)
        counts = multinomial_counts(n_draws(H, W, percent), n_total, rows,
                                    generator, target.device)
    if grid is not None:
        counts = grid.image_block(counts)
    counts = counts.to(device=target.device, dtype=torch.float32)
    return _slot_layout(target, counts, slots, shards)


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
    group=None,
) -> torch.Tensor:
    """[C] bool contrast-set mask (infonce.py:233-308): present labels, plus
    n_medium + n_hard distractors drawn from the pooled similarity sets of
    the present labels, plus n_rand from the remaining classes.

    ``gumbel``: (noise of the medium/hard draw, noise of the random draw),
    each [C]; default drawn from ``generator``.  Presence runs through the
    ``class_presence`` kernel on CUDA tensors, over every rank's rows under
    ``group`` (the noise is then the same on every rank)."""
    C = num_classes
    device = labels.device
    present = sharded_class_presence(labels, valid, C, group)
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
    group=None,
) -> torch.Tensor:
    """Masked cross-entropy over pixel x text similarities (infonce.py:335-
    438, the kernel branch): ``samples`` [N, D] or the [B, h, w, D] field,
    ``labels``/``valid`` [N] or slots [S, N].  Returns 0 when fewer than 2
    contrast classes or no valid samples exist.

    The table is normalised in f32 and cast to the samples' dtype.  bf16
    samples with a capacity K < C score the packed member table when the
    live set fits (n_contrast <= K) and the full table otherwise, the choice
    read on the device.  PRECONDITION of the packed branch: every valid
    label is a member (``build_contrast_mask`` guarantees it).  Under
    ``group`` the CE sum is this rank's rows' and the valid count every
    rank's: the loss is this rank's share."""
    n_contrast = contrast_mask.sum(dtype=torch.int32)
    text_n = l2_normalize(text_embeddings.float(), dim=-1)
    C = text_n.shape[0]
    K = capacity_of(contrast_capacity)
    packed = None
    if K is not None and K < C and samples.dtype == torch.bfloat16:
        ids, ptable, pmask = pack_contrast_set(contrast_mask, text_n, K)
        packed = (ptable.to(samples.dtype), pmask, ids, n_contrast <= K)
    ce_sum, n_valid = sharded_ce_sum(samples, temperature, labels, valid,
                                     text_n.to(samples.dtype), contrast_mask,
                                     packed, group)
    ok = (n_contrast > 1) & (n_valid > 0)
    loss = ce_sum / n_valid.clamp_min(1.0)
    return torch.where(ok, loss, torch.zeros_like(loss))


def area_image_infonce(area_embeddings: torch.Tensor,
                       image_embeddings: torch.Tensor, valid: torch.Tensor,
                       temperature: torch.Tensor, group=None) -> torch.Tensor:
    """Diagonal-label InfoNCE between area and image embeddings with a
    validity mask over instances (infonce.py:463-490); 0 with fewer than 2
    valid instances.  Under ``group`` this rank's area rows are scored
    against every data block's image embeddings and validity (gathered
    over 'data', not differentiated: they are frozen inputs), over the
    global valid count: the loss is this data block's share.  The term is
    image-level: the spatial ranks of a data block hold the same area
    embeddings, and only the first returns the share (the others a zero
    that keeps their graph, and its collectives, the same)."""
    area_n = l2_normalize(area_embeddings.float(), dim=-1)
    grid = as_grid(group)
    if grid is None:
        img_all, valid_all, offset = image_embeddings, valid, 0
    else:
        both = grid.gather(torch.cat([image_embeddings.float(),
                                      valid.float()[:, None]], 1), "data")
        img_all, valid_all = both[:, :-1], both[:, -1]
        offset = grid.d * area_n.shape[0]
    img_n = l2_normalize(img_all.float(), dim=-1)
    logits = (area_n @ img_n.T) / temperature
    logits = torch.where(valid_all[None, :] > 0, logits,
                         torch.full_like(logits, NEG_INF))
    ce = torch.logsumexp(logits, dim=-1) - torch.diagonal(logits, offset)
    n_valid = valid_all.sum()
    loss = (ce * valid).sum() / n_valid.clamp_min(1.0)
    loss = torch.where(n_valid > 1, loss, torch.zeros_like(loss))
    return loss * 0.0 if grid is not None and grid.s else loss
