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
from rangeclip_tpu_torch.parallel.halo import RowShards, active_shards
from rangeclip_tpu_torch.parallel.kernel_shard import (
    global_sum,
    sharded_tv_rowtile,
)
from rangeclip_tpu_torch.parallel.mesh import as_grid


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

    ``group`` (a grid or a process group): the field is this rank's block
    of the global batch (the gate reads this local shape), and the value is
    this rank's share of the global batch's TV: its images' TV over the
    number of data blocks, times the global ``B / sum(w)`` (an image-level
    sum, over 'data').  Under a 'spatial' axis the kernel does not run, as
    in JAX: the plain formulation on the rank's rows and one halo row below
    (:func:`row_sharded_tv`)."""
    grid = as_grid(group)
    n_data = 1 if grid is None else grid.n_data
    scale = None
    if sample_weight is not None:
        n = global_sum(sample_weight.float().sum(), grid, "data"
                       ).clamp_min(1.0)
        scale = n.new_tensor(float(pixel_embeddings.shape[0] * n_data)) / n
    if (pixel_embeddings.device.type == "cuda"
            and kernel_applicable(tuple(pixel_embeddings.shape),
                                  pixel_embeddings.dtype)):
        loss = sharded_tv_rowtile(pixel_embeddings, sample_weight,
                                  int(upsample), grid)
        if loss is not None:
            return loss if scale is None else loss * scale
    if sample_weight is not None:
        w = sample_weight.to(pixel_embeddings.dtype)
        pixel_embeddings = pixel_embeddings * w[:, None, None, None]
    shards = active_shards(grid)
    loss = (tv_plain(pixel_embeddings, int(upsample)) if shards is None
            else row_sharded_tv(pixel_embeddings, int(upsample), shards))
    if grid is not None:
        loss = loss / n_data
    return loss if scale is None else loss * scale


def row_sharded_tv(x: torch.Tensor, upsample: int,
                   shards: RowShards) -> torch.Tensor:
    """This spatial rank's share of the TV of the [B, H, W, D] field whose
    rows it holds a block of: its rows' horizontal differences and the
    vertical ones down to the first row below the block (fetched from its
    owner), each summed in f32 over the whole field's pair count, with the
    upsample rescale.  Slopes are +1 at ties, as the plain formulation's
    VJP takes them (``torch.where(d >= 0, d, -d)``)."""
    B, _, W, D = x.shape
    H = shards.height(W)
    n = shards.n
    windows = [(lo, min(hi + 1, H)) if hi > lo else (lo, lo)
               for lo, hi in (shards.owned(H, r) for r in range(n))]
    ext = shards.fetch(x.permute(0, 3, 1, 2), H, windows).permute(0, 2, 3, 1)
    mag = lambda d: torch.where(d >= 0, d, -d).sum(  # noqa: E731
        dtype=torch.float32)
    s_h = mag(x[:, :, :-1] - x[:, :, 1:])
    s_v = mag(ext[:, :-1] - ext[:, 1:])
    tv_h = s_h / s_h.new_tensor(float(B * H * (W - 1) * D))
    tv_v = s_v / s_v.new_tensor(float(B * (H - 1) * W * D))
    if upsample > 1:
        tv_h = tv_h * tv_h.new_tensor((W - 1) / (upsample * W - 1))
        tv_v = tv_v * tv_v.new_tensor((H - 1) / (upsample * H - 1))
    return tv_h + tv_v
