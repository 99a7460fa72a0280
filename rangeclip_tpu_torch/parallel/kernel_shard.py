"""The kernels over the global batch of a process group
(``rangeclip_tpu/parallel/kernel_shard.py``).

JAX jits the step over a mesh and wraps every kernel call in a
``shard_map``: each device runs the kernel on its local shard, and the
body adds the collective that combines the shards.  In the port each rank's
kernel already sees its local rows, so this module holds only what those
bodies add on top of the kernel call: the combination over ``group`` (a
``torch.distributed`` process group of more than one rank, whose ranks hold
equal row blocks of the global batch, rank-major).  With ``group=None``
every function is the single kernel call.

Applicability gates read the local shape, as JAX's ``local_field_shape``
does: here that is simply the shape the rank holds.  The collectives are
``all_reduce`` only (``parallel/mesh.py``), so ranks can share one card
over gloo.

A loss term that is a sum over rows comes back as this rank's share: its
partial sum over local rows (or its local mean over the number of ranks),
so that the ranks' shares add up to the single call on the global batch
and autograd differentiates only the local rows.  The step adds the shares
up once a window, with the gradients (``training/train_step.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rangeclip_tpu_torch.models.depth_unet import normalize_native_field
from rangeclip_tpu_torch.ops.kernels.class_presence import class_presence
from rangeclip_tpu_torch.ops.kernels.histogram import histogram
from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
    fused_masked_pooling,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import fused_pixel_text_ce
from rangeclip_tpu_torch.ops.kernels.tv_rowtile import tv_rowtile
from rangeclip_tpu_torch.parallel.mesh import all_reduce_sum, row_block, world


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` (not differentiated) summed over the ranks of ``group``: a new
    tensor, the same bits on every rank."""
    out = x.detach().clone()
    if group is not None:
        all_reduce_sum([out], group)
    return out


def sharded_ce_sum(samples, temperature, labels, valid, table, mask,
                   packed=None, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank's CE partial sum, the global valid weight): the
    ``pixel_text_ce`` kernel on the local rows (``ops/kernels/
    pixel_text_ce.fused_pixel_text_ce``'s arguments), and ``valid``'s sum
    over every rank, the denominator the partial sums share.  The table,
    mask and packed set are the same on every rank."""
    ce = fused_pixel_text_ce(samples, temperature, labels, valid, table,
                             mask, packed)
    return ce, global_sum(valid.sum(), group)


def sharded_class_presence(labels: torch.Tensor,
                           valid: Optional[torch.Tensor], num_classes: int,
                           group=None) -> torch.Tensor:
    """[C] bool presence of ``labels`` (with ``valid`` > 0) in any rank's
    rows: the ``class_presence`` kernel on the local rows, OR'd over the
    group as one [C] sum."""
    present = class_presence(
        labels.reshape(-1).to(torch.int32).contiguous(),
        None if valid is None
        else valid.reshape(-1).to(torch.float32).contiguous(), num_classes)
    if group is None:
        return present
    return global_sum(present.float(), group) > 0


def sharded_histogram(idx: torch.Tensor, n_bins: int,
                      group=None) -> torch.Tensor:
    """The ``histogram`` kernel over this rank's images of the global draws
    ``idx`` [world * B, n]: [B, n_bins].  Each image's histogram is its
    own, so there is no collective."""
    if group is not None:
        idx = row_block(idx, group)
    return histogram(idx.contiguous(), n_bins)


def sharded_tv_rowtile(x: torch.Tensor,
                       sample_weight: Optional[torch.Tensor], upsample: int,
                       group=None) -> torch.Tensor:
    """This rank's share of the ``tv_rowtile`` TV of the global batch: the
    kernel's mean over the local rows over the number of ranks (the shards
    are equal, so the shares add up to the global mean; JAX's ``psum / nd``).
    The caller scales by the global ``B / sum(w)``."""
    loss = tv_rowtile(x, sample_weight, upsample)
    return loss if group is None else loss / world(group)


def sharded_l2_normalize_field(x: torch.Tensor, group=None) -> torch.Tensor:
    """The field [B, h, w, D] L2-normalised per pixel: no collective.  The
    decoder's ``normalize_native_field``, whose ``l2_normalize`` kernel
    gate reads the local shape; ``group`` is accepted for symmetry with
    JAX's signature."""
    del group
    return normalize_native_field(x)


def sharded_masked_pooling(emb: torch.Tensor, seg: torch.Tensor,
                           object_indices: torch.Tensor, group=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums [N, D], counts [N]) of ``masked_pooling`` over every rank's
    pixels: the kernel on the local [B, H, W, D] field, both all-reduced
    in one bucket.  Under a group the result is not differentiated (the
    kernel has no backward)."""
    B, H, W, D = emb.shape
    sums, counts = fused_masked_pooling(emb.reshape(B * H * W, D),
                                        seg.reshape(B * H * W),
                                        object_indices)
    if group is None:
        return sums, counts
    sums, counts = sums.detach().clone(), counts.detach().clone()
    all_reduce_sum([sums, counts], group)
    return sums, counts
