"""Weighted regression losses (``rangeclip_tpu/losses/weighted.py``).

Reference: utils/src/loss_utils.py:9-69 — validity-weighted L1/L2 losses
used by the shared depth-completion utilities.  Reference semantics kept
exactly: the weighted mean is computed PER SAMPLE over the non-batch dims
(``sum(w*loss, dims=[1..]) / sum(w, dims=[1..])``), then averaged across
the batch; ``normalize=True`` divides the elementwise loss by |tgt|+eps
(L1) / tgt^2+eps (L2) first.  Plain tensor functions: autograd gives their
gradients.  No training path of the port calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

EPSILON = 1e-8


def _per_sample_weighted_mean(loss: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    # The denominator sums w WITHOUT broadcasting it to the loss shape —
    # the reference's exact arithmetic (torch.sum(w, dim=[1,2,3]) on an
    # [N,1,H,W] weight against an [N,3,H,W] loss, loss_utils.py:36/67).
    per = ((w * loss).sum(dim=tuple(range(1, loss.dim())))
           / w.sum(dim=tuple(range(1, w.dim()))))
    return per.mean()


def weighted_l1_loss(src: torch.Tensor, tgt: torch.Tensor,
                     w: Optional[torch.Tensor] = None,
                     normalize: bool = False) -> torch.Tensor:
    """Mean over batch of per-sample weighted L1 (loss_utils.py:9-37)."""
    loss = (tgt - src).abs()
    if normalize:
        loss = loss / (tgt.abs() + EPSILON)
    if w is None:
        w = torch.ones_like(src)
    return _per_sample_weighted_mean(loss, w)


def weighted_l2_loss(src: torch.Tensor, tgt: torch.Tensor,
                     w: Optional[torch.Tensor] = None,
                     normalize: bool = False) -> torch.Tensor:
    """Mean over batch of per-sample weighted squared error
    (loss_utils.py:39-69)."""
    loss = (tgt - src).square()
    if normalize:
        loss = loss / (tgt.square() + EPSILON)
    if w is None:
        w = torch.ones_like(src)
    return _per_sample_weighted_mean(loss, w)


def smoothness_loss_weighted(predict: torch.Tensor,
                             image: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness on NHWC tensors: TV of the prediction weighted
    by image-gradient magnitude (an extension beyond the reference's
    loss_utils.py, which has no smoothness term)."""
    pred_dy = (predict[:, 1:, :, :] - predict[:, :-1, :, :]).abs()
    pred_dx = (predict[:, :, 1:, :] - predict[:, :, :-1, :]).abs()
    img_dy = (image[:, 1:, :, :] - image[:, :-1, :, :]).abs().mean(
        dim=-1, keepdim=True)
    img_dx = (image[:, :, 1:, :] - image[:, :, :-1, :]).abs().mean(
        dim=-1, keepdim=True)
    wy = torch.exp(-img_dy)
    wx = torch.exp(-img_dx)
    return (wy * pred_dy).mean() + (wx * pred_dx).mean()
