"""Equivalence-aware segmentation metrics (``rangeclip_tpu/evals/metrics.py``).

Reference: validate.py:95-139, vectorised as in JAX: every accumulator is
a fixed [C] float32 tensor updated by scatter-adds of 0/1 weights, so a
batch's update is a few device operations and the sums are exact (in any
order, CUDA atomics included) while a class's count stays below 2^24.

  * top-1 / top-k pixel accuracy through the [C, C] equivalence lookup;
  * top-1 mIoU over equivalence-mapped labels;
  * top-k "oracle" mIoU: a pixel's prediction is replaced by its GT
    equivalence class when ANY of the top-k predictions matches it;
    unmatched pixels keep the RAW top-1 label (not its equivalence class),
    the reference quirk the JAX package keeps for metric parity
    (validate.py:123-131).

Divergence from the reference, as in JAX: the final mIoU filters classes by
the GT equivalence classes present anywhere in the evaluated set, where the
reference filters by the last batch's GT labels only (validate.py:206-207).

Negative ids (the -1 of an exhausted candidate set) wrap to the last class,
as JAX's indexing does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def metrics_init(num_classes: int,
                 device: Optional[torch.device] = None
                 ) -> Dict[str, torch.Tensor]:
    zero = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                      device=device)
    return {
        "correct_top1": zero(),
        "correct_topk": zero(),
        "total_pixels": zero(),
        "intersection_top1": zero(num_classes),
        "union_top1": zero(num_classes),
        "intersection_topk": zero(num_classes),
        "union_topk": zero(num_classes),
        "gt_present": torch.zeros(num_classes, dtype=torch.bool,
                                  device=device),
    }


def _wrap(ids: torch.Tensor, num_classes: int) -> torch.Tensor:
    ids = ids.long()
    return torch.where(ids < 0, ids + num_classes, ids)


def _scatter(index: torch.Tensor, values: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    return values.new_zeros(num_classes).index_add_(0, index, values)


def metrics_update(acc: Dict[str, torch.Tensor], pred_topk: torch.Tensor,
                   gt: torch.Tensor, equivalence_tensor: torch.Tensor,
                   equiv_class_map: torch.Tensor,
                   pixel_weight: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Accumulate one batch; returns the new accumulators.

    Args:
      pred_topk: [B, H, W, k] int predicted label ids, descending score
        order ([..., 0] is top-1).
      gt: [B, H, W] int ground truth.
      equivalence_tensor: [C, C] bool (gt, pred) -> equivalent.
      equiv_class_map: [C] int label -> representative class id.
      pixel_weight: optional [B] or [B, H, W] float mask (0 = ignore).
    """
    B, H, W, k = pred_topk.shape
    C = equivalence_tensor.shape[0]
    n = B * H * W
    gt_flat = _wrap(gt.reshape(n), C)
    topk_flat = _wrap(pred_topk.reshape(n, k), C)
    top1_flat = topk_flat[:, 0]
    if pixel_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=gt.device)
    else:
        if pixel_weight.dim() == 1:
            pixel_weight = pixel_weight[:, None, None].expand(B, H, W)
        w = pixel_weight.reshape(n).float()
    eq = equivalence_tensor.bool()
    ecm = equiv_class_map.long()

    # pixel accuracy through the equivalence lookup (validate.py:95-103)
    correct1 = eq[gt_flat, top1_flat].float()
    correctk = eq[gt_flat[:, None], topk_flat].any(dim=1).float()

    # equivalence-mapped labels
    gt_e = ecm[gt_flat]
    top1_e = ecm[top1_flat]
    topk_e = ecm[topk_flat]

    # top-1 IoU accumulators (validate.py:105-115)
    inter1 = _scatter(gt_e, (gt_e == top1_e).float() * w, C)
    cnt_gt = _scatter(gt_e, w, C)
    union1 = cnt_gt + _scatter(top1_e, w, C) - inter1

    # top-k oracle IoU (validate.py:117-139): match -> gt class, no match
    # -> the RAW top-1 label (reference quirk)
    match_k = (topk_e == gt_e[:, None]).any(dim=1)
    oracle = torch.where(match_k, gt_e, top1_flat)
    interk = _scatter(gt_e, (oracle == gt_e).float() * w, C)
    unionk = cnt_gt + _scatter(oracle, w, C) - interk

    present = _scatter(gt_e, (w > 0).float(), C) > 0
    return {
        "correct_top1": acc["correct_top1"] + (correct1 * w).sum(),
        "correct_topk": acc["correct_topk"] + (correctk * w).sum(),
        "total_pixels": acc["total_pixels"] + w.sum(),
        "intersection_top1": acc["intersection_top1"] + inter1,
        "union_top1": acc["union_top1"] + union1,
        "intersection_topk": acc["intersection_topk"] + interk,
        "union_topk": acc["union_topk"] + unionk,
        "gt_present": acc["gt_present"] | present,
    }


def metrics_finalize(acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Reduce the accumulators to scalar metrics (validate.py:192-214)."""

    def miou(inter, union):
        valid = (union > 0) & acc["gt_present"]
        ious = torch.where(valid, inter / union.clamp_min(1.0),
                           torch.zeros_like(inter))
        n = valid.float().sum()
        return float(ious.sum() / n.clamp_min(1.0)) if float(n) > 0 else 0.0

    total = acc["total_pixels"]
    has_pixels = float(total) > 0
    return {
        "pixel_accuracy_t1": (float(acc["correct_top1"] / total.clamp_min(1.0))
                              if has_pixels else 0.0),
        "pixel_accuracy_tk": (float(acc["correct_topk"] / total.clamp_min(1.0))
                              if has_pixels else 0.0),
        "mIoU_t1": miou(acc["intersection_top1"], acc["union_top1"]),
        "mIoU_tk": miou(acc["intersection_topk"], acc["union_topk"]),
        "n_labels_t1": int((acc["union_top1"] > 0).sum()),
        "n_labels_tk": int((acc["union_topk"] > 0).sum()),
    }
