"""Baseline evaluators, the metric stack's sanity oracles
(``rangeclip_tpu/evals/baselines.py``).

Reference: evaluation.py —
  * MajorityBaseline: constant-label prediction (:6-17) and
    evaluate_majority_model (:68-109);
  * RandomWithNegativesBaseline: uniform prediction over the item's GT
    labels plus sampled negatives (:20-61) and evaluate_random_model
    (:111-154).

The random draws cannot be JAX's: each item's candidate set comes from
``build_candidate_mask`` with Gumbel noise from a CPU generator, and the
labels are drawn uniformly within it.  The MaskCLIP and SegFormer probes
need the CLIP vision tower or an HF SegFormer and are not ported (ROADMAP
item 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)
from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
from rangeclip_tpu_torch.training.train_step import microbatch_generator
from rangeclip_tpu_torch.utils.logging import log


class MajorityBaseline:
    """Constant-label prediction (evaluation.py:6-17)."""

    def __init__(self, majority_label_index: int):
        self.majority_label_index = majority_label_index

    def predict(self, depth: torch.Tensor, top_k: int = 1) -> torch.Tensor:
        B, H, W = depth.shape[:3]
        return torch.full((B, H, W, top_k), self.majority_label_index,
                          dtype=torch.int32, device=depth.device)


class RandomWithNegativesBaseline:
    """Uniform prediction over the item's GT labels plus ``num_negatives``
    sampled others (evaluation.py:20-61)."""

    def __init__(self, num_classes: int, num_negatives: int = 300):
        self.num_classes = num_classes
        self.num_negatives = num_negatives

    def predict(self, segmentation: torch.Tensor, top_k: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, H, W] labels -> [B, H, W, top_k] int32; ``generator`` (CPU)
        draws every item's candidate mask and labels."""
        B, H, W = segmentation.shape
        out = []
        for b in range(B):
            mask = build_candidate_mask(segmentation[b].cpu(),
                                        self.num_classes, self.num_negatives,
                                        generator=generator)
            members = mask.nonzero()[:, 0].to(torch.int32)
            pick = torch.randint(0, members.numel(), (H, W, top_k),
                                 generator=generator)
            out.append(members[pick])
        return torch.stack(out).to(segmentation.device)


def _run_metric_loop(predict_fn, dataloader, equivalence_tensor,
                     equiv_class_map, num_classes: int, device,
                     log_path=None, name: str = "baseline"):
    acc = metrics_init(num_classes, device)
    eq = torch.as_tensor(equivalence_tensor, device=device)
    ecm = torch.as_tensor(equiv_class_map, device=device)
    for i, batch in enumerate(dataloader):
        seg = torch.from_numpy(np.asarray(batch["segmentation"])).to(device)
        valid = torch.from_numpy(np.asarray(batch["sample_valid"],
                                            np.float32)).to(device)
        acc = metrics_update(acc, predict_fn(i, batch, seg), seg, eq, ecm,
                             pixel_weight=valid)
    results = metrics_finalize(acc)
    log(f"[{name}] Pixel accuracy: {results['pixel_accuracy_t1']:.4f}",
        log_path)
    log(f"[{name}] mIoU: {results['mIoU_t1']:.4f}", log_path)
    return results


def evaluate_majority_model(dataloader, majority_label_index: int,
                            equivalence_tensor, equiv_class_map,
                            num_classes: int, log_path: Optional[str] = None,
                            device: torch.device = torch.device("cpu")
                            ) -> Dict[str, float]:
    model = MajorityBaseline(majority_label_index)
    return _run_metric_loop(
        lambda i, batch, seg: model.predict(seg[..., None]),
        dataloader, equivalence_tensor, equiv_class_map, num_classes, device,
        log_path, "Majority Baseline")


def evaluate_random_model(dataloader, num_classes: int, equivalence_tensor,
                          equiv_class_map, num_negatives: int = 300,
                          seed: int = 0, log_path: Optional[str] = None,
                          device: torch.device = torch.device("cpu")
                          ) -> Dict[str, float]:
    """Batch ``i`` draws from a generator keyed (seed, i)."""
    model = RandomWithNegativesBaseline(num_classes, num_negatives)
    return _run_metric_loop(
        lambda i, batch, seg: model.predict(
            seg, generator=microbatch_generator(seed, i, 0,
                                                torch.device("cpu"))),
        dataloader, equivalence_tensor, equiv_class_map, num_classes, device,
        log_path, "Random Baseline")


def evaluate_mask_clip(*args, **kwargs):
    raise NotImplementedError(
        "evaluate_mask_clip needs the CLIP vision tower, which is not ported "
        "yet (ROADMAP Queue 1, item 9)")


def evaluate_seg_former(*args, **kwargs):
    raise NotImplementedError(
        "evaluate_seg_former needs an HF SegFormer, which is not ported yet "
        "(ROADMAP Queue 1, item 9)")
