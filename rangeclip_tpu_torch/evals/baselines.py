"""Baseline evaluators, the metric stack's sanity oracles
(``rangeclip_tpu/evals/baselines.py``).

Reference: evaluation.py —
  * MajorityBaseline: constant-label prediction (:6-17) and
    evaluate_majority_model (:68-109);
  * RandomWithNegativesBaseline: uniform prediction over the item's GT
    labels plus sampled negatives (:20-61) and evaluate_random_model
    (:111-154);
  * evaluate_mask_clip: the MaskCLIP-style zero-shot dense probe, CLIP ViT
    patch tokens through the visual projection, upsampled, cosine-scored
    against the batch's candidate text set (:162-237);
  * evaluate_seg_former: the supervised RGB segmentation probe (:245-322)
    over any ``images -> [B, h, w, C_model]`` logits callable;
    :func:`hf_segformer_logits_fn` adapts an HF SegFormer.

The random draws cannot be JAX's: each candidate set comes from
``build_candidate_mask`` with Gumbel noise from a CPU generator keyed
(seed, batch), and the random baseline's labels are drawn uniformly within
it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)
from rangeclip_tpu_torch.models.clip.crops import clip_normalize
from rangeclip_tpu_torch.models.clip.model import CLIPVisionTower
from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
from rangeclip_tpu_torch.ops.resize import resize_bilinear
from rangeclip_tpu_torch.training.train_step import microbatch_generator
from rangeclip_tpu_torch.utils.logging import log
from rangeclip_tpu_torch.utils.math import l2_normalize

_CPU = torch.device("cpu")


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


def _batch_generator(seed: int, i: int) -> torch.Generator:
    """Batch ``i``'s draws: a CPU generator keyed (seed, i)."""
    return microbatch_generator(seed, i, 0, _CPU)


@torch.no_grad()
def mask_clip_predict(vision_tower: CLIPVisionTower, images: torch.Tensor,
                      shape, text_n: torch.Tensor,
                      candidate_mask: torch.Tensor,
                      top_k: int = 5) -> torch.Tensor:
    """MaskCLIP's dense prediction: CLIP-normalised images [B, H, W, 3] ->
    the projected patch tokens, bilinearly resized to ``shape`` (H, W),
    L2-normalised and scored in f32 against the normalised text table
    ``text_n`` [C, D]; classes outside ``candidate_mask`` [C] at -1e30;
    top-k ids [B, H, W, k] int32."""
    patches = vision_tower(images, return_patches=True)
    dense = l2_normalize(resize_bilinear(patches, shape).float(), dim=-1)
    logits = torch.einsum("bhwd,cd->bhwc", dense, text_n)
    logits = torch.where(candidate_mask, logits, -1e30)
    return torch.topk(logits, top_k, dim=-1).indices.to(torch.int32)


def evaluate_mask_clip(dataloader, vision_tower: CLIPVisionTower,
                       text_table, equivalence_tensor, equiv_class_map,
                       num_classes: int, num_negatives: int = 50,
                       top_k: int = 5, seed: int = 0,
                       log_path: Optional[str] = None
                       ) -> Dict[str, float]:
    """MaskCLIP-style dense zero-shot probe (evaluation.py:162-237) on the
    tower's device: per batch, the candidate set is the present classes
    plus ``num_negatives`` drawn ones (:func:`build_candidate_mask`, noise
    keyed (seed, batch)), and :func:`mask_clip_predict` scores the batch's
    images against it."""
    device = vision_tower.visual_projection.weight.device
    text_n = l2_normalize(torch.as_tensor(text_table).to(device).float(),
                          dim=-1)

    def predict_fn(i, batch, seg):
        images = clip_normalize(torch.from_numpy(
            np.asarray(batch["image"], np.float32)).to(device))
        mask = build_candidate_mask(seg, num_classes, num_negatives,
                                    generator=_batch_generator(seed, i))
        return mask_clip_predict(vision_tower, images, tuple(seg.shape[1:3]),
                                 text_n, mask, top_k)

    return _run_metric_loop(predict_fn, dataloader, equivalence_tensor,
                            equiv_class_map, num_classes, device, log_path,
                            "MaskCLIP Probe")


@torch.no_grad()
def evaluate_seg_former(dataloader, logits_fn, num_classes: int,
                        equivalence_tensor=None, num_negatives: int = 300,
                        seed: int = 0, log_path: Optional[str] = None
                        ) -> float:
    """Supervised RGB segmentation probe (evaluation.py:245-322).

    ``logits_fn(images)`` maps [B, H, W, 3] float images in [0, 1] (numpy;
    non-finite values replaced, reference :265-277) to [B, h, w, C_model]
    per-class logits at any resolution, numpy or a tensor, bilinearly
    resized to the labels' (:291).  The probe runs where the logits are:
    on a tensor's device, on the host for numpy.  Predictions are restricted to the present classes plus
    ``num_negatives`` drawn ones (:294-305; noise keyed (seed, batch)) and
    scored with equivalence-aware pixel accuracy (:311-316), padding
    samples (``sample_valid`` 0) weighted out.  Returns the pixel accuracy,
    the only number the reference reports (:319-322)."""
    correct = total = 0.0
    for i, batch in enumerate(dataloader):
        images = np.asarray(batch["image"], np.float32)
        if not np.isfinite(images).all():
            images = np.nan_to_num(images, nan=0.0, posinf=1.0, neginf=0.0)
        images = np.clip(images, 0.0, 1.0)
        logits = logits_fn(images)
        logits = (logits.float() if isinstance(logits, torch.Tensor)
                  else torch.from_numpy(np.asarray(logits, np.float32)))
        device = logits.device
        seg = torch.from_numpy(np.asarray(batch["segmentation"])).to(device)
        logits = resize_bilinear(logits, tuple(seg.shape[1:3]))
        mask = build_candidate_mask(seg, num_classes, num_negatives,
                                    generator=_batch_generator(seed, i))
        C_model = logits.shape[-1]
        mask = (mask[:C_model] if C_model <= num_classes
                else F.pad(mask, (0, C_model - num_classes), value=False))
        logits = torch.where(mask, logits, -math.inf)
        pred = logits.argmax(dim=-1).reshape(-1)
        gt = seg.reshape(-1).long()
        valid = np.asarray(batch.get("sample_valid",
                                     np.ones(seg.shape[0])), np.float32)
        weight = torch.from_numpy(valid).to(device).repeat_interleave(
            int(np.prod(seg.shape[1:])))
        hit = ((gt == pred).float() if equivalence_tensor is None else
               torch.as_tensor(equivalence_tensor, device=device)[gt, pred]
               .float())
        correct += float((hit * weight).sum())
        total += float(weight.sum())
    pixel_accuracy = correct / total if total > 0 else 0.0
    log(f"[SegFormer Evaluation] Pixel accuracy (GT + {num_negatives} "
        f"distractors): {pixel_accuracy:.4f}", log_path)
    return pixel_accuracy


def hf_segformer_logits_fn(model_name_or_path: str,
                           device: Union[str, torch.device]):
    """Adapter: an HF SegFormer on ``device`` -> a ``logits_fn`` for
    :func:`evaluate_seg_former`, whose logits stay on that device (so the
    probe runs there).  Needs the ``transformers`` package and weights on
    disk (nothing is downloaded); imported only here."""
    from transformers import (
        AutoImageProcessor,
        SegformerForSemanticSegmentation,
    )

    processor = AutoImageProcessor.from_pretrained(model_name_or_path)
    model = SegformerForSemanticSegmentation.from_pretrained(
        model_name_or_path).eval().to(device)

    @torch.no_grad()
    def logits_fn(images_hwc: np.ndarray) -> torch.Tensor:
        inputs = processor(images=list(images_hwc), return_tensors="pt",
                           do_rescale=False).to(device)
        out = model(**inputs).logits  # [B, C_model, h, w]
        return out.permute(0, 2, 3, 1)

    return logits_fn
