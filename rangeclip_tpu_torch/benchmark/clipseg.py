"""CLIPSeg subject for the robustness sweep (``rangeclip_tpu/benchmark/
clipseg.py``).

Reference: benchmark/segclip.py:342-455 — the published robustness rows
(BASELINE.md) come from HF ``CIDAS/clipseg-rd64-refined``: per sample the
prompt set is the image's non-zero GT labels plus up to 20 distractors
(:370-375), CLIPSeg scores every prompt against the (perturbed) RGB image,
and per-pixel top-k over the prompt axis maps back to global label indices
(:416-417 + calculate_topk_metrics).

Split into layers so the mapping logic is testable without weights:
  * :func:`clipseg_topk_from_logits` — prompt logits -> global top-k labels
    (``ops/resize.resize_bilinear`` to the GT shape, top-k over prompts,
    ties to the lower prompt index as ``jax.lax.top_k`` breaks them, index
    map);
  * :func:`make_clipseg_predict_fn` — wraps any
    ``logits_fn(prompts, image_hwc) -> [P, h, w]`` into the
    ``predict_fn(generator, batch, enhanced_image)`` contract of
    :func:`rangeclip_tpu_torch.benchmark.robustness.robustness_sweep`;
  * :func:`hf_clipseg_logits_fn` — the HF adapter: local weights only, no
    network call (transformers is imported when it is called).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from rangeclip_tpu_torch.ops.resize import resize_bilinear


def clipseg_topk_from_logits(
    logits: np.ndarray,
    global_indices: Sequence[int],
    target_shape,
    top_k: int = 5,
) -> torch.Tensor:
    """[P, h, w] per-prompt logits -> [H, W, top_k] int32 global label ids.

    Matches the reference's calculate_topk_metrics preprocessing
    (segclip.py: bilinear resize to the GT map's shape, then top-k over the
    prompt axis and prompt->global index mapping).  When there are fewer
    prompts than ``top_k`` the trailing columns repeat the last prompt.
    """
    scores = torch.as_tensor(np.asarray(logits, np.float32)).permute(1, 2, 0)
    scores = resize_bilinear(scores[None], tuple(target_shape))[0]  # [H, W, P]
    k = min(top_k, scores.shape[-1])
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True)[1][..., :k]
    gmap = torch.tensor(list(global_indices), dtype=torch.int32)
    topk = gmap[idx]
    if k < top_k:
        topk = torch.cat([topk] + [topk[..., -1:]] * (top_k - k), dim=-1)
    return topk


def make_clipseg_predict_fn(
    logits_fn: Callable[[List[str], np.ndarray], np.ndarray],
    labels: Sequence[str],
    num_distractors: int = 20,
    top_k: int = 5,
) -> Callable:
    """Build the sweep's ``predict_fn(generator, batch, enhanced_image)``.

    Per item (segclip.py:364-375): prompts = sorted non-zero GT labels +
    ``num_distractors`` distractors sampled without replacement from the
    remaining non-zero classes (a numpy stream seeded from the batch's
    generator); ``logits_fn`` scores the prompts against the perturbed RGB;
    top-k over prompts maps back to global indices.  Items with no non-zero
    GT labels predict label 0; the sweep weights such items out of the
    metrics entirely, matching the reference's per-sample skip.
    """
    num_classes = len(labels)

    def predict_fn(generator: torch.Generator, batch,
                   enhanced_image: np.ndarray) -> torch.Tensor:
        seg_np = np.asarray(batch["segmentation"])
        B, H, W = seg_np.shape
        out = torch.zeros((B, H, W, top_k), dtype=torch.int32)
        seed = int(torch.randint(0, np.iinfo(np.int32).max, (),
                                 generator=generator))
        rstate = np.random.default_rng(seed)
        for b in range(B):
            gt = sorted(int(i) for i in np.unique(seg_np[b]) if i != 0)
            if not gt:
                continue
            pool = [i for i in range(1, num_classes) if i not in set(gt)]
            n_d = min(num_distractors, len(pool))
            distractors = (
                rstate.choice(pool, n_d, replace=False).tolist() if n_d else []
            )
            global_idx = gt + distractors
            prompts = [labels[i] for i in global_idx]
            logits = np.asarray(
                logits_fn(prompts, enhanced_image[b]), np.float32
            )
            out[b] = clipseg_topk_from_logits(logits, global_idx, (H, W),
                                              top_k)
        return out

    return predict_fn


def hf_clipseg_logits_fn(model_name_or_path: str, device: str = "cuda"):
    """HF CLIPSeg -> ``logits_fn``, from local files only.

    Reproduces the reference inference call exactly (segclip.py:412-414):
    the image is repeated once per prompt, text is padded to max length,
    and the model returns [P, h, w] per-prompt segmentation logits.
    """
    from transformers import CLIPSegForImageSegmentation, CLIPSegProcessor

    processor = CLIPSegProcessor.from_pretrained(model_name_or_path,
                                                 local_files_only=True)
    model = CLIPSegForImageSegmentation.from_pretrained(
        model_name_or_path, local_files_only=True)
    model.eval().to(device)

    def logits_fn(prompts: List[str], image_hwc: np.ndarray) -> np.ndarray:
        img = np.clip(np.asarray(image_hwc, np.float32), 0.0, 1.0)
        img = (img * 255.0).astype(np.uint8)
        with torch.no_grad():
            inputs = processor(
                text=list(prompts),
                images=[img] * len(prompts),
                return_tensors="pt",
                padding="max_length",
            ).to(device)
            logits = model(**inputs).logits
        if logits.ndim == 2:  # single prompt: HF squeezes the prompt axis
            logits = logits[None]
        return logits.float().cpu().numpy()

    return logits_fn
