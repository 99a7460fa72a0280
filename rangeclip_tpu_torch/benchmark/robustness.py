"""Brightness/saturation robustness sweep (``rangeclip_tpu/benchmark/
robustness.py``).

Reference: benchmark/segclip.py — sweeps PIL ImageEnhance brightness and
saturation (color) levels over sampled images, prompts each sample's GT
labels plus 20 distractors, and reports equivalence-aware top-1/top-k
accuracy and mIoU per perturbation level (:23-28, 51-58, 60-140, 353-455).

The sweep is generic over the segmenter: plug in any
``predict_fn(generator, batch, enhanced_image) -> [B, H, W, k] label ids``
— the depth model (perturbations only affect the RGB used for prompts and
crops), the MaskCLIP probe (``evals/baselines.py``), or a CLIPSeg-style
model (``benchmark/clipseg.py``).  Batch ``i`` gets a CPU
``torch.Generator`` keyed (seed, i) where JAX folds ``i`` into its key,
so a batch's draws do not depend on the perturbation level.  The metrics
accumulate with ``evals/metrics`` on the predictions' device.
Enhancement math replicates PIL.ImageEnhance semantics (numpy):
  brightness(f): img * f
  color(f):      grayscale + f * (img - grayscale), L = 0.299R+0.587G+0.114B

``plot_results`` imports matplotlib when called; without it, it raises
an ImportError that names the package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)


def enhance_brightness(image: np.ndarray, factor: float) -> np.ndarray:
    """image [H, W, 3] float in [0, 1]."""
    return np.clip(image * factor, 0.0, 1.0)


def enhance_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    lum = (
        0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    )[..., None]
    return np.clip(lum + factor * (image - lum), 0.0, 1.0)


def batch_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of batch ``index``: keyed (seed, index) alone."""
    state = np.random.SeedSequence((seed, index)).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def robustness_sweep(
    dataloader_factory: Callable[[], object],
    predict_fn: Callable,
    equivalence_tensor,
    equiv_class_map,
    num_classes: int,
    brightness_levels: Sequence[float] = (1.0, 0.5, 0.2, 0.1, 0.05, 0.02,
                                          0.01),
    saturation_levels: Sequence[float] = (1.0,),
    seed: int = 0,
) -> List[Dict]:
    """Run the sweep; returns one result row per (brightness, saturation)."""
    et = torch.as_tensor(np.asarray(equivalence_tensor))
    ecm = torch.as_tensor(np.asarray(equiv_class_map))
    results = []
    for b in brightness_levels:
        for s in saturation_levels:
            acc = None
            for i, batch in enumerate(dataloader_factory()):
                image = np.stack(
                    [
                        enhance_saturation(enhance_brightness(img, b), s)
                        for img in batch["image"]
                    ]
                )
                pred = torch.as_tensor(predict_fn(batch_generator(seed, i),
                                                  batch, image))
                device = pred.device
                if acc is None:
                    acc = metrics_init(num_classes, device)
                # The reference SKIPS items with no non-zero GT labels
                # (segclip.py per-sample guard) — scoring them would count
                # every gt==0 pixel as a correct background prediction and
                # inflate accuracy, so weight them out alongside padding.
                seg_np = np.asarray(batch["segmentation"])
                has_gt = (seg_np != 0).any(axis=(1, 2)).astype(np.float32)
                weight = np.asarray(batch["sample_valid"], np.float32) * has_gt
                acc = metrics_update(
                    acc, pred, torch.as_tensor(seg_np).to(device),
                    et.to(device), ecm.to(device),
                    pixel_weight=torch.from_numpy(weight).to(device))
            row = metrics_finalize(acc if acc is not None
                                   else metrics_init(num_classes))
            row.update(brightness=b, saturation=s)
            results.append(row)
    return results


def plot_results(results: List[Dict], output_png: str) -> str:
    """Metric-vs-brightness curves per saturation level (the reference's
    matplotlib aggregation, segclip.py:463-516) -> PNG path."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_results needs the matplotlib package, which "
                          "is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = [
        ("pixel_accuracy_t1", "Top-1 pixel accuracy"),
        ("pixel_accuracy_tk", "Top-k pixel accuracy"),
        ("mIoU_t1", "Top-1 mIoU"),
        ("mIoU_tk", "Top-k mIoU"),
    ]
    sats = sorted({r["saturation"] for r in results})
    fig, axes = plt.subplots(1, len(metrics), figsize=(4.5 * len(metrics), 4))
    for ax, (key, title) in zip(np.atleast_1d(axes), metrics):
        for s in sats:
            rows = sorted(
                (r for r in results if r["saturation"] == s),
                key=lambda r: r["brightness"],
            )
            ax.plot(
                [r["brightness"] for r in rows],
                [r[key] for r in rows],
                marker="o",
                label=f"saturation {s:g}",
            )
        ax.set_xscale("log")
        ax.set_xlabel("brightness factor")
        ax.set_title(title)
        ax.set_ylim(0, 1)
        ax.grid(True, alpha=0.3)
    if len(sats) > 1:
        axes[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(output_png, dpi=120)
    plt.close(fig)
    return output_png


def format_results_table(results: List[Dict]) -> str:
    lines = [
        "brightness saturation  acc_t1  acc_tk  mIoU_t1  mIoU_tk",
    ]
    for r in results:
        lines.append(
            f"{r['brightness']:10.2f} {r['saturation']:10.2f} "
            f"{r['pixel_accuracy_t1']:7.4f} {r['pixel_accuracy_tk']:7.4f} "
            f"{r['mIoU_t1']:8.4f} {r['mIoU_tk']:8.4f}"
        )
    return "\n".join(lines)
