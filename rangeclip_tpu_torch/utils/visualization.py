"""Label colouring and prediction grids (a copy of
``rangeclip_tpu/utils/visualization.py``: ``apply_colormap``,
``label_colors``, ``colorize_segmentation``, ``prediction_grid``; pinned to
it by a test).  Host-side numpy; the grids draw with matplotlib, imported
when a grid is drawn."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def apply_colormap(x: np.ndarray, colormap: str = "viridis") -> np.ndarray:
    """Normalize a [H, W] array to [0,1] and map through a colormap ->
    [H, W, 3] float (log_utils.py:32-77)."""
    import matplotlib

    arr = np.asarray(x, np.float32)
    lo, hi = float(np.nanmin(arr)), float(np.nanmax(arr))
    norm = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
    return np.asarray(matplotlib.colormaps[colormap](norm))[..., :3]


def label_colors(num_classes: int, seed: int = 0) -> np.ndarray:
    """Stable per-class colors [C, 3]; class 0 is black."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.15, 0.95, size=(num_classes, 3))
    colors[0] = 0.0
    return colors


def colorize_segmentation(seg: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """[H, W] ids -> [H, W, 3] colors; out-of-range ids take the nearest
    end of the table (-1, no candidate, is class 0's black)."""
    return colors[np.clip(seg, 0, len(colors) - 1)]


def prediction_grid(
    depth: np.ndarray,
    image: Optional[np.ndarray],
    gt_seg: np.ndarray,
    pred_seg: np.ndarray,
    candidate_labels: Sequence[str],
    max_legend: int = 12,
) -> np.ndarray:
    """One sample's [depth | image | GT | prediction] panel with a legend of
    the labels present (log.py:390-478) -> [H, W, 3] uint8."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    colors = label_colors(len(candidate_labels))
    panels = [("Depth", apply_colormap(np.squeeze(depth)))]
    if image is not None:
        panels.append(("Image", np.clip(image, 0, 1)))
    panels.append(("Ground truth", colorize_segmentation(gt_seg, colors)))
    panels.append(("Prediction", colorize_segmentation(pred_seg, colors)))

    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4.4))
    for ax, (title, img) in zip(np.atleast_1d(axes), panels):
        ax.imshow(img)
        ax.set_title(title)
        ax.axis("off")

    present = [int(l) for l in np.unique(np.concatenate([gt_seg.ravel(),
                                                         pred_seg.ravel()]))]
    handles = [mpatches.Patch(color=colors[l], label=candidate_labels[l])
               for l in present[:max_legend]
               if 0 <= l < len(candidate_labels)]
    if handles:
        fig.legend(handles=handles, loc="lower center",
                   ncol=min(len(handles), 6), fontsize=8)
    fig.tight_layout(rect=(0, 0.08, 1, 1))

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf
