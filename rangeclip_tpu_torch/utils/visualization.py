"""Label colouring for previews (``rangeclip_tpu/utils/visualization.py``:
``label_colors`` and ``colorize_segmentation``; the matplotlib figures are
not ported)."""

from __future__ import annotations

import numpy as np


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
