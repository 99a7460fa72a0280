"""Random patch generation (``rangeclip_tpu/setup_tools/cropping.py``, a
copy: plain numpy).

Reference: setup/generate_random_croppings.py (``FastPatchGenerator``:
random crops >= 64 px, pairwise overlap <= 0.3, <= 20 placement attempts,
:194-201) and setup/nyu_depth_v2/generate_random_cropped_patches.py (same
over NYUv2 .h5 with min 32 px and min-max depth normalization :94-103).
The generator is a pure function of (rng, image shape), so callers pick
their own parallelism.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Box = Tuple[int, int, int, int]  # (xmin, ymin, xmax, ymax)


def _overlap_ratio(a: Box, b: Box) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    return inter / area_a if area_a else 0.0


def crop_patch(image: np.ndarray, box: Box) -> np.ndarray:
    xmin, ymin, xmax, ymax = box
    return image[ymin:ymax, xmin:xmax]


class FastPatchGenerator:
    """Rejection-sampled random crop boxes with bounded mutual overlap."""

    def __init__(self, min_size: int = 64, max_overlap: float = 0.3,
                 max_attempts: int = 20, max_size: Optional[int] = None):
        self.min_size = min_size
        self.max_overlap = max_overlap
        self.max_attempts = max_attempts
        self.max_size = max_size

    def generate(self, rng: np.random.Generator, height: int, width: int,
                 n_patches: int) -> List[Box]:
        boxes: List[Box] = []
        limit = min(height, width)
        max_size = min(self.max_size or limit, limit)
        if max_size < self.min_size:
            return boxes
        for _ in range(n_patches):
            for _attempt in range(self.max_attempts):
                size = int(rng.integers(self.min_size, max_size + 1))
                x = int(rng.integers(0, width - size + 1))
                y = int(rng.integers(0, height - size + 1))
                box = (x, y, x + size, y + size)
                if all(_overlap_ratio(box, b) <= self.max_overlap
                       for b in boxes):
                    boxes.append(box)
                    break
        return boxes


def normalize_depth_min_max(depth: np.ndarray) -> np.ndarray:
    """NYUv2 depth -> uint8 via min-max scaling (reference :94-103)."""
    d = depth.astype(np.float32)
    lo, hi = float(d.min()), float(d.max())
    if hi - lo < 1e-12:
        return np.zeros_like(d, np.uint8)
    return ((d - lo) / (hi - lo) * 255.0).astype(np.uint8)
