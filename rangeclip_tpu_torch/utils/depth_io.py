"""Depth map I/O and path-list utilities (``rangeclip_tpu/utils/depth_io.py``,
a copy: plain numpy and PIL).

Reference: utils/src/data_utils.py —
  * 16-bit PNG depth read/write with the /256 metric-depth convention and
    optional multiplier (:52-106);
  * validity maps (1 where depth > 0) (:108-141);
  * newline-delimited path-list files (:28-49, 143-156);
  * ViLD-JSON category-name extraction (:158-162).

PIL is imported by the functions that read or write an image, so importing
the module loads no PIL.
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


def load_depth(path: str, multiplier: float = 256.0) -> np.ndarray:
    """16-bit PNG -> metric depth float32 [H, W] (value / multiplier)."""
    from PIL import Image

    z = np.asarray(Image.open(path), np.float32)
    z = z / multiplier
    z[z <= 0] = 0.0
    return z


def save_depth(z: np.ndarray, path: str, multiplier: float = 256.0) -> None:
    """Metric depth -> 16-bit PNG (value * multiplier, clipped to uint16)."""
    from PIL import Image

    z = np.clip(np.asarray(z, np.float32) * multiplier, 0.0, 2**16 - 1)
    z = z.astype(np.uint16)
    Image.fromarray(z, mode="I;16").save(path)


def load_validity_map(path: str) -> np.ndarray:
    from PIL import Image

    v = np.asarray(Image.open(path), np.float32)
    return np.where(v > 0, 1.0, 0.0).astype(np.float32)


def validity_map_from_depth(z: np.ndarray) -> np.ndarray:
    return (np.asarray(z) > 0).astype(np.float32)


def read_paths(filepath: str) -> List[str]:
    """Newline-delimited path list (data_utils.py:28-49)."""
    paths = []
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if line:
                paths.append(line)
    return paths


def write_paths(filepath: str, paths: Sequence[str]) -> None:
    with open(filepath, "w") as f:
        for p in paths:
            f.write(p + "\n")


def load_vild_categories(json_path: str) -> List[str]:
    """Category names from a ViLD-style JSON (data_utils.py:158-162)."""
    with open(json_path) as f:
        data = json.load(f)
    return [c["name"] for c in data["categories"]]
