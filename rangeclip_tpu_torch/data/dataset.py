"""Image/depth/segmentation dataset with per-sample random object selection
(``rangeclip_tpu/data/dataset.py``).

``metadata.csv`` rows name [image_path, depth_path, label_path] relative to
the file's directory (read with ``csv``).  PNGs decode through the native
C++ decoder (``native.decode_png_native``, byte-identical with PIL) where it
handles the file, through PIL otherwise or when ``RANGECLIP_NATIVE=off``;
PIL is imported only then.  Each sample draws one
foreground object from an explicit ``numpy.random.Generator``, so an
epoch's stream is reproducible given (seed, epoch, index); outputs are
numpy arrays in NHWC.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np

from rangeclip_tpu_torch.data.labels import load_candidate_labels
from rangeclip_tpu_torch.data.transforms import (
    depth_transform,
    image_transform,
    segmentation_transform,
)
from rangeclip_tpu_torch.native import decode_png_native


def open_gray(path: str) -> np.ndarray:
    """Integer grayscale (depth / label) image as an int32 2-D array, equal
    to ``np.asarray(Image.open(path).convert("I"))``; the native decoder
    first (data/dataset.py:47-57)."""
    arr = decode_png_native(path)
    if arr is not None and arr.ndim == 2:
        return arr.astype(np.int32)
    from PIL import Image

    with Image.open(path) as image:
        return np.asarray(image.convert("I"))


def open_rgb(path: str):
    """An RGB PIL image; the native decoder first (data/dataset.py:36-45)."""
    from PIL import Image

    arr = decode_png_native(path)
    if arr is not None and arr.dtype == np.uint8:
        image = Image.fromarray(arr)
        return image if arr.ndim == 3 else image.convert("RGB")
    with Image.open(path) as image:
        return image.convert("RGB")


class ImageDepthTextDataset:
    def __init__(self, metadata_file: str, labels_path: str,
                 resize_shape: Tuple[int, int], bbox_padding: int = 10):
        with open(metadata_file, newline="") as f:
            self.metadata = list(csv.DictReader(f))
        self.root_dir = os.path.dirname(metadata_file)
        self.resize_shape = tuple(resize_shape)
        self.bbox_padding = bbox_padding
        self.labels = load_candidate_labels(labels_path)
        self.label_to_index = {label: i for i, label in enumerate(self.labels)}

    def __len__(self) -> int:
        return len(self.metadata)

    def get_candidate_labels(self):
        return self.labels

    def _excluded_indices(self) -> set:
        excluded = {0}
        for name in ("background", "wall"):
            idx = self.label_to_index.get(name, -1)
            if idx != -1:
                excluded.add(idx)
        return excluded

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        if rng is None:
            rng = np.random.default_rng()
        row = self.metadata[idx]
        img = open_rgb(os.path.join(self.root_dir, row["image_path"]))
        depth = open_gray(os.path.join(self.root_dir, row["depth_path"]))
        seg = open_gray(os.path.join(self.root_dir, row["label_path"]))

        image_p = image_transform(img, self.resize_shape)
        depth_p = depth_transform(depth.astype(np.float32), self.resize_shape)
        seg_p = segmentation_transform(seg.astype(np.int32), self.resize_shape)
        bbox, label = choose_random_object(
            seg_p, len(self.labels), self._excluded_indices(),
            self.bbox_padding, rng)
        return {
            "depth": depth_p[..., None],  # [H, W, 1]
            "image": image_p,  # [H, W, 3]
            "segmentation": seg_p,  # [H, W]
            "object_bbox": np.asarray(bbox, np.int32),  # xmin, ymin, xmax, ymax
            "object_label": np.int32(label),
        }


def choose_random_object(seg: np.ndarray, num_labels: int, excluded: set,
                         bbox_padding: int, rng: np.random.Generator
                         ) -> Tuple[Tuple[int, int, int, int], int]:
    """Random foreground object and its bbox padded by ``bbox_padding`` px
    and clamped; the whole image with label 0 when there is none."""
    H, W = seg.shape
    bbox = (0, 0, W, H)
    label = 0
    unique = np.unique(seg)
    valid = np.array([u for u in unique
                      if u not in excluded and 0 < u < num_labels],
                     dtype=np.int64)
    if valid.size == 0:
        return bbox, label
    chosen = int(rng.choice(valid))
    ys, xs = np.nonzero(seg == chosen)
    if ys.size == 0:
        return bbox, label
    ymin, ymax = int(ys.min()), int(ys.max())
    xmin, xmax = int(xs.min()), int(xs.max())
    ymin_p = max(0, ymin - bbox_padding)
    xmin_p = max(0, xmin - bbox_padding)
    ymax_p = min(H, ymax + 1 + bbox_padding)
    xmax_p = min(W, xmax + 1 + bbox_padding)
    if xmax_p > xmin_p and ymax_p > ymin_p:
        return (xmin_p, ymin_p, xmax_p, ymax_p), chosen
    return bbox, label
