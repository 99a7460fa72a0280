"""SUN RGB-D label cleanup (``rangeclip_tpu/setup_tools/label_cleanup.py``).

Reference: setup/sunrgbd/cleanup_labels.py —
  * dedupe + lowercase label names, re-index alphabetically 1-based
    (:22-33);
  * remap every label PNG through the old->new index map (:54-82);
  * write a label-frequency CSV (:84-89).

PIL is imported by the functions that read or write a PNG.
"""

from __future__ import annotations

import csv
import os
import warnings
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np


def build_clean_label_map(raw_labels: Sequence[str]
                          ) -> Tuple[List[str], Dict[int, int]]:
    """Old 1-based labels -> deduped lowercase alphabetical 1-based labels.

    Returns (clean_labels, old_index -> new_index map); index 0 maps to 0.
    """
    lowered = [label.strip().lower() for label in raw_labels]
    clean = sorted(set(lowered))
    new_index = {label: i + 1 for i, label in enumerate(clean)}
    remap = {0: 0}
    for old_idx, label in enumerate(lowered, start=1):
        remap[old_idx] = new_index[label]
    return clean, remap


def remap_label_png(path: str, remap: Dict[int, int],
                    output_path: str) -> None:
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("I"))
    lut = np.zeros(max(remap.keys()) + 1, np.int32)
    for old, new in remap.items():
        lut[old] = new
    # Out-of-range indices are corrupt data: map them to 0 (unlabeled) with
    # a warning — clipping would silently relabel them as the
    # alphabetically-last real class.
    invalid = (arr < 0) | (arr >= len(lut))
    if invalid.any():
        warnings.warn(
            f"{path}: {int(invalid.sum())} pixels with label indices "
            f"outside [0, {len(lut) - 1}] mapped to 0 (unlabeled)",
            stacklevel=2)
    out = np.where(invalid, 0, lut[np.where(invalid, 0, arr)])
    Image.fromarray(out.astype(np.int32), mode="I").save(output_path)


def cleanup_labels(raw_labels: Sequence[str],
                   label_png_paths: Sequence[str], output_dir: str,
                   labels_csv: str, frequency_csv: str) -> List[str]:
    """Full pipeline: clean names, rewrite PNGs, labels CSV, frequency CSV."""
    from PIL import Image

    clean, remap = build_clean_label_map(raw_labels)
    os.makedirs(output_dir, exist_ok=True)

    counts: Counter = Counter()
    for path in label_png_paths:
        out_path = os.path.join(output_dir, os.path.basename(path))
        remap_label_png(path, remap, out_path)
        arr = np.asarray(Image.open(out_path).convert("I"))
        vals, cnts = np.unique(arr, return_counts=True)
        for v, c in zip(vals, cnts):
            counts[int(v)] += int(c)

    with open(labels_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label", "index"])
        for i, label in enumerate(clean, start=1):
            w.writerow([label, i])

    with open(frequency_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "label", "pixel_count"])
        for i, label in enumerate(clean, start=1):
            w.writerow([i, label, counts.get(i, 0)])
    return clean
