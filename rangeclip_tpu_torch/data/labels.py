"""Candidate label CSV (``rangeclip_tpu/data/labels.py``), read with the
``csv`` module."""

from __future__ import annotations

import csv
from typing import List

DUMMY_LABEL = "unavailable"


def load_candidate_labels(labels_path: str) -> List[str]:
    """Load the label CSV; index 0 becomes the dummy 'unavailable' class.

    Contract: columns ``label`` and ``index``; indices 1-based, consecutive
    and unique."""
    with open(labels_path, newline="") as f:
        rows = [(int(row["index"]), row["label"])
                for row in csv.DictReader(f)]
    rows.sort(key=lambda r: r[0])
    actual = [i for i, _ in rows]
    if actual != list(range(1, len(rows) + 1)):
        raise ValueError(
            f"Indices in {labels_path} must be 1-based, consecutive, and "
            f"sorted. Found: {actual}")
    return [DUMMY_LABEL] + [label for _, label in rows]
