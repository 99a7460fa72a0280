"""Label structures (``rangeclip_tpu/data/labels.py``): the candidate label
CSV, equivalence sets and tensor, similarity sets and matrices, the
equivalence class map.  The CSVs are read with the ``csv`` module; the list
cells (``"[1, 2]"``) with ``ast.literal_eval``, as JAX does.  Pinned to the
JAX functions by tests."""

from __future__ import annotations

import ast
import csv
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

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


def _rows(csv_path: str) -> List[Dict[str, str]]:
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f))


def load_equivalence_dict(csv_path: str) -> Dict[int, Set[int]]:
    """CSV columns [index, same] -> {index: set(same) | {index}}."""
    equivalence: Dict[int, Set[int]] = {}
    for row in _rows(csv_path):
        idx = int(row["index"])
        same = set(ast.literal_eval(row["same"]))
        same.add(idx)
        equivalence[idx] = same
    return equivalence


def build_equivalence_tensor(equivalence_dict: Dict[int, Set[int]],
                             num_classes: int) -> np.ndarray:
    """[C, C] bool lookup: equivalence[gt, pred]."""
    lookup = np.zeros((num_classes, num_classes), dtype=bool)
    for gt, equivalents in equivalence_dict.items():
        for pred in equivalents:
            lookup[gt, pred] = True
    return lookup


def load_label_similarity_sets(path: str, num_classes: int
                               ) -> Dict[str, List[List[int]]]:
    """CSV columns [index, medium, hard] -> per-class distractor lists."""
    medium: List[List[int]] = [[] for _ in range(num_classes)]
    hard: List[List[int]] = [[] for _ in range(num_classes)]
    for row in _rows(path):
        idx = int(row["index"])
        medium[idx] = ast.literal_eval(row["medium"])
        hard[idx] = ast.literal_eval(row["hard"])
    return {"medium": medium, "hard": hard}


def build_similarity_matrices(
    similarity_sets: Dict[str, Sequence[Sequence[int]]], num_classes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class lists -> [C, C] bool matrices (row l = similarity set of
    l); ids outside [0, C) are dropped."""
    out = []
    for key in ("medium", "hard"):
        m = np.zeros((num_classes, num_classes), dtype=bool)
        for label, members in enumerate(similarity_sets[key]):
            for member in members:
                if 0 <= member < num_classes:
                    m[label, member] = True
        out.append(m)
    return out[0], out[1]


def build_equivalence_class_map(equivalence_tensor: np.ndarray) -> np.ndarray:
    """label -> smallest index of its equivalence class; labels with empty
    rows map to themselves."""
    C = equivalence_tensor.shape[0]
    out = np.arange(C, dtype=np.int64)
    any_row = equivalence_tensor.any(axis=1)
    first = equivalence_tensor.argmax(axis=1)
    out[any_row] = first[any_row]
    return out
