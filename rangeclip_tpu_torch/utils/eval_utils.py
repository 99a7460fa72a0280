"""Numpy evaluation helpers (``rangeclip_tpu/utils/eval_utils.py``, a copy).

Reference: utils/src/eval_utils.py — a numpy InfoNCE (used for offline
sanity checks; NOTE the reference scores RAW dot products, no
normalization, default temperature 0.1 — eval_utils.py:3-31) and classic
depth-estimation error metrics: RMSE, MAE and inverse-RMSE computed on
1/depth (eval_utils.py:34-77).  ``inv_mean_abs_err`` is an addition in the
same 1/depth convention.
"""

from __future__ import annotations

import numpy as np


def info_nce_np(
    embeddings: np.ndarray, targets: np.ndarray, temperature: float = 0.1
) -> float:
    """Diagonal-label InfoNCE on raw dot-product similarities
    (eval_utils.py:3-31 — the reference does NOT L2-normalize here; pass
    pre-normalized embeddings for cosine scoring)."""
    logits = embeddings @ targets.T / temperature
    logits = logits - logits.max(axis=1, keepdims=True)
    log_probs = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return float(-np.mean(np.diagonal(log_probs)))


def root_mean_sq_err(src: np.ndarray, tgt: np.ndarray) -> float:
    return float(np.sqrt(np.mean((tgt - src) ** 2)))


def mean_abs_err(src: np.ndarray, tgt: np.ndarray) -> float:
    return float(np.mean(np.abs(tgt - src)))


def inv_root_mean_sq_err(src: np.ndarray, tgt: np.ndarray) -> float:
    """iRMSE on inverse depth (eval_utils.py:64-77)."""
    return float(np.sqrt(np.mean((1.0 / tgt - 1.0 / src) ** 2)))


def inv_mean_abs_err(src: np.ndarray, tgt: np.ndarray) -> float:
    """iMAE on inverse depth (same convention as iRMSE; not in the
    reference, kept for the standard depth-metric quartet)."""
    return float(np.mean(np.abs(1.0 / tgt - 1.0 / src)))
