"""Text-embedding providers (``rangeclip_tpu/models/clip/provider.py``).

Only the deterministic hash stub is ported so far; the real CLIP towers are
ROADMAP slice 4.  The stub is NOT CLIP: it gives every label a fixed
pseudo-random unit vector keyed by its text, so every path runs without
weights.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class HashTextEmbedder:
    """Deterministic pseudo-embeddings from label strings (TEST STUB); the
    same vectors as the JAX package's ``HashTextEmbedder``."""

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def __call__(self, labels: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(labels), self.dim), np.float32)
        for i, label in enumerate(labels):
            digest = hashlib.sha256(f"{self.seed}:{label}".encode()).digest()
            rng = np.random.default_rng(
                np.frombuffer(digest[:8], np.uint64)[0])
            v = rng.standard_normal(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out
