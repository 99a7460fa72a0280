"""Embedding providers (``rangeclip_tpu/models/clip/provider.py``).

Only the deterministic hash stubs are ported so far; the real CLIP towers
are ROADMAP slice 4.  The stubs are NOT CLIP: the text stub gives every
label a fixed pseudo-random unit vector keyed by its text, the image stub a
fixed random projection of the 8x8-average-pooled crop, so every path runs
without weights.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch


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


class HashImageEmbedder:
    """Deterministic pseudo-embeddings from crop content (TEST STUB): a
    fixed random projection [8*8*3, dim] of the 8x8-average-pooled crop.
    The JAX stub draws its projection from ``jax.random``; here it is an
    argument (the tests pass JAX's), by default drawn from a numpy seed."""

    def __init__(self, dim: int = 512, seed: int = 0,
                 projection: Optional[np.ndarray] = None):
        self.dim = dim
        if projection is None:
            projection = (np.random.default_rng(seed).standard_normal(
                (8 * 8 * 3, dim)) / np.sqrt(8 * 8 * 3)).astype(np.float32)
        if projection.shape != (8 * 8 * 3, dim):
            raise ValueError(f"projection must be [192, {dim}], got "
                             f"{projection.shape}")
        self.projection = torch.from_numpy(np.array(projection,
                                                    np.float32))

    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] crops (H, W multiples of 8) -> [B, dim] f32."""
        B, H, W, C = crops.shape
        pooled = crops.float().reshape(B, 8, H // 8, 8, W // 8, C).mean(
            dim=(2, 4))
        return pooled.reshape(B, -1) @ self.projection.to(crops.device)


def _require_stub(checkpoint_path: Optional[str]) -> None:
    if checkpoint_path:
        raise NotImplementedError(
            "real CLIP towers are not ported yet (ROADMAP slice 4, item 9): "
            "omit --clip_checkpoint_path to use the hash stubs")


def get_text_provider(checkpoint_path: Optional[str] = None,
                      vocab_path: Optional[str] = None,
                      merges_path: Optional[str] = None,
                      dim: int = 512) -> HashTextEmbedder:
    """The stub branch of the JAX function: the hash text embedder."""
    _require_stub(checkpoint_path)
    return HashTextEmbedder(dim=dim)


def get_image_provider(checkpoint_path: Optional[str] = None,
                       dim: Optional[int] = None) -> HashImageEmbedder:
    """The stub branch of the JAX function: the hash image embedder."""
    _require_stub(checkpoint_path)
    return HashImageEmbedder(dim=512 if dim is None else dim)
