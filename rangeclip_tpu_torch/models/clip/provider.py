"""Embedding providers: real CLIP towers or deterministic hash stubs
(``rangeclip_tpu/models/clip/provider.py``).

The trainer and the validator need two callables:
  * text: labels -> a [C, D] float32 numpy table, computed once;
  * image: [B, 224, 224, 3] CLIP-normalised crops -> [B, D] features.

``CLIP*Embedder`` run the port's towers on the device they are given, with
weights converted from an HF CLIP checkpoint (``convert.py``) or, for the
image tower, seeded random ones (``get_image_provider("random")``: the full
tower's cost and code path without a checkpoint).  ``Hash*Embedder`` are
test stubs for runs without weights; they are NOT CLIP: the text stub gives
every label a fixed pseudo-random unit vector keyed by its text, the image
stub a fixed random projection of the 8x8-average-pooled crop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from rangeclip_tpu_torch.models.clip.model import (
    CLIP_VIT_B32,
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
)
from rangeclip_tpu_torch.models.clip.tokenizer import CLIPTokenizer

RANDOM_SEED = 0  # the "random" image tower's weights


class TextEmbeddingProvider(Protocol):
    dim: int

    def __call__(self, labels: Sequence[str]) -> np.ndarray: ...


class ImageEmbeddingProvider(Protocol):
    dim: int

    def __call__(self, crops: torch.Tensor) -> torch.Tensor: ...


class CLIPTextEmbedder:
    """Batched frozen text-embedding precompute (train_util.py:203-226):
    labels in chunks of ``batch_size``, the last one padded by repeating
    its final label so that every call has one shape."""

    def __init__(self, tower: CLIPTextTower, tokenizer: CLIPTokenizer,
                 batch_size: int = 128):
        self.tower = tower.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.dim = tower.config.projection_dim
        self.batch_size = batch_size

    @torch.no_grad()
    def __call__(self, labels: Sequence[str]) -> np.ndarray:
        device = self.tower.text_projection.weight.device
        outs = []
        for i in range(0, len(labels), self.batch_size):
            chunk = list(labels[i:i + self.batch_size])
            n_real = len(chunk)
            chunk += [chunk[-1]] * (self.batch_size - n_real)
            ids = torch.from_numpy(self.tokenizer(chunk)).to(device)
            outs.append(self.tower(ids)[:n_real].float().cpu().numpy())
        return np.concatenate(outs, axis=0).astype(np.float32)


class CLIPImageEmbedder:
    """Frozen image tower on prepared crops (dataloader.py:274-284); runs
    on the tower's device and returns features there."""

    def __init__(self, tower: CLIPVisionTower):
        self.tower = tower.eval().requires_grad_(False)
        self.dim = tower.config.projection_dim

    @torch.no_grad()
    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        return self.tower(crops)


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


# One-deep conversion cache: the trainer builds the text and the image
# provider from the same checkpoint back to back; the file is read and
# split once.
_convert_cache: dict = {}


def _converted_checkpoint(checkpoint_path: str):
    from rangeclip_tpu_torch.models.clip.convert import (
        convert_clip_checkpoint,
    )

    key = os.path.abspath(checkpoint_path)
    if key not in _convert_cache:
        _convert_cache.clear()  # bound memory: one converted model at most
        _convert_cache[key] = convert_clip_checkpoint(checkpoint_path)
    return _convert_cache[key]


def _require_device(device: Optional[torch.device]) -> torch.device:
    if device is None:
        raise ValueError("a CLIP tower runs on the device its caller names: "
                         "pass device=")
    return torch.device(device)


def _tower(cls, state_dict, config: CLIPConfig,
           device: Optional[torch.device]):
    tower = cls(config, device=_require_device(device))
    tower.load_state_dict(state_dict, strict=True)
    return tower


def get_text_provider(checkpoint_path: Optional[str] = None,
                      vocab_path: Optional[str] = None,
                      merges_path: Optional[str] = None,
                      dim: int = 512, config: CLIPConfig = CLIP_VIT_B32,
                      device: Optional[torch.device] = None
                      ) -> TextEmbeddingProvider:
    """Real CLIP when the checkpoint, vocab and merges are all given (the
    tower on ``device``, which must be named), the hash stub otherwise."""
    if checkpoint_path and vocab_path and merges_path:
        text_sd, _ = _converted_checkpoint(checkpoint_path)
        return CLIPTextEmbedder(
            _tower(CLIPTextTower, text_sd, config, device),
            CLIPTokenizer(vocab_path, merges_path))
    return HashTextEmbedder(dim=dim)


def get_image_provider(checkpoint_path: Optional[str] = None,
                       dim: Optional[int] = None,
                       config: CLIPConfig = CLIP_VIT_B32,
                       device: Optional[torch.device] = None
                       ) -> ImageEmbeddingProvider:
    """``checkpoint_path="random"`` builds the real ViT-B/32 vision tower
    with seeded random weights; another path the tower converted from that
    checkpoint; none the hash stub.  For "random", ``dim`` widens only the
    default config's projection; a custom config keeps its own, and a
    ``dim`` that conflicts with it raises."""
    if checkpoint_path == "random":
        if config is CLIP_VIT_B32 and dim is not None \
                and config.projection_dim != dim:
            config = dataclasses.replace(config, projection_dim=dim)
        elif dim is not None and config.projection_dim != dim:
            raise ValueError(
                f"get_image_provider(checkpoint_path='random'): dim={dim} "
                f"conflicts with the supplied config's projection_dim="
                f"{config.projection_dim}; pass a matching dim (or omit it)")
        return CLIPImageEmbedder(CLIPVisionTower(
            config, device=_require_device(device),
            generator=torch.Generator().manual_seed(RANDOM_SEED)))
    if checkpoint_path:
        _, vision_sd = _converted_checkpoint(checkpoint_path)
        return CLIPImageEmbedder(
            _tower(CLIPVisionTower, vision_sd, config, device))
    return HashImageEmbedder(dim=512 if dim is None else dim)
