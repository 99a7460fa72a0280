"""Frozen CLIP towers (``rangeclip_tpu/models/clip/__init__.py``): the
towers (``model.py``), the HF checkpoint conversion (``convert.py``), the
BPE tokenizer (``tokenizer.py``), the embedding providers with their hash
stubs (``provider.py``) and the object crops (``crops.py``)."""

from rangeclip_tpu_torch.models.clip.crops import (
    clip_normalize,
    prepare_image_crops,
)
from rangeclip_tpu_torch.models.clip.model import (
    CLIP_VIT_B32,
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
)
from rangeclip_tpu_torch.models.clip.provider import (
    CLIPImageEmbedder,
    CLIPTextEmbedder,
    HashImageEmbedder,
    HashTextEmbedder,
    ImageEmbeddingProvider,
    TextEmbeddingProvider,
    get_image_provider,
    get_text_provider,
)

__all__ = [
    "CLIPConfig",
    "CLIPTextTower",
    "CLIPVisionTower",
    "CLIP_VIT_B32",
    "TextEmbeddingProvider",
    "ImageEmbeddingProvider",
    "CLIPTextEmbedder",
    "CLIPImageEmbedder",
    "HashTextEmbedder",
    "HashImageEmbedder",
    "get_text_provider",
    "get_image_provider",
    "prepare_image_crops",
    "clip_normalize",
]
