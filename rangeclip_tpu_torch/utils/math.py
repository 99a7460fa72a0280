"""Small numerical helpers (``rangeclip_tpu/utils/math.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along ``dim``: ``F.normalize`` semantics."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)
