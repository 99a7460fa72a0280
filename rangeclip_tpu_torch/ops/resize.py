"""Spatial resizes with ``F.interpolate`` semantics (``rangeclip_tpu/ops/resize.py``).

NHWC in and out, like the JAX functions: nearest uses torch's floor index
rule idx = floor(dst * in / out); bilinear uses align_corners=True, or
half-pixel centres in :func:`resize_bilinear` (align_corners=False).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def nearest_indices(out_size: int, in_size: int,
                    device: torch.device) -> torch.Tensor:
    scale = in_size / out_size
    idx = torch.floor(torch.arange(out_size, dtype=torch.float32,
                                   device=device) * scale).long()
    return idx.clamp_(0, in_size - 1)


def upscale_factors(size_in: Tuple[int, int], size_out: Tuple[int, int]):
    """(k_h, k_w) where ``size_out`` is a whole multiple of ``size_in`` on
    both axes (a nearest resize is then k-fold repetition), else None."""
    (H_in, W_in), (H_out, W_out) = size_in, size_out
    if H_out % H_in == 0 and W_out % W_in == 0:
        return H_out // H_in, W_out // W_in
    return None


def nearest_rows_cols(size_in: Tuple[int, int], size_out: Tuple[int, int],
                      device: torch.device):
    """The input row of each output row and the input column of each
    output column of :func:`resize_nearest`."""
    k = upscale_factors(size_in, size_out)
    if k is not None:
        return (torch.arange(size_out[0], device=device) // k[0],
                torch.arange(size_out[1], device=device) // k[1])
    return (nearest_indices(size_out[0], size_in[0], device),
            nearest_indices(size_out[1], size_in[1], device))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC ``x`` [B, H, W, C] to ``size``
    (the rows and columns of :func:`nearest_rows_cols`), any dtype (label
    ids too)."""
    size_in = tuple(x.shape[1:3])
    if size_in == tuple(size):
        return x
    k = upscale_factors(size_in, size)
    if k is not None:  # the same rows and columns, repeated without a gather
        return x.repeat_interleave(k[0], dim=1).repeat_interleave(k[1], dim=2)
    rows, cols = nearest_rows_cols(size_in, size, x.device)
    return x[:, rows][:, :, cols]


def resize_bilinear_align_corners_nchw(x: torch.Tensor,
                                       size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of NCHW ``x``, computed in f32 and
    returned in ``x``'s dtype (the JAX function's precision)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    out = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                        align_corners=True)
    return out.to(x.dtype)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """NHWC form of :func:`resize_bilinear_align_corners_nchw`."""
    out = resize_bilinear_align_corners_nchw(x.permute(0, 3, 1, 2), size)
    return out.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` with half-pixel centres
    (align_corners=False, no antialiasing), computed in f32 and returned in
    ``x``'s dtype."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(size),
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)
