"""Sample transforms (``rangeclip_tpu/data/transforms.py``).  Depth:
nearest resize with torch's index rule idx = floor(i * in / out), then
normalisation by the lower median (torch.median's choice for even counts),
or zeros when the median is below 1e-6 in magnitude.  Image: PIL bilinear
resize to [0, 1] f32.  Segmentation: nearest resize.

Depth and segmentation take the native C++ path (``native``) as JAX does,
the numpy path when ``RANGECLIP_NATIVE=off``.  The native depth transform
multiplies by 1/median where the numpy one divides: the two can differ by
one ulp, and each is held bit for bit against its JAX counterpart only.
PIL is imported inside the function that uses it."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rangeclip_tpu_torch.native import (
    depth_transform_native,
    segmentation_resize_native,
)


def _nearest_idx(out_size: int, in_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W(, C)] nearest resize."""
    H_out, W_out = size
    if x.shape[:2] == (H_out, W_out):
        return x
    return x[_nearest_idx(H_out, x.shape[0])][:, _nearest_idx(W_out,
                                                              x.shape[1])]


def lower_median_np(x: np.ndarray) -> float:
    flat = np.sort(x.reshape(-1))
    return float(flat[(flat.size - 1) // 2])


def depth_transform(depth: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """depth [H, W] -> float32 [H, W] at ``size``, median-normalised."""
    native = depth_transform_native(depth, size)
    if native is not None:
        return native
    resized = resize_nearest_np(depth.astype(np.float32), size)
    median = lower_median_np(resized)
    if abs(median) < 1e-6:
        return np.zeros_like(resized)
    return resized / median


def image_transform(image, size: Tuple[int, int]) -> np.ndarray:
    """PIL image (or an [H, W, 3] array) -> bilinear resize to (H, W),
    float32 [H, W, 3] in [0, 1]."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        image = Image.fromarray(arr)
    H, W = size
    resized = image.convert("RGB").resize((W, H), Image.BILINEAR)
    return np.asarray(resized, dtype=np.float32) / 255.0


def segmentation_transform(seg: np.ndarray, size: Tuple[int, int]
                           ) -> np.ndarray:
    """Nearest resize of an integer label map, int32."""
    native = segmentation_resize_native(np.asarray(seg), size)
    if native is not None:
        return native
    return resize_nearest_np(np.asarray(seg), size).astype(np.int32)
