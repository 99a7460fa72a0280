"""Object crops for the area-image pathway (``rangeclip_tpu/models/clip/
crops.py``): the largest centred square inside each bbox, bilinearly
resampled to out_size x out_size on a half-pixel grid (CLIPProcessor's
resize-shortest-side + centre-crop), then CLIP normalisation.  Batched, on
the images' device."""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., 3] images in [0, 1] -> CLIP-normalised."""
    mean = images.new_tensor(CLIP_MEAN)
    std = images.new_tensor(CLIP_STD)
    return (images - mean) / std


def prepare_image_crops(images: torch.Tensor, bboxes: torch.Tensor,
                        out_size: int = 224,
                        normalize: bool = True) -> torch.Tensor:
    """images [B, H, W, 3] in [0, 1], bboxes [B, 4] int (xmin, ymin, xmax,
    ymax) -> [B, out_size, out_size, 3] f32."""
    x = images.float()
    B, H, W, _ = x.shape
    bb = bboxes.to(x.device)
    xmin, ymin, xmax, ymax = (bb[:, i] for i in range(4))
    side = torch.minimum((xmax - xmin).float(),
                         (ymax - ymin).float()).clamp_min(1.0)[:, None]
    cy = ((ymin.float() + ymax.float()) / 2.0)[:, None]
    cx = ((xmin.float() + xmax.float()) / 2.0)[:, None]
    t = ((torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5)
         / out_size - 0.5)[None, :]
    ys = cy + t * side - 0.5  # [B, S]
    xs = cx + t * side - 0.5
    y0 = torch.floor(ys).long().clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x0 = torch.floor(xs).long().clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (ys - y0.float())[:, :, None, None]
    wx = (xs - x0.float())[:, None, :, None]
    b = torch.arange(B, device=x.device)[:, None, None]
    at = lambda yy, xx: x[b, yy[:, :, None], xx[:, None, :]]  # noqa: E731
    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    crops = top * (1 - wy) + bot * wy
    return clip_normalize(crops) if normalize else crops
