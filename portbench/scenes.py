"""The scene generator: indoor-like depth maps with their segmentation,
made on the device from a seed and a traffic mix's parameters.

The pattern is the repository's synthetic scenes
(``rangeclip_tpu_torch/data/synthetic.py``, frozen here): a floor plane
across the bottom ``floor_frac`` of the rows, Voronoi regions of random
points above it, one label per region, a depth plane per label (an evenly
spaced grid over ``depth_range``, shuffled once per seed) plus a
horizontal ramp and noise scaled to the grid spacing, each map divided by
its lower median.  What a mix sets:

* ``regions``: [lo, hi], the regions a map holds; the counts lo..hi are
  dealt out in turn over the maps of a pool and shuffled, so every seed
  makes the same amount of work;
* ``vocabulary``: the labels in use, 1..vocabulary (0 is reserved);
* ``zipf``: each region's label rank is drawn with probability
  proportional to 1 / rank ** zipf over the vocabulary; the floor takes
  rank 1.  The ranks of a pool's k-th batch are one fixed draw, the same
  for every seed, which the seed deals out over the regions and maps onto
  classes (a shuffle of the vocabulary, once per seed): every seed's
  batch holds as many distinct labels, so makes the same work.

Besides the maps: each map's object label (the label under a random pixel
above the floor), its image embedding (a random unit vector standing in
for the frozen CLIP image tower's) and the text table (random unit rows
standing in for CLIP ViT-B/32 text embeddings), and the [C, C] medium and
hard similarity sets (three random other classes per class each).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


class Vocabulary:
    """What one seed fixes for all of its scenes."""

    def __init__(self, mix: dict, num_classes: int, generator: torch.Generator,
                 device: torch.device):
        V = int(mix["vocabulary"])
        if not 1 <= V < num_classes:
            raise ValueError(f"vocabulary {V} outside 1..{num_classes - 1}")
        self.mix, self.device = mix, device
        ranks = torch.arange(1, V + 1, device=device, dtype=torch.float64)
        self.prob = ranks.pow(-float(mix["zipf"])).float()
        self.labels = 1 + torch.randperm(V, generator=generator,
                                         device=device)
        self.floor_label = int(self.labels[0])
        lo, hi = mix["depth_range"]
        grid = torch.linspace(lo, hi, num_classes, device=device)
        self.planes = grid[torch.randperm(num_classes, generator=generator,
                                          device=device)]
        spacing = (hi - lo) / max(num_classes - 1, 1)
        self.noise_sigma = min(20.0, 0.12 * spacing)
        self.ramp = min(200.0, 0.2 * spacing)


def region_counts(n: int, lo: int, hi: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    counts = lo + torch.arange(n, device=device) % (hi - lo + 1)
    return counts[torch.randperm(n, generator=generator, device=device)]


RANKS_SEED = 0x5CE4E  # the fixed stream of label ranks


def make_scenes(vocab: Vocabulary, n: int, shape, generator: torch.Generator,
                index: int = 0, chunk: int = 16) -> Dict[str, torch.Tensor]:
    """The ``index``-th batch of ``n`` maps: depth [n, H, W, 1] f32
    (median-normalised), segmentation [n, H, W] int32, object_label [n]
    int32."""
    mix, device = vocab.mix, vocab.device
    H, W = shape
    n_floor = max(int(round(H * float(mix["floor_frac"]))), H // 2 + 1)
    top = H - n_floor
    lo, hi = mix["regions"]
    counts = region_counts(n, int(lo), int(hi), generator, device)
    points = torch.rand(n, hi, 2, generator=generator, device=device) \
        * torch.tensor([top, W], device=device, dtype=torch.float32)
    unused = torch.arange(hi, device=device)[None, :] >= counts[:, None]
    fixed = torch.Generator(device=device).manual_seed(RANKS_SEED + index)
    used = int(counts.sum())
    ranks = torch.multinomial(vocab.prob, used, replacement=True,
                              generator=fixed)
    ranks = ranks[torch.randperm(used, generator=generator, device=device)]
    labels = torch.full((n, hi), vocab.floor_label, dtype=torch.int32,
                        device=device)
    labels[~unused] = vocab.labels[ranks].to(torch.int32)
    noise = torch.randn(n, H, W, generator=generator, device=device)
    pick = torch.rand(n, 2, generator=generator, device=device)
    yy, xx = torch.meshgrid(torch.arange(top, device=device,
                                         dtype=torch.float32),
                            torch.arange(W, device=device,
                                         dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([yy, xx], -1).reshape(1, -1, 1, 2)
    seg = torch.empty(n, H, W, dtype=torch.int32, device=device)
    seg[:, top:] = vocab.floor_label
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        d2 = (coords - points[a:b, None]).square().sum(-1)
        d2 = d2.masked_fill(unused[a:b, None], math.inf)
        nearest = d2.argmin(-1)
        seg[a:b, :top] = labels[a:b].gather(1, nearest).reshape(b - a, top,
                                                                W)
    ramp = torch.linspace(0.0, vocab.ramp, W, device=device)[None, None, :]
    depth = (vocab.planes[seg.long()] + ramp
             + vocab.noise_sigma * noise).clamp_min(1.0)
    flat = depth.reshape(n, -1)
    median = flat.sort(dim=1).values[:, (flat.shape[1] - 1) // 2]
    depth = torch.where(median.abs()[:, None, None] < 1e-6,
                        torch.zeros_like(depth),
                        depth / median[:, None, None])
    rows = (pick[:, 0] * top).long().clamp_max(top - 1)
    cols = (pick[:, 1] * W).long().clamp_max(W - 1)
    obj = seg[torch.arange(n, device=device), rows, cols]
    return {"depth": depth[..., None].contiguous(), "segmentation": seg,
            "object_label": obj.contiguous()}


def unit_rows(n: int, d: int, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    return F.normalize(torch.randn(n, d, generator=generator, device=device),
                       dim=-1)


def similarity_sets(num_classes: int, per_class: int,
                    generator: torch.Generator, device: torch.device
                    ) -> torch.Tensor:
    """[C, C] bool: ``per_class`` random other classes in each row."""
    noise = torch.rand(num_classes, num_classes, generator=generator,
                       device=device)
    noise.fill_diagonal_(-1.0)
    top = noise.topk(per_class, dim=1).indices
    out = torch.zeros(num_classes, num_classes, dtype=torch.bool,
                      device=device)
    return out.scatter_(1, top, True)


def gumbel(num_classes: int, generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    u = torch.rand(num_classes, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def pixel_draws(n: int, shape, percent: float, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """[n, int(percent * H * W)] int32 pixel indices, with replacement."""
    H, W = shape
    k = max(min(int(percent * H * W), H * W), 1)
    return torch.randint(0, H * W, (n, k), generator=generator,
                         device=device, dtype=torch.int32)
