"""Synthetic depth-segmentation fixtures for tests, benchmarks, and
convergence runs (a copy of ``rangeclip_tpu/data/synthetic.py``, pinned to
it by a test; PIL is imported by the on-disk writer only).

Generates structured indoor-like scenes: a dominant floor plane across the
bottom of the image plus Voronoi regions of random seed points in the upper
part, one label per region, per-label depth planes + noise.  An optional
on-disk writer produces the exact PNG/CSV layout the real SUN RGB-D
pipeline consumes (metadata.csv, candidate_labels.csv,
label_similarity_sets.csv) — giving an end-to-end path identical to
training on real data.

Learnability contract (``consistent=True``, the default): the label→depth
mapping must survive BOTH of the pipeline's normalizations so that a
depth-only model can generalize across scenes —

  1. **Cross-sample consistency.**  The per-label depth planes and colors
     are drawn ONCE per dataset (from ``seed``), not per sample.  (The
     round-3 generator drew them per sample, which made labels independent
     of depth across the dataset — a depth-only model could not beat
     chance on held-out scenes, and the round-3 convergence run duly sat
     at chance.  ``consistent=False`` restores that behavior for
     comparison.)
  2. **Median anchoring.**  ``depth_transform`` divides each map by its
     median (dataloader.py:49-54 semantics).  The floor plane covers
     ``floor_frac`` > 0.5 of the pixels, so the median is pinned to the
     floor's plane value and the normalized value of label *l* is the
     deterministic ratio ``plane[l] / plane[floor]`` in every scene.
  3. **Noise scaled to class spacing.**  Depth planes are an evenly spaced
     (then shuffled) grid over [1000, 4000]; per-pixel noise and the
     horizontal gradient shrink with the grid spacing so adjacent classes
     stay separable at any ``num_classes`` (including the int32-mm
     quantization of the on-disk PNG writer).

The JAX package's tests assert the end product: a nearest-plane
classifier on the *normalized* depth recovers the segmentation across
samples.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from rangeclip_tpu_torch.data.dataset import choose_random_object
from rangeclip_tpu_torch.data.transforms import depth_transform


def _voronoi_segmentation(
    rng: np.random.Generator, shape: Tuple[int, int], n_regions: int, num_classes: int
) -> np.ndarray:
    H, W = shape
    pts = rng.uniform(0, 1, size=(n_regions, 2)) * np.array([H, W])
    labels = rng.integers(1, num_classes, size=n_regions)
    yy, xx = np.mgrid[0:H, 0:W]
    coords = np.stack([yy, xx], -1).reshape(-1, 2).astype(np.float32)
    d2 = ((coords[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nearest = d2.argmin(1)
    return labels[nearest].reshape(H, W).astype(np.int32)


class SyntheticDepthSegDataset:
    """In-memory dataset mimicking ImageDepthTextDataset's output contract."""

    def __init__(
        self,
        n_samples: int = 32,
        resize_shape: Tuple[int, int] = (64, 64),
        num_classes: int = 16,
        n_regions: int = 6,
        seed: int = 0,
        bbox_padding: int = 10,
        consistent: bool = True,
        floor_frac: float = 0.55,
    ):
        self.n_samples = n_samples
        self.resize_shape = resize_shape
        self.num_classes = num_classes
        self.n_regions = n_regions
        self.seed = seed
        self.bbox_padding = bbox_padding
        self.consistent = consistent
        self.floor_frac = floor_frac
        self.labels = ["unavailable"] + [f"object_{i}" for i in range(1, num_classes)]

        if consistent and num_classes < 2:
            raise ValueError(
                "consistent synthetic scenes need num_classes >= 2 (index 0 "
                "is the reserved 'unavailable' slot and never appears in "
                f"segmentation maps); got {num_classes}")
        if consistent:
            ds_rng = np.random.default_rng((seed, 0xD5))
            grid = np.linspace(1000.0, 4000.0, max(num_classes, 2), dtype=np.float32)
            # Shuffle so label index order carries no depth information;
            # index 0 ("unavailable") never appears in seg.
            self.depth_planes = ds_rng.permutation(grid[:num_classes])
            self.colors = ds_rng.uniform(0, 1, size=(num_classes, 3)).astype(np.float32)
            self.floor_label = int(ds_rng.integers(1, num_classes))
            spacing = 3000.0 / max(num_classes - 1, 1)
            self.noise_sigma = float(min(20.0, 0.12 * spacing))
            self.grad_amp = float(min(200.0, 0.2 * spacing))
        else:
            self.depth_planes = None
            self.colors = None
            self.floor_label = None
            self.noise_sigma = 20.0
            self.grad_amp = 200.0

    def __len__(self) -> int:
        return self.n_samples

    def get_candidate_labels(self):
        return self.labels

    def _generate(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        H, W = self.resize_shape
        if self.consistent:
            n_floor = max(int(round(H * self.floor_frac)), H // 2 + 1)
            seg_top = _voronoi_segmentation(
                rng, (H - n_floor, W), self.n_regions, self.num_classes
            )
            seg = np.concatenate(
                [seg_top,
                 np.full((n_floor, W), self.floor_label, np.int32)], axis=0
            )
            base = self.depth_planes
            colors = self.colors
        else:
            seg = _voronoi_segmentation(rng, self.resize_shape, self.n_regions,
                                        self.num_classes)
            base = rng.uniform(500, 5000, size=self.num_classes).astype(np.float32)
            colors = rng.uniform(0, 1, size=(self.num_classes, 3)).astype(np.float32)
        # depth: per-label plane + gradient + noise
        grad = np.linspace(0, self.grad_amp, W, dtype=np.float32)[None, :]
        depth = (base[seg] + grad
                 + rng.normal(0, self.noise_sigma, size=(H, W)).astype(np.float32))
        depth = np.maximum(depth, 1.0)
        # image: per-label color + noise
        image = np.clip(
            colors[seg] + rng.normal(0, 0.05, size=(H, W, 3)).astype(np.float32), 0, 1
        )
        return depth, image, seg

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        if rng is None:
            rng = np.random.default_rng((self.seed, idx, 7))
        depth, image, seg = self._generate(idx)
        depth_p = depth_transform(depth, self.resize_shape)
        bbox, label = choose_random_object(
            seg, self.num_classes, {0}, self.bbox_padding, rng
        )
        return {
            "depth": depth_p[..., None].astype(np.float32),
            "image": image,
            "segmentation": seg,
            "object_bbox": np.asarray(bbox, np.int32),
            "object_label": np.int32(label),
        }


def write_synthetic_dataset(
    root: str,
    n_samples: int = 16,
    shape: Tuple[int, int] = (64, 64),
    num_classes: int = 10,
    seed: int = 0,
    **dataset_kwargs,
) -> Dict[str, str]:
    """Write a tiny on-disk dataset in the reference's SUN RGB-D layout:
    PNG triplets + metadata.csv + candidate_labels.csv +
    label_similarity_sets.csv (with 'same'/'medium'/'hard' columns).

    Extra ``dataset_kwargs`` (n_regions, consistent, floor_frac, ...) pass
    through to SyntheticDepthSegDataset.  Returns paths
    {metadata, labels, similarity}.
    """
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    ds = SyntheticDepthSegDataset(n_samples, shape, num_classes, seed=seed,
                                  **dataset_kwargs)
    rows = []
    for i in range(n_samples):
        depth, image, seg = ds._generate(i)
        img_path, dep_path, seg_path = (
            f"image_{i}.png", f"depth_{i}.png", f"label_{i}.png",
        )
        Image.fromarray((image * 255).astype(np.uint8)).save(os.path.join(root, img_path))
        Image.fromarray(np.rint(depth).astype(np.int32), mode="I").save(
            os.path.join(root, dep_path))
        Image.fromarray(seg.astype(np.int32), mode="I").save(os.path.join(root, seg_path))
        rows.append((img_path, dep_path, seg_path))

    metadata = os.path.join(root, "metadata.csv")
    with open(metadata, "w") as f:
        f.write("image_path,depth_path,label_path\n")
        for r in rows:
            f.write(",".join(r) + "\n")

    labels_csv = os.path.join(root, "candidate_labels.csv")
    with open(labels_csv, "w") as f:
        f.write("label,index\n")
        for i in range(1, num_classes):
            f.write(f"object_{i},{i}\n")

    rng = np.random.default_rng(seed + 1)
    sim_csv = os.path.join(root, "label_similarity_sets.csv")
    with open(sim_csv, "w") as f:
        f.write("index,same,medium,hard\n")
        for i in range(num_classes):
            others = [j for j in range(1, num_classes) if j != i]
            med = sorted(rng.choice(others, size=min(3, len(others)),
                                    replace=False).tolist())
            hard = sorted(rng.choice(others, size=min(3, len(others)),
                                     replace=False).tolist())
            f.write(f'{i},"[]","{med}","{hard}"\n')

    return {"metadata": metadata, "labels": labels_csv, "similarity": sim_csv}
