"""NYU Depth v2 ingestion (``rangeclip_tpu/setup_tools/nyu.py``).

Reference: setup/nyu_depth_v2/ —
  * generate_random_cropped_patches.py: random crops over .h5 files with
    rgb/depth keys, min 32 px, depth min-max -> uint8, metadata.csv with
    crop provenance (:40-56, 281-283, 415-428);
  * generate_cropped_patches_nyu.py: labeled .mat ingestion — per-object
    bboxes padded 20, crops resized 128x128 (bilinear image / nearest
    depth+label), metadata.csv [image, depth, object_id] (:10-92);
  * generate_csv_paths.py / combine_csv_files.py: metadata from directory
    intersections and merged metadata files.

PIL, h5py and scipy are imported by the functions that use them; nothing
here uses pandas (:func:`combine_metadata_csvs` merges with ``csv``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rangeclip_tpu_torch.data.transforms import resize_nearest_np
from rangeclip_tpu_torch.setup_tools.cropping import (
    FastPatchGenerator,
    normalize_depth_min_max,
)

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def load_nyu_h5(path: str, rgb_key: str = "rgb", depth_key: str = "depth"):
    """-> (rgb [H, W, 3] uint8, depth [H, W] float32) from an NYUv2 .h5."""
    import h5py

    with h5py.File(path, "r") as f:
        rgb = np.asarray(f[rgb_key])
        depth = np.asarray(f[depth_key], np.float32)
    if rgb.ndim == 3 and rgb.shape[0] == 3:  # CHW -> HWC
        rgb = np.transpose(rgb, (1, 2, 0))
    return rgb.astype(np.uint8), depth


def _is_hdf5(path: str) -> bool:
    """HDF5's signature at offset 0 or at a power of two from 512 (MATLAB
    v7.3 files keep a 512-byte header before it)."""
    with open(path, "rb") as f:
        head = f.read(2048 + len(_HDF5_SIGNATURE))
    return any(head[o:o + len(_HDF5_SIGNATURE)] == _HDF5_SIGNATURE
               for o in (0, 512, 1024, 2048))


def load_nyu_labeled_mat(path: str):
    """-> dict with images [N, H, W, 3], depths/labels [N, H, W] from the
    labeled NYUv2 .mat, normalized to sample-first row-major layout for
    BOTH storage formats (the consumers iterate samples on axis 0):

      * v7.3 (HDF5 via h5py) reads MATLAB's column-major arrays transposed
        — images arrive [N, 3, W, H] — and is untangled exactly like the
        reference (generate_cropped_patches_nyu.py:44-51);
      * pre-v7.3 (scipy.io.loadmat) keeps MATLAB order — images arrive
        [H, W, 3, N] — and needs the sample axis moved first (returning it
        raw would make callers iterate image ROWS as samples, silently
        emitting garbage patches).
    """
    if _is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as f:
            return {
                # [N, 3, W, H] -> [N, H, W, 3] (reference :48-51)
                "images": np.asarray(f["images"]).transpose(0, 3, 2, 1),
                "depths": np.asarray(f["depths"]).transpose(0, 2, 1),
                "labels": np.asarray(f["labels"]).transpose(0, 2, 1),
            }
    from scipy.io import loadmat

    m = loadmat(path)
    return {
        # [H, W, 3, N] -> [N, H, W, 3]
        "images": np.asarray(m["images"]).transpose(3, 0, 1, 2),
        "depths": np.asarray(m["depths"]).transpose(2, 0, 1),
        "labels": np.asarray(m["labels"]).transpose(2, 0, 1),
    }


def _write_rows(path: str, fieldnames: Sequence[str],
                rows: Sequence[Dict[str, str]]) -> str:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fieldnames))
        w.writeheader()
        for row in rows:
            w.writerow(row)
    return path


def generate_random_cropped_patches_h5(h5_paths: Sequence[str],
                                       output_dir: str,
                                       n_patches_per_image: int = 8,
                                       min_size: int = 32,
                                       seed: int = 0) -> str:
    """Random square crops from .h5 scenes; writes PNG pairs + metadata.csv
    with crop provenance."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    gen = FastPatchGenerator(min_size=min_size)
    rng = np.random.default_rng(seed)
    rows: List[Dict[str, str]] = []
    for path in h5_paths:
        rgb, depth = load_nyu_h5(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        boxes = gen.generate(rng, rgb.shape[0], rgb.shape[1],
                             n_patches_per_image)
        for i, (xmin, ymin, xmax, ymax) in enumerate(boxes):
            img_path = os.path.join(output_dir, f"{stem}_{i}_image.png")
            dep_path = os.path.join(output_dir, f"{stem}_{i}_depth.png")
            Image.fromarray(rgb[ymin:ymax, xmin:xmax]).save(img_path)
            Image.fromarray(
                normalize_depth_min_max(depth[ymin:ymax, xmin:xmax])
            ).save(dep_path)
            rows.append({
                "image_path": os.path.basename(img_path),
                "depth_path": os.path.basename(dep_path),
                "source": stem,
                "bbox": f"{xmin} {ymin} {xmax} {ymax}",
            })
    return _write_rows(os.path.join(output_dir, "metadata.csv"),
                       ["image_path", "depth_path", "source", "bbox"], rows)


def generate_labeled_patches(images: np.ndarray, depths: np.ndarray,
                             labels: np.ndarray, output_dir: str,
                             patch_size: Tuple[int, int] = (128, 128),
                             bbox_padding: int = 20) -> str:
    """Per-object crops from labeled NYUv2 arrays -> PNG triplets +
    metadata.csv [image, depth, object_id]."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    rows: List[Dict[str, str]] = []
    for idx in range(images.shape[0]):
        img = images[idx]
        if img.ndim == 3 and img.shape[0] == 3:
            img = np.transpose(img, (1, 2, 0))
        dep = depths[idx]
        lab = labels[idx]
        H, W = lab.shape
        for obj in np.unique(lab):
            if obj == 0:
                continue
            ys, xs = np.nonzero(lab == obj)
            xmin = max(0, int(xs.min()) - bbox_padding)
            ymin = max(0, int(ys.min()) - bbox_padding)
            xmax = min(W, int(xs.max()) + 1 + bbox_padding)
            ymax = min(H, int(ys.max()) + 1 + bbox_padding)
            img_c = Image.fromarray(
                img[ymin:ymax, xmin:xmax].astype(np.uint8)).resize(
                    (patch_size[1], patch_size[0]), Image.BILINEAR)
            dep_c = resize_nearest_np(dep[ymin:ymax, xmin:xmax], patch_size)
            img_path = os.path.join(output_dir, f"{idx}_{int(obj)}_image.png")
            dep_path = os.path.join(output_dir, f"{idx}_{int(obj)}_depth.png")
            img_c.save(img_path)
            Image.fromarray((dep_c * 256).astype(np.int32), mode="I").save(
                dep_path)
            rows.append({
                "image": os.path.basename(img_path),
                "depth": os.path.basename(dep_path),
                "object_id": str(int(obj)),
            })
    return _write_rows(os.path.join(output_dir, "metadata.csv"),
                       ["image", "depth", "object_id"], rows)


def combine_metadata_csvs(paths: Sequence[str], output_path: str) -> str:
    """Merge metadata CSVs (setup/nyu_depth_v2/combine_csv_files.py): the
    rows in file order under the union of the headers (first-seen order, a
    missing column left empty), every cell copied as it was read, lines
    ended with ``\\n`` as pandas' ``to_csv`` ends them.  The JAX package
    merges through pandas, which also re-types the cells (an integer
    column holding an empty cell is written as floats, ``1`` as ``1.0``)."""
    fieldnames: List[str] = []
    rows: List[Dict[str, str]] = []
    for path in paths:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            fieldnames += [n for n in reader.fieldnames or []
                           if n not in fieldnames]
            rows += list(reader)
    with open(output_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, restval="",
                           lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return output_path


def generate_csv_paths(image_dir: str, depth_dir: str,
                       label_dir: Optional[str], output_path: str) -> str:
    """metadata.csv from the intersection of per-modality directories
    (setup/nyu_depth_v2/generate_csv_paths.py).

    Rows carry each file's ACTUAL name (a .jpg image that stem-matches a
    .png depth map must not be written as '<stem>.png'), made relative to
    the metadata file's directory — the dataset resolves stored paths
    relative to dirname(metadata), so absolute/cwd-relative dir paths
    would break once the CSV moves.
    """
    def stem_map(d: str) -> Dict[str, str]:
        return {os.path.splitext(f)[0]: f for f in sorted(os.listdir(d))}

    imgs, deps = stem_map(image_dir), stem_map(depth_dir)
    stems = set(imgs) & set(deps)
    labs = stem_map(label_dir) if label_dir else {}
    if label_dir:
        stems &= set(labs)
    base = os.path.dirname(os.path.abspath(output_path))

    def rel(d: str, name: str) -> str:
        return os.path.relpath(os.path.join(os.path.abspath(d), name), base)

    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        header = ["image_path", "depth_path"] + (
            ["label_path"] if label_dir else [])
        w.writerow(header)
        for stem in sorted(stems):
            row = [rel(image_dir, imgs[stem]), rel(depth_dir, deps[stem])]
            if label_dir:
                row.append(rel(label_dir, labs[stem]))
            w.writerow(row)
    return output_path
