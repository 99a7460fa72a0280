"""Pseudo-ground-truth generation from open-vocabulary detection
(``rangeclip_tpu/setup_tools/pseudo_ground_truth.py``).

Reference: setup/generate_pseudo_ground_truth.py — runs YOLO-World
(``yolov8x-worldv2.pt``) over an image list with the LVIS class vocabulary,
applies a custom CROSS-CLASS NMS at IoU 0.5 (:46-80), and writes per-image
``cls x y w h conf`` text files (:139-147).

The detector is pluggable (``detect_fn: image -> [N, 6] array of
(cls, x, y, w, h, conf) in normalized xywh``): :func:`ultralytics_detect_fn`
adapts ultralytics' YOLO-World where that package and local weights are
installed; the NMS and the files are plain numpy.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def cross_class_nms(detections: np.ndarray,
                    iou_threshold: float = 0.5) -> np.ndarray:
    """Greedy NMS that suppresses across classes (reference :46-80).

    detections: [N, 6] rows (cls, x, y, w, h, conf), xywh normalized.
    Returns the surviving rows sorted by confidence descending.
    """
    if len(detections) == 0:
        return detections.reshape(0, 6)
    order = np.argsort(-detections[:, 5])
    dets = detections[order]
    keep: List[int] = []
    for i in range(len(dets)):
        box_i = dets[i, 1:5]
        if all(_iou_xywh(box_i, dets[j, 1:5]) <= iou_threshold
               for j in keep):
            keep.append(i)
    return dets[keep]


def write_detection_file(path: str, detections: np.ndarray) -> None:
    """Per-image ``cls x y w h conf`` lines (reference :139-147)."""
    with open(path, "w") as f:
        for row in detections:
            cls = int(row[0])
            f.write(f"{cls} {row[1]:.6f} {row[2]:.6f} {row[3]:.6f} "
                    f"{row[4]:.6f} {row[5]:.6f}\n")


def read_detection_file(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 6:
                rows.append([float(p) for p in parts])
    return np.asarray(rows, np.float32).reshape(-1, 6)


def generate_pseudo_ground_truth(image_paths: Sequence[str],
                                 detect_fn: Callable[[str], np.ndarray],
                                 output_dir: str,
                                 iou_threshold: float = 0.5) -> List[str]:
    """Run detection + cross-class NMS over an image list; one txt per
    image."""
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    for path in image_paths:
        detections = cross_class_nms(np.asarray(detect_fn(path), np.float32),
                                     iou_threshold)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(output_dir, f"{stem}.txt")
        write_detection_file(out, detections)
        outputs.append(out)
    return outputs


def ultralytics_detect_fn(weights_path: str = "yolov8x-worldv2.pt",
                          class_names: Optional[Sequence[str]] = None,
                          device: Optional[str] = None):
    """Adapter: ultralytics YOLO-World -> ``detect_fn`` for
    :func:`generate_pseudo_ground_truth` (reference :83-147): local weights
    only, an optional open-vocabulary class list via ``model.set_classes``,
    normalized xywh + confidence per box.  The cross-class NMS is applied
    downstream by :func:`generate_pseudo_ground_truth`, as the reference
    separates ``model.predict`` from ``cross_class_nms``.

    Returns ``detect_fn(image_path) -> [N, 6] (cls, x, y, w, h, conf)``.
    """
    try:
        from ultralytics import YOLO
    except ImportError as e:
        raise ImportError(
            "the YOLO-World detection stage needs the 'ultralytics' package "
            "and local weights; run pseudo-gt with --detections_glob over "
            "existing detector dumps instead") from e

    model = YOLO(weights_path)
    if class_names:
        model.set_classes(list(class_names))

    def detect_fn(image_path: str) -> np.ndarray:
        kwargs = {"device": device} if device else {}
        results = model.predict(source=[image_path], save_txt=False,
                                verbose=False, save_conf=True, **kwargs)
        rows = []
        for box in results[0].boxes:
            x, y, w, h = (float(v) for v in box.xywhn[0][:4])
            rows.append([float(int(box.cls)), x, y, w, h,
                         float(box.conf[0])])
        return np.asarray(rows, np.float32).reshape(-1, 6)

    return detect_fn
