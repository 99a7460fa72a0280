"""Console/file logging + scalar summary writing (a copy of
``rangeclip_tpu/utils/logging.py``, pinned to it by a test).

Reference: utils/src/log_utils.py:7-30 (``log()`` console+file appender),
train_util.py:191-196 (dual train/val TensorBoard writers, rank-0 only),
log.py:177-237 (configuration banner).

TensorBoard is optional: ``ScalarWriter`` writes TB events when
``tensorboardX``/torch's SummaryWriter is importable and always maintains a
plain CSV (events.csv) so runs remain inspectable with zero dependencies.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Mapping, Optional


def log(message: str, filepath: Optional[str] = None, to_console: bool = True) -> None:
    """Print + append to a results file (log_utils.py:7-30)."""
    if to_console:
        print(message)
    if filepath:
        dirpath = os.path.dirname(filepath)
        if dirpath:
            os.makedirs(dirpath, exist_ok=True)
        with open(filepath, "a") as f:
            f.write(message + "\n")


class ScalarWriter:
    """Scalar summary writer: CSV always, TensorBoard when available."""

    def __init__(self, event_dir: str):
        os.makedirs(event_dir, exist_ok=True)
        self._csv_path = os.path.join(event_dir, "events.csv")
        self._csv_initialized = os.path.exists(self._csv_path)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(event_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self._csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if not self._csv_initialized:
                w.writerow(["wall_time", "step", "tag", "value"])
                self._csv_initialized = True
            w.writerow([f"{time.time():.3f}", step, tag, float(value)])
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, prefix: str, values: Mapping[str, float], step: int) -> None:
        for k, v in values.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def add_image(self, tag: str, image_hwc_uint8, step: int) -> None:
        """Qualitative image summary: PNG on disk always (images/<tag>_<step>.png),
        TensorBoard when available (the reference's per-sample grids,
        validate.py:140-146)."""
        import numpy as np

        img = np.asarray(image_hwc_uint8)
        img_dir = os.path.join(os.path.dirname(self._csv_path), "images")
        os.makedirs(img_dir, exist_ok=True)
        safe_tag = tag.replace("/", "_")
        try:
            from PIL import Image

            Image.fromarray(img).save(
                os.path.join(img_dir, f"{safe_tag}_{step:08d}.png")
            )
        except Exception as e:
            # surface the failure once instead of silently dropping every
            # qualitative summary for the run ("PNG on disk always")
            import warnings

            warnings.warn(f"add_image({tag!r}) failed to write PNG: {e}",
                          stacklevel=2)
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def log_configuration(log_path: Optional[str], config: Dict) -> None:
    """Config banner at training start (log.py:177-237)."""
    log("=" * 70, log_path)
    log("Training configuration", log_path)
    log("=" * 70, log_path)
    for key, value in config.items():
        log(f"  {key:32s}: {value}", log_path)
    log("=" * 70, log_path)


def log_training_summary(
    log_path: Optional[str],
    step: int,
    n_total_steps: int,
    start_step: int,
    loss: float,
    time_start: float,
) -> None:
    """Progress line with elapsed/remaining hours (train_util.py:475-486)."""
    elapsed_h = (time.time() - time_start) / 3600
    if step > start_step:
        remain_h = (n_total_steps - step + start_step) * elapsed_h / (step - start_step)
    else:
        remain_h = 0.0
    log(
        "Step={:6}/{}  Loss={:.7f}  Time Elapsed={:.2f}h  Time Remaining={:.2f}h".format(
            step, n_total_steps + start_step, loss, elapsed_h, remain_h
        ),
        log_path,
    )
