"""Image loading for the CLIs (``rangeclip_tpu/data/dataset.py``).

Only ``_open_gray``'s PIL path is ported (the JAX package tries its C++
PNG decoder first, which decodes to the same array); the dataset classes
come with the training slice.  PIL is imported when an image is opened.
"""

from __future__ import annotations

import numpy as np


def open_gray(path: str) -> np.ndarray:
    """Integer grayscale (depth / label) image as a 2-D array:
    ``np.asarray(Image.open(path).convert("I"))``."""
    from PIL import Image

    with Image.open(path) as image:
        return np.asarray(image.convert("I"))
