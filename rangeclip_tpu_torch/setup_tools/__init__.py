"""Offline data-prep pipeline (``rangeclip_tpu/setup_tools/``, the
reference's ``setup/`` scripts).

Host-CPU numpy/PIL tools that produce the CSV/PNG artifacts the data layer
consumes, plus the CLIP-text similarity-set generator, whose embedding pass
runs on the card with the real text tower.  PIL, h5py, scipy and
ultralytics are imported by the functions that use them.
"""

from rangeclip_tpu_torch.setup_tools.similarity_sets import (
    generate_label_similarity_sets,
)
from rangeclip_tpu_torch.setup_tools.label_cleanup import cleanup_labels
from rangeclip_tpu_torch.setup_tools.cropping import (
    FastPatchGenerator,
    crop_patch,
)
from rangeclip_tpu_torch.setup_tools.pseudo_ground_truth import (
    cross_class_nms,
    generate_pseudo_ground_truth,
)
from rangeclip_tpu_torch.setup_tools.patches import (
    select_balanced_classes,
    generate_detection_patches,
)

__all__ = [
    "generate_label_similarity_sets",
    "cleanup_labels",
    "FastPatchGenerator",
    "crop_patch",
    "cross_class_nms",
    "generate_pseudo_ground_truth",
    "select_balanced_classes",
    "generate_detection_patches",
]
