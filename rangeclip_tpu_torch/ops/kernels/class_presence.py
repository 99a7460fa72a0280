"""Present-classes reduction: ``present[c] = any(labels == c & valid > 0)``.

Port of ``rangeclip_tpu/ops/pallas/class_presence.py``
(``fused_class_presence``).  The CUDA kernel is ``csrc/class_presence.cu``;
:func:`class_presence_plain` is the same function in plain PyTorch, used for
CPU tensors and as the reference the kernel is held against on the card.
"""

from __future__ import annotations

import torch

from rangeclip_tpu_torch.ops.kernels import _lib


def class_presence_plain(labels: torch.Tensor, valid: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    hit = (valid > 0) & (labels >= 0) & (labels < num_classes)
    present = torch.zeros(num_classes, dtype=torch.bool, device=labels.device)
    present[labels[hit].long()] = True
    return present


def class_presence(labels: torch.Tensor, valid: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """[C] bool: class c appears among the labels with ``valid > 0``.

    Args:
      labels: [N] int32 labels (values outside [0, C) never match).
      valid: [N] float32 validity weights.
      num_classes: C.
    """
    kind = _lib.require_device("class_presence", labels, valid)
    _lib.require(labels.dtype == torch.int32 and labels.dim() == 1
                 and labels.is_contiguous(),
                 "class_presence: labels must be contiguous int32 [N]")
    _lib.require(valid.dtype == torch.float32
                 and valid.shape == labels.shape and valid.is_contiguous(),
                 "class_presence: valid must be contiguous float32 [N]")
    _lib.require(num_classes >= 1, "class_presence: num_classes must be >= 1")
    if kind == "cpu":
        return class_presence_plain(labels, valid, num_classes)
    return class_presence_op(labels, valid, num_classes)


def _class_presence_cuda(labels, valid, num_classes):
    out = torch.zeros(num_classes, dtype=torch.int32, device=labels.device)
    if labels.numel() == 0:
        return out.bool()
    code = _lib.library().rc_class_presence(
        labels.data_ptr(), valid.data_ptr(), labels.numel(), num_classes,
        out.data_ptr(), _lib.stream_of(labels))
    _lib.check(code, "class_presence")
    return out.bool()


class_presence_op = _lib.define_op(
    "class_presence(Tensor labels, Tensor valid, int num_classes) -> Tensor",
    _class_presence_cuda, class_presence_plain,
    lambda labels, valid, num_classes: labels.new_empty(
        (num_classes,), dtype=torch.bool))
