"""Present-classes reduction: ``present[c] = any(labels == c & valid > 0)``.

Port of ``rangeclip_tpu/ops/pallas/class_presence.py``
(``fused_class_presence``).  The CUDA kernel is ``csrc/class_presence.cu``:
one launch per call, which writes the bool output itself; its blocks meet
in a small workspace that the last block leaves zeroed: one per device and
stream for eager calls, one per call in a CUDA graph (zeroed by the graph),
so graphs replayed at once on other streams never share one.
:func:`class_presence_plain` is the same function in plain PyTorch, used for
CPU tensors and as the reference the kernel is held against on the card.
``valid=None`` means every label is valid (the all-ones vector JAX's callers
pass), and the kernel then reads the labels only.
"""

from __future__ import annotations

from typing import Optional

import torch

from rangeclip_tpu_torch.ops.kernels import _lib

# (device index, stream handle) -> int32 workspace [1 + words]: the
# kernel's ticket and bitmap words, zero between calls on that stream.
_workspaces: dict = {}


def class_presence_plain(labels: torch.Tensor, valid: Optional[torch.Tensor],
                         num_classes: int) -> torch.Tensor:
    hit = (labels >= 0) & (labels < num_classes)
    if valid is not None:
        hit &= valid > 0
    present = torch.zeros(num_classes, dtype=torch.bool, device=labels.device)
    present[labels[hit].long()] = True
    return present


def class_presence(labels: torch.Tensor, valid: Optional[torch.Tensor],
                   num_classes: int) -> torch.Tensor:
    """[C] bool: class c appears among the labels with ``valid > 0``.

    Args:
      labels: [N] int32 labels (values outside [0, C) never match).
      valid: [N] float32 validity weights, or None: every label is valid.
      num_classes: C.
    """
    kind = _lib.require_device("class_presence", labels,
                               *(() if valid is None else (valid,)))
    _lib.require(labels.dtype == torch.int32 and labels.dim() == 1
                 and labels.is_contiguous(),
                 "class_presence: labels must be contiguous int32 [N]")
    _lib.require(valid is None or (
        valid.dtype == torch.float32 and valid.shape == labels.shape
        and valid.is_contiguous()),
        "class_presence: valid must be None or contiguous float32 [N]")
    _lib.require(num_classes >= 1, "class_presence: num_classes must be >= 1")
    if kind == "cpu":
        return class_presence_plain(labels, valid, num_classes)
    return class_presence_op(labels, valid, num_classes)


def launch_name(valid: Optional[torch.Tensor]) -> str:
    """The launch count of the route: with a validity vector, or the
    labels only."""
    return "class_presence" if valid is not None else "class_presence[labels]"


def workspace(like: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The zeroed workspace of this call on ``like``'s device.  Eagerly, the
    current stream's, made (or grown) on first use there: calls on one
    stream run in turn.  Under CUDA-graph capture a new one, zeroed in the
    graph, which the graph keeps: graphs captured on one stream may be
    replayed at once on others (one graph's replays run in turn, as for
    any graph's memory)."""
    words = 1 + -(-num_classes // 32)
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(words, dtype=torch.int32, device=like.device)
    key = (like.device.index, _lib.stream_of(like))
    work = _workspaces.get(key)
    if work is None or work.numel() < words:
        work = torch.zeros(words, dtype=torch.int32, device=like.device)
        _workspaces[key] = work
    return work


def _class_presence_cuda(labels, valid, num_classes):
    out = torch.empty(num_classes, dtype=torch.bool, device=labels.device)
    code = _lib.library().rc_class_presence(
        labels.data_ptr(), None if valid is None else valid.data_ptr(),
        labels.numel(), num_classes, workspace(labels, num_classes).data_ptr(),
        out.data_ptr(), _lib.stream_of(labels))
    _lib.check(code, launch_name(valid))
    return out


class_presence_op = _lib.define_op(
    "class_presence(Tensor labels, Tensor? valid, int num_classes) -> Tensor",
    _class_presence_cuda, class_presence_plain,
    lambda labels, valid, num_classes: labels.new_empty(
        (num_classes,), dtype=torch.bool))
