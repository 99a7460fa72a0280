"""Exact per-row histogram of draw indices:
``counts[b, p] = #{j : idx[b, j] == p}``.

Port of ``rangeclip_tpu/ops/pallas/histogram.py`` (``fused_histogram``), the
multiplicity histogram behind the sampled-pixel InfoNCE weights.  The CUDA
kernel is ``csrc/histogram.cu``: each block counts one row's draws into a
range of bins with shared-memory atomics and writes the range once (the
TPU kernel's one-hot matmul has no purpose on the card).
:func:`histogram_plain` is the same function in plain PyTorch, used for CPU
tensors and as the reference the kernel is held against on the card.
Counts are integers, so the two are bit-equal.
"""

from __future__ import annotations

import torch

from rangeclip_tpu_torch.ops.kernels import _lib


def histogram_plain(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[B, N] int draw indices -> [B, n_bins] f32 counts; indices outside
    [0, n_bins) are ignored."""
    hit = (idx >= 0) & (idx < n_bins)
    counts = torch.zeros(idx.shape[0], n_bins, dtype=torch.int32,
                         device=idx.device)
    counts.scatter_add_(1, torch.where(hit, idx, 0).long(), hit.int())
    return counts.float()


def histogram(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Args:
      idx: [B, N] int32 draw indices in [0, n_bins); negative = ignored.
      n_bins: P.

    Returns [B, n_bins] float32 exact integer counts.  CUDA tensors launch
    the kernel; CPU tensors run :func:`histogram_plain`."""
    kind = _lib.require_device("histogram", idx)
    _lib.require(idx.dtype == torch.int32 and idx.dim() == 2,
                 "histogram: idx must be int32 [B, N]")
    _lib.require(n_bins >= 1, "histogram: n_bins must be >= 1")
    if kind == "cpu":
        return histogram_plain(idx, n_bins)
    _lib.require(idx.shape[0] <= 65535, "histogram: the kernel takes at most "
                 f"65535 rows, got {idx.shape[0]}")
    return histogram_op(idx.contiguous(), n_bins)


def _histogram_cuda(idx, n_bins):
    out = torch.empty(idx.shape[0], n_bins, dtype=torch.float32,
                      device=idx.device)
    if idx.shape[0] == 0:
        return out
    code = _lib.library().rc_histogram(
        idx.data_ptr(), idx.shape[0], idx.shape[1], n_bins, out.data_ptr(),
        _lib.stream_of(idx))
    _lib.check(code, "histogram")
    return out


histogram_op = _lib.define_op(
    "histogram(Tensor idx, int n_bins) -> Tensor", _histogram_cuda, None,
    lambda idx, n_bins: idx.new_empty((idx.shape[0], n_bins),
                                      dtype=torch.float32))
