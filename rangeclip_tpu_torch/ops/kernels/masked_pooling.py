"""Segment sums and counts of pixel embeddings over object ids.

Port of ``rangeclip_tpu/ops/pallas/masked_pooling.py``
(``fused_masked_pooling``), the kernel behind ``losses/pooling.
masked_average_pooling``.  The CUDA kernel is ``csrc/masked_pooling.cu``: a
deterministic segment sum (P * D adds) where the TPU kernel multiplies
one-hot match tiles on the MXU.  :func:`masked_pooling_plain` is the same
function in plain PyTorch, the dense match product of the JAX kernel, used
for CPU tensors and as the reference the kernel is held against on the
card: the two sum in different orders (f32 values within rtol 1e-5), the
counts are exact.  The kernel takes D % 8 == 0 and D <= :data:`MAX_DIM`;
the wrapper zero-pads D and runs wider rows as column chunks
(:func:`column_chunks`): sums and counts are per column, so this is exact.
``tile_p`` and ``interpret`` are TPU tiling and interpret knobs with no
counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rangeclip_tpu_torch.ops.kernels import _lib

_CHUNK = 16384  # csrc/masked_pooling.cu kChunk: pixels per partial block
MAX_DIM = 2048  # csrc/masked_pooling.cu: 8 channels per thread, 256 threads


def masked_pooling_plain(embeddings: torch.Tensor, segmentation: torch.Tensor,
                         object_indices: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums [N, D] f32, counts [N] f32) through the [N, P] match matrix."""
    match = (segmentation[None, :] == object_indices[:, None]).float()
    return match @ embeddings.float(), match.sum(dim=1)


def fused_masked_pooling(embeddings: torch.Tensor, segmentation: torch.Tensor,
                         object_indices: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args:
      embeddings: [P, D] pixel embeddings, f32 or bf16 (read in their own
        dtype, summed in f32).
      segmentation: [P] int labels (-1 matches no object).
      object_indices: [N] int object ids (>= 0; duplicates allowed).

    Returns (sums [N, D] f32, counts [N] f32): zero rows and count 0 for
    ids absent from ``segmentation``.  CUDA tensors launch the kernel; CPU
    tensors run :func:`masked_pooling_plain`."""
    kind = _lib.require_device("masked_pooling", embeddings, segmentation,
                               object_indices)
    _lib.require(embeddings.dim() == 2 and segmentation.dim() == 1
                 and object_indices.dim() == 1
                 and segmentation.shape[0] == embeddings.shape[0],
                 "masked_pooling: need embeddings [P, D], segmentation [P] "
                 "and object_indices [N]")
    if kind == "cpu":
        return masked_pooling_plain(embeddings, segmentation, object_indices)
    P, D = embeddings.shape
    _lib.require(embeddings.dtype in (torch.float32, torch.bfloat16)
                 and D >= 1,
                 "masked_pooling: the kernel takes f32 or bf16 rows with "
                 f"D >= 1, got {embeddings.dtype} D={D}")
    _lib.require(-(-P // _CHUNK) <= 65535,
                 f"masked_pooling: at most {65535 * _CHUNK} pixels")
    segmentation = segmentation.to(torch.int32).contiguous()
    object_indices = object_indices.to(torch.int32).contiguous()
    parts = [masked_pooling_op(chunk, segmentation, object_indices)
             for chunk in column_chunks(embeddings)]
    sums = parts[0][0] if len(parts) == 1 else torch.cat(
        [s for s, _ in parts], dim=1)
    return sums[:, :D], parts[0][1]


def column_chunks(embeddings: torch.Tensor) -> list:
    """The [P, D] rows as the kernel takes them: D zero-padded up to D8,
    the next multiple of 8, and cut into contiguous column blocks of at
    most :data:`MAX_DIM`; one block, the rows themselves, when D already
    fits.  Each block's sums are its columns' sums, and every block counts
    the same pixels."""
    padded = _lib.pad_dim8(embeddings)
    if padded.shape[1] <= MAX_DIM:
        return [padded.contiguous()]
    return [padded[:, c:c + MAX_DIM].contiguous()
            for c in range(0, padded.shape[1], MAX_DIM)]


def _outputs(embeddings, object_indices):
    N, D = object_indices.shape[0], embeddings.shape[1]
    return (embeddings.new_empty((N, D), dtype=torch.float32),
            embeddings.new_empty((N,), dtype=torch.float32))


def _masked_pooling_cuda(embeddings, segmentation, object_indices):
    P, D = embeddings.shape
    N = object_indices.shape[0]
    sums, counts = _outputs(embeddings, object_indices)
    if N == 0 or P == 0:
        return sums.zero_(), counts.zero_()
    _lib.require(embeddings.data_ptr() % 16 == 0,
                 "masked_pooling: embeddings must be 16-byte aligned")
    chunks = -(-P // _CHUNK)
    part = torch.empty(chunks, N, D, dtype=torch.float32,
                       device=embeddings.device)
    pcount = torch.empty(chunks, N, dtype=torch.int32,
                         device=embeddings.device)
    code = _lib.library().rc_masked_pooling(
        embeddings.data_ptr(), int(embeddings.dtype == torch.bfloat16),
        segmentation.data_ptr(), object_indices.data_ptr(), P, D, N,
        part.data_ptr(), pcount.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), _lib.stream_of(embeddings))
    _lib.check(code, "masked_pooling")
    return sums, counts


masked_pooling_op = _lib.define_op(
    "masked_pooling(Tensor embeddings, Tensor segmentation, "
    "Tensor object_indices) -> (Tensor, Tensor)",
    _masked_pooling_cuda, None,
    lambda embeddings, segmentation, object_indices: _outputs(
        embeddings, object_indices))
