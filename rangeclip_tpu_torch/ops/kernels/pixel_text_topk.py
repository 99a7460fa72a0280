"""Fused pixel L2-normalisation + pixel x text scoring + masked top-k.

Port of ``rangeclip_tpu/ops/pallas/pixel_text_topk.py``
(``fused_pixel_text_topk``), the scoring of the unfolded predict path.  The
CUDA kernel is ``csrc/pixel_text_topk.cu``; :func:`pixel_text_topk_plain` is
the same function in plain PyTorch, used for CPU tensors and as the
reference the kernel is held against on the card.

Rounding points, as in the TPU kernel: the pixel is normalised in f32 with
``rsqrt(max(sum x^2, 1e-24))`` (not ``utils.math.l2_normalize``'s
``x / max(n, 1e-12)``) and rounded to the field's dtype; the table is cast
to the field's dtype; their product is summed in f32.  One departure: the
sum of squares is taken in f64 and the scale rounded once to f32, where the
TPU kernel sums in f32 (see :func:`normalize_rows_rsqrt`).  The JAX kernel's
[H, W, B, D] transpose and class-major score tile are TPU layout work: the
port's field is the NHWC view of a ``channels_last`` tensor, whose pixel
rows are already contiguous.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.score_topk import (
    MAX_TOP_K,
    score_topk_plain,
)


def normalize_rows_rsqrt(field: torch.Tensor) -> torch.Tensor:
    """[N, D] -> rows scaled by rsqrt(max(sum x^2, 1e-24)) in f32, rounded to
    the field's dtype (pixel_text_topk.py:85-88).  The sum is taken in f64,
    where it is exact for bf16 rows, and the scale is rounded once to f32:
    kernel and plain version then round every pixel identically, whatever
    their summation order (an f32 sum in another order moves the scale by
    an ulp and flips bf16 roundings of the pixel).  This departs from the
    TPU kernel, which sums in f32 and takes an f32 rsqrt: on bf16 fields
    the two can round a pixel differently, and top-k ids then differ
    beyond a near-tie (measured in tests/test_torch_unfolded.py)."""
    x = field.float()
    sq = x.double().square().sum(dim=-1, keepdim=True)
    rs = (1.0 / sq.clamp_min(1e-24).sqrt()).float()
    return (x * rs).to(field.dtype)


def select_topk(scores: torch.Tensor, ids: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of f32 ``scores`` [N, C] with output ids [C] (-1: may not win):
    the knockout order, and id -1 for picks scoring <= -1e29 (an exhausted
    candidate set, pixel_text_topk.py:123 and depth_unet.py:340)."""
    idx, val = score_topk_plain(scores, ids, top_k, packed=False)
    return torch.where(val > -1e29, idx, -1), val


def pixel_text_topk_plain(field: torch.Tensor, table: torch.Tensor,
                          ids: torch.Tensor, top_k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over ``field`` [N, D] (un-normalised) and ``table``
    [C, D] (normalised, in the field's dtype), with ``ids`` [C] the output
    id of each row, -1 for rows that may not win: (idx [N, k] int32,
    values [N, k] f32)."""
    scores = normalize_rows_rsqrt(field).float() @ table.float().T
    return select_topk(scores, ids, top_k)


def pixel_text_topk(
    pixel_embeddings: torch.Tensor,
    text_normalized: torch.Tensor,
    candidate_mask: Optional[torch.Tensor] = None,
    top_k: int = 5,
    want_values: bool = True,
    candidate_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Args:
      pixel_embeddings: [..., D] un-normalised field, f32 or bf16, with
        contiguous rows (the NHWC view of a channels_last tensor is).
      text_normalized: [C, D] L2-normalised table; cast to the field's dtype.
      candidate_mask: [C] bool/int, True for classes in the candidate set
        (default: all).
      top_k: labels per pixel, 1..min(8, C).
      want_values: also return the winning scores (f32).
      candidate_ids: [C] int32 ascending output id per table row (the
        gathered reduced-table form), -1 for padding; default arange(C).

    Returns (idx [N, k] int32 global ids, values [N, k] f32 or None), with N
    the product of the leading dims.  CUDA tensors launch the kernel; CPU
    tensors run :func:`pixel_text_topk_plain`.
    """
    D = pixel_embeddings.shape[-1]
    C = text_normalized.shape[0]
    device = pixel_embeddings.device
    if candidate_ids is None:
        candidate_ids = torch.arange(C, dtype=torch.int32, device=device)
    if candidate_mask is None:
        candidate_mask = torch.ones(C, dtype=torch.bool, device=device)
    kind = _lib.require_device("pixel_text_topk", pixel_embeddings,
                               text_normalized, candidate_mask, candidate_ids)
    _lib.require(pixel_embeddings.dtype in (torch.float32, torch.bfloat16),
                 "pixel_text_topk: the field must be f32 or bf16, got "
                 f"{pixel_embeddings.dtype}")
    _lib.require(tuple(text_normalized.shape) == (C, D),
                 f"pixel_text_topk: the table must be [C, {D}], got "
                 f"{tuple(text_normalized.shape)}")
    _lib.require(tuple(candidate_mask.shape) == (C,)
                 and tuple(candidate_ids.shape) == (C,)
                 and candidate_ids.dtype == torch.int32,
                 f"pixel_text_topk: candidate_mask must be [{C}] and "
                 f"candidate_ids int32 [{C}]")
    _lib.require(1 <= top_k <= min(MAX_TOP_K, C),
                 f"pixel_text_topk: top_k must be in 1..min({MAX_TOP_K}, "
                 f"C={C}), got {top_k}")
    flat = pixel_embeddings.reshape(-1, D)
    _lib.require(flat.is_contiguous(),
                 "pixel_text_topk: the field's rows must be contiguous")
    table = text_normalized.to(pixel_embeddings.dtype).contiguous()
    ids = torch.where(candidate_mask != 0, candidate_ids, -1).contiguous()
    if kind == "cpu":
        idx, val = pixel_text_topk_plain(flat, table, ids, top_k)
        return idx, (val if want_values else None)
    _lib.require(D % 8 == 0,
                 f"pixel_text_topk: the kernel needs D % 8 == 0, got {D}")
    idx, val = pixel_text_topk_op(flat, table, ids, top_k, want_values)
    return idx, (val if want_values else None)


def _pixel_text_topk_cuda(field, table, ids, top_k, want_values):
    _lib.require(field.data_ptr() % 16 == 0 and table.data_ptr() % 16 == 0,
                 "pixel_text_topk: field and table must be 16-byte aligned")
    idx, val = _lib.topk_outputs(field, field.shape[0], top_k, want_values)
    if field.shape[0] == 0:
        return idx, val
    code = _lib.library().rc_pixel_text_topk(
        field.data_ptr(), int(field.dtype == torch.bfloat16),
        table.data_ptr(), ids.data_ptr(), field.shape[0], field.shape[1],
        table.shape[0], top_k, idx.data_ptr(),
        val.data_ptr() if want_values else None, _lib.stream_of(field))
    _lib.check(code, "pixel_text_topk")
    return idx, val


def _pixel_text_topk_cpu(field, table, ids, top_k, want_values):
    idx, val = pixel_text_topk_plain(field, table, ids, top_k)
    return idx, (val if want_values else val.new_empty(0))


pixel_text_topk_op = _lib.define_op(
    "pixel_text_topk(Tensor field, Tensor table, Tensor ids, int top_k, "
    "bool want_values) -> (Tensor, Tensor)",
    _pixel_text_topk_cuda, _pixel_text_topk_cpu,
    lambda field, table, ids, top_k, want_values: _lib.topk_outputs(
        field, field.shape[0], top_k, want_values))
