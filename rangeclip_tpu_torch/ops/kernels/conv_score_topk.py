"""Fused folded-head 3x3 conv + top-k selection.

Port of ``rangeclip_tpu/ops/pallas/conv_score_topk.py``
(``fused_conv_score_topk`` and its gate ``fused_conv_topk_applicable``).
The CUDA kernel is ``csrc/conv_score_topk.cu``, an implicit GEMM on the
tensor cores with the selection in registers (C_in up to 136,
:func:`conv_kernel_fits`; ``predict_folded`` sends wider features to the
conv + ``score_topk`` path);
:func:`conv_score_topk_plain` is the same function in plain PyTorch (f32
conv, bf16 rounding, packed selection), used for CPU tensors and as the
reference the kernel is held against on the card.

Unlike the TPU kernel, outputs come back in (B, h, w) pixel order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.score_topk import (
    MAX_TOP_K,
    score_topk_plain,
)


def fused_conv_topk_applicable(features_shape, S: int,
                               id_bound: Optional[int]) -> bool:
    """Dispatch gate of ``predict_folded``'s fused path: the JAX gate
    unchanged.  ``B % 128`` and ``w % 2`` are layout rules of the TPU kernel
    that this kernel does not need; they stay only so that dispatch matches
    the JAX package until the gate is re-derived from H100 measurements.
    The id bound is the packed key's own condition."""
    B, h, w, C_in = features_shape
    return (B % 128 == 0 and C_in % 8 == 0 and S % 128 == 0
            and w % 2 == 0 and id_bound is not None and id_bound < 2 ** 16)


def conv_kernel_fits(C_in: int) -> bool:
    """Whether the kernel's block fits in shared memory at C_in (64 im2col
    rows over ceil(9 C_in / 16) 16-dim steps in 64-dim blocks, the 4-stage
    ring, its barriers and a pixel's coordinates: rc_conv_score_topk_smem's
    test, C_in <= 136)."""
    k16 = (9 * C_in + 15) // 16
    blocks_k = (k16 + 3) // 4
    smem = blocks_k * 64 * 128 + 4 * 128 * 128 + 64 + 64 * 8 + 1024
    return smem <= 232448


def fold_to_rows(folded: torch.Tensor) -> torch.Tensor:
    """Folded conv weights [S, C_in, 3, 3] -> the kernel's [S, 9*C_in] rows,
    ordered (dy, dx, c) as at conv_score_topk.py:195."""
    S, C_in = folded.shape[:2]
    return folded.permute(0, 2, 3, 1).reshape(S, 9 * C_in).contiguous()


def conv_score_topk_plain(features: torch.Tensor, weight_rows: torch.Tensor,
                          ids: torch.Tensor, top_k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, h, w, C_in = features.shape
    S = weight_rows.shape[0]
    weight = weight_rows.float().reshape(S, 3, 3, C_in).permute(0, 3, 1, 2)
    scores = F.conv2d(features.float().permute(0, 3, 1, 2), weight,
                      padding=1)
    scores = scores.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(-1, S)
    return score_topk_plain(scores.contiguous(), ids, top_k, packed=True)


def conv_score_topk(
    features: torch.Tensor,
    weight_rows: torch.Tensor,
    candidate_ids: torch.Tensor,
    top_k: int = 5,
    want_values: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Args:
      features: [B, h, w, C_in] contiguous bf16 decoder features
        (C_in % 8 == 0).
      weight_rows: [S, 9*C_in] contiguous bf16 folded weights
        (:func:`fold_to_rows`), S % 128 == 0.
      candidate_ids: [S] int32 ascending global class ids < 2**16, -1 for
        dead slots.
      top_k: labels per pixel, 1..8.

    Returns (idx [N, k] int32, values [N, k] f32 or None), N = B*h*w in
    (B, h, w) order.  CUDA tensors launch the kernel; CPU tensors run
    :func:`conv_score_topk_plain`.
    """
    kind = _lib.require_device("conv_score_topk", features, weight_rows,
                               candidate_ids)
    _lib.require(features.dim() == 4, "conv_score_topk: features must be "
                 "[B, h, w, C_in]")
    B, h, w, C_in = features.shape
    S = weight_rows.shape[0]
    _lib.require(C_in % 8 == 0 and S % 128 == 0,
                 f"conv_score_topk: need C_in % 8 == 0 and S % 128 == 0, got "
                 f"({C_in}, {S})")
    _lib.require(features.dtype == torch.bfloat16
                 and weight_rows.dtype == torch.bfloat16,
                 "conv_score_topk: features and weights must be bf16")
    _lib.require(tuple(weight_rows.shape) == (S, 9 * C_in),
                 f"conv_score_topk: weight_rows must be [S, {9 * C_in}]")
    _lib.require(candidate_ids.dtype == torch.int32
                 and tuple(candidate_ids.shape) == (S,),
                 f"conv_score_topk: candidate_ids must be int32 [{S}]")
    _lib.require(features.is_contiguous() and weight_rows.is_contiguous()
                 and candidate_ids.is_contiguous(),
                 "conv_score_topk: inputs must be contiguous")
    _lib.require(1 <= top_k <= MAX_TOP_K,
                 f"conv_score_topk: top_k must be in 1..{MAX_TOP_K}")
    _lib.require(kind == "cpu" or conv_kernel_fits(C_in),
                 f"conv_score_topk: the kernel takes C_in <= 136, got {C_in}")
    if kind == "cpu":
        idx, val = conv_score_topk_plain(features, weight_rows,
                                         candidate_ids, top_k)
        return idx, (val if want_values else None)
    idx, val = conv_score_topk_op(features, weight_rows, candidate_ids,
                                  top_k, want_values)
    return idx, (val if want_values else None)


def _outputs(features: torch.Tensor, top_k: int, want_values: bool):
    B, h, w, _ = features.shape
    return _lib.topk_outputs(features, B * h * w, top_k, want_values)


def _conv_score_topk_cuda(features, weight_rows, ids, top_k, want_values):
    _lib.require(features.data_ptr() % 16 == 0
                 and weight_rows.data_ptr() % 16 == 0,
                 "conv_score_topk: inputs must be 16-byte aligned")
    idx, val = _outputs(features, top_k, want_values)
    if idx.shape[0] == 0:
        return idx, val
    B, h, w, C_in = features.shape
    code = _lib.library().rc_conv_score_topk(
        features.data_ptr(), weight_rows.data_ptr(), ids.data_ptr(), B, h, w,
        C_in, weight_rows.shape[0], top_k, idx.data_ptr(),
        val.data_ptr() if want_values else None, _lib.stream_of(features))
    _lib.check(code, "conv_score_topk")
    return idx, val


def _conv_score_topk_cpu(features, weight_rows, ids, top_k, want_values):
    idx, val = conv_score_topk_plain(features, weight_rows, ids, top_k)
    return idx, (val if want_values else val.new_empty(0))


conv_score_topk_op = _lib.define_op(
    "conv_score_topk(Tensor features, Tensor weight_rows, Tensor ids, "
    "int top_k, bool want_values) -> (Tensor, Tensor)",
    _conv_score_topk_cuda, _conv_score_topk_cpu,
    lambda features, weight_rows, ids, top_k, want_values: _outputs(
        features, top_k, want_values))
