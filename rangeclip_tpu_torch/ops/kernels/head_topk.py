"""The whole segmentation head in one kernel: output conv + L2 normalise +
pixel x text scoring + masked top-k.

Port of ``rangeclip_tpu/ops/pallas/head_topk.py``
(``fused_head_score_topk``), the kernel behind the opt-in
``models/depth_unet.predict_topk_fused``.  The CUDA kernel is
``csrc/head_topk.cu``; :func:`head_topk_plain` is the same function in plain
PyTorch, used for CPU tensors and as the reference the kernel is held
against on the card.

Rounding points, as in the TPU kernel: the conv of the features with the
weights (both in the features' dtype) summed in f32; s = sum f^2 in f32;
the embedding f / sqrt(max(s, 1e-24)) rounded to the features' dtype; its
scores against the table (cast to the features' dtype) summed in f32;
classes off the mask score -1e30; top-k by the knockout, ties to the
smallest id.  The knockout leaves masked and picked classes at -1e30 and
still competing, so on an exhausted candidate set every pick after the
live classes is (id 0, -1e30): not ``DepthUNet.predict``'s -1 sentinel, and
kept so.  The conv sums in another order than the TPU's or cuDNN's, so a
bf16 embedding may round differently and near-tied labels flip; f32 ids
agree up to near-ties.  ``interpret`` is the TPU kernel's interpret knob
and has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.score_topk import MAX_TOP_K

NEG_INF = -1e30
MAX_DIM = 656  # csrc/head_topk.cu: the [D, 64] f32 tile within shared memory


def weight_rows(conv_weight: torch.Tensor) -> torch.Tensor:
    """An OIHW output-conv weight [D, C_in, 3, 3] -> the kernel's
    [9 * C_in, D] rows in (dy, dx, c_in) order: the HWIO kernel of the JAX
    package reshaped (head_topk.py:146)."""
    D, C_in = conv_weight.shape[:2]
    return conv_weight.permute(2, 3, 1, 0).reshape(9 * C_in, D).contiguous()


def knockout_topk(scores: torch.Tensor, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's selection (head_topk.py:110-118) over [N, C] f32
    scores: k rounds of (max, smallest id at the max, knock it out to
    -1e30)."""
    scores = scores.clone()
    ids = torch.arange(scores.shape[1], device=scores.device)
    idx, val = [], []
    for _ in range(top_k):
        m = scores.max(dim=1).values
        pick = torch.where(scores >= m[:, None], ids, scores.shape[1]).min(
            dim=1).values
        idx.append(pick)
        val.append(m)
        scores.scatter_(1, pick[:, None], NEG_INF)
    return (torch.stack(idx, dim=1).to(torch.int32),
            torch.stack(val, dim=1))


def head_field(features: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The output conv in f32 (3x3 SAME, bias-free) of features [B, h, w,
    C_in] with ``rows`` [9*C_in, D]: the un-normalised field [B*h*w, D]."""
    C_in, D = features.shape[-1], rows.shape[1]
    weight = rows.float().reshape(3, 3, C_in, D).permute(3, 2, 0, 1)
    f = F.conv2d(features.float().permute(0, 3, 1, 2), weight, padding=1)
    return f.permute(0, 2, 3, 1).reshape(-1, D)


def head_topk_plain(features: torch.Tensor, rows: torch.Tensor,
                    text: torch.Tensor, mask: torch.Tensor, top_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over features [B, h, w, C_in], ``rows`` [9*C_in, D] and
    ``text`` [C, D] (both in the features' dtype) and ``mask`` [C]: (idx
    [B*h*w, k] int32, values [B*h*w, k] f32)."""
    f = head_field(features, rows)
    sq = f.square().sum(dim=1, keepdim=True)
    emb = (f * (1.0 / torch.sqrt(sq.clamp_min(1e-24)))).to(features.dtype)
    scores = emb.float() @ text.float().T
    scores = torch.where(mask[None, :] != 0, scores,
                         scores.new_tensor(NEG_INF))
    return knockout_topk(scores, top_k)


def fused_head_score_topk(
    features: torch.Tensor,
    head_weight: torch.Tensor,
    text_normalized: torch.Tensor,
    candidate_mask: torch.Tensor,
    top_k: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args:
      features: [B, h, w, C_in] pre-head decoder features, f32 or bf16.
      head_weight: [9 * C_in, D] output-conv weight rows in (dy, dx, c_in)
        order (:func:`weight_rows`); cast to the features' dtype.
      text_normalized: [C, D] L2-normalised table; cast to the features'
        dtype.
      candidate_mask: [C] bool/int candidate-set membership.
      top_k: labels per pixel, 1..8.

    Returns (indices [B*h*w, k] int32, values [B*h*w, k] f32), pixels in
    (b, y, x) order.  CUDA tensors launch the kernel; CPU tensors run
    :func:`head_topk_plain`."""
    kind = _lib.require_device("head_topk", features, head_weight,
                               text_normalized, candidate_mask)
    _lib.require(features.dim() == 4, "head_topk: features must be "
                 "[B, h, w, C_in]")
    B, h, w, C_in = features.shape
    C, D = text_normalized.shape
    _lib.require(features.dtype in (torch.float32, torch.bfloat16),
                 f"head_topk: features must be f32 or bf16, got "
                 f"{features.dtype}")
    _lib.require(tuple(head_weight.shape) == (9 * C_in, D),
                 f"head_topk: head_weight must be [{9 * C_in}, {D}], got "
                 f"{tuple(head_weight.shape)}")
    _lib.require(tuple(candidate_mask.shape) == (C,),
                 f"head_topk: candidate_mask must be [{C}]")
    _lib.require(1 <= top_k <= MAX_TOP_K,
                 f"head_topk: top_k must be in 1..{MAX_TOP_K}, got {top_k}")
    rows = head_weight.to(features.dtype).contiguous()
    table = text_normalized.to(features.dtype).contiguous()
    mask = candidate_mask.to(torch.int32).contiguous()
    if kind == "cpu":
        return head_topk_plain(features, rows, table, mask, top_k)
    _lib.require(C_in % 8 == 0 and D % 8 == 0 and D <= MAX_DIM,
                 "head_topk: the kernel needs C_in % 8 == 0, D % 8 == 0 and "
                 f"D <= {MAX_DIM}, got C_in={C_in} D={D}")
    return head_topk_op(features.contiguous(), rows, table, mask, top_k)


def _outputs(features: torch.Tensor, top_k: int):
    B, h, w, _ = features.shape
    return _lib.topk_outputs(features, B * h * w, top_k, True)


def _head_topk_cuda(features, rows, table, mask, top_k):
    _lib.require(all(t.data_ptr() % 16 == 0 for t in (features, rows, table)),
                 "head_topk: features, rows and table must be 16-byte "
                 "aligned")
    idx, val = _outputs(features, top_k)
    if idx.shape[0] == 0:
        return idx, val
    B, h, w, C_in = features.shape
    code = _lib.library().rc_head_topk(
        features.data_ptr(), int(features.dtype == torch.bfloat16),
        rows.data_ptr(), table.data_ptr(), mask.data_ptr(), B, h, w, C_in,
        rows.shape[1], table.shape[0], top_k, idx.data_ptr(), val.data_ptr(),
        _lib.stream_of(features))
    _lib.check(code, "head_topk")
    return idx, val


head_topk_op = _lib.define_op(
    "head_topk(Tensor features, Tensor rows, Tensor table, Tensor mask, "
    "int top_k) -> (Tensor, Tensor)",
    _head_topk_cuda, None,
    lambda features, rows, table, mask, top_k: _outputs(features, top_k))
