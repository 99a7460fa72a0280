"""Masked top-k selection over a precomputed pixel x candidate score field.

Port of ``rangeclip_tpu/ops/pallas/score_topk.py`` (``fused_score_topk``).
The CUDA kernel is ``csrc/score_topk.cu``; :func:`score_topk_plain` is the
same function in plain PyTorch, used for CPU tensors and as the reference
the kernel is held against on the card.

Two selectors, as in the JAX package:

* ``knockout`` (any float dtype): dead slots (id -1) score -1e30; each pick
  is the max, ties to the smallest id, and knocks that id out.  Once the
  valid slots are exhausted the dead slots tie at -1e30 and id -1 wins, so
  the overflow picks are (-1, -1e30).
* ``packed`` (bf16 scores, a static id bound < 2**16): one int32 key per slot
  carries the bf16 value and ``0xFFFF - id``, so one sorted pass selects and
  the winners decode exactly.  It ranks +0.0 above -0.0, lets valid scores
  below -1e30 win, and ranks NaN on top (score_topk.py:66-71).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rangeclip_tpu_torch.ops.kernels import _lib

NEG_INF = -1e30
INT_MIN = -(2 ** 31)
INT_MAX = 2 ** 31 - 1
MAX_TOP_K = 8  # the kernel keeps its top-k in registers


def packed_keys(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int32 sort keys of bf16 ``scores`` [N, S] for slot ids [S]
    (score_topk.py:159-164); dead slots get INT_MIN."""
    b = scores.float().view(torch.int32)
    key = (b ^ ((b >> 31) & 0x7FFF0000)) + (0xFFFF - ids)
    return torch.where(ids >= 0, key, INT_MIN)


def decode_packed(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winning keys -> (global ids, exact f32 values); INT_MIN -> (-1, -1e30)
    (score_topk.py:176-187)."""
    valid = m != INT_MIN
    gid = torch.where(valid, 0xFFFF - (m & 0xFFFF), -1)
    bu = (m + torch.where(valid, gid, 0)) & -65536
    vb = (bu ^ ((bu >> 31) & 0x7FFFFFFF)) & -65536
    return gid, torch.where(valid, vb.view(torch.float32), NEG_INF)


def score_topk_plain(scores: torch.Tensor, ids: torch.Tensor, top_k: int,
                     packed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch selection over ``scores`` [N, S]: (idx [N, k] int32,
    values [N, k] f32), bit-equal to the JAX kernels in interpret mode."""
    if packed:
        keys = packed_keys(scores, ids)
        return decode_packed(torch.topk(keys, top_k, dim=1).values)
    s = torch.where(ids >= 0, scores.float(), NEG_INF)
    picks, values = [], []
    for _ in range(top_k):
        m = s.amax(dim=1, keepdim=True)
        winner = torch.where(s >= m, ids, INT_MAX).amin(dim=1)
        picks.append(winner)
        values.append(m[:, 0])
        s = torch.where(ids == winner[:, None], NEG_INF, s)
    return torch.stack(picks, dim=1), torch.stack(values, dim=1)


def score_topk(
    scores: torch.Tensor,
    candidate_ids: Optional[torch.Tensor] = None,
    top_k: int = 5,
    want_values: bool = False,
    selector: str = "auto",
    max_id: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Args:
      scores: [..., S] contiguous f32 or bf16 pixel x slot scores.
      candidate_ids: [S] int32 ascending global class ids, -1 for dead
        slots; default arange(S).
      top_k: labels per pixel, 1..min(8, S).
      want_values: also return the winning scores (f32).
      selector: 'auto' (packed for bf16 with an id bound < 2**16, else
        knockout), 'packed' or 'knockout'.
      max_id: static bound on ``candidate_ids`` (needed for 'packed' with
        caller-supplied ids).

    Returns (idx [N, k] int32 global ids, values [N, k] f32 or None), with N
    the product of the leading dims.  CUDA tensors launch the kernel; CPU
    tensors run :func:`score_topk_plain`.
    """
    S = scores.shape[-1]
    default_ids = candidate_ids is None
    if default_ids:
        candidate_ids = torch.arange(S, dtype=torch.int32,
                                     device=scores.device)
    kind = _lib.require_device("score_topk", scores, candidate_ids)
    _lib.require(scores.dtype in (torch.float32, torch.bfloat16),
                 f"score_topk: scores must be f32 or bf16, got {scores.dtype}")
    _lib.require(scores.is_contiguous(), "score_topk: scores not contiguous")
    _lib.require(candidate_ids.dtype == torch.int32
                 and tuple(candidate_ids.shape) == (S,)
                 and candidate_ids.is_contiguous(),
                 f"score_topk: candidate_ids must be contiguous int32 [{S}]")
    # top_k <= S: with no dead slot the valid ones then outnumber the picks,
    # which the kernel's exhausted-set rule (picks of id -1) relies on
    _lib.require(1 <= top_k <= min(MAX_TOP_K, S),
                 f"score_topk: top_k must be in 1..min({MAX_TOP_K}, S={S}), "
                 f"got {top_k}")

    id_bound = (S - 1) if default_ids else max_id
    packed_ok = (scores.dtype == torch.bfloat16 and id_bound is not None
                 and id_bound < 2 ** 16)
    if selector == "auto":
        packed = packed_ok
    elif selector in ("packed", "knockout"):
        packed = selector == "packed"
        _lib.require(not packed or packed_ok,
                     "packed selector requires bf16 scores and a static id "
                     f"bound < 2**16 (got dtype {scores.dtype}, bound "
                     f"{id_bound})")
    else:
        raise ValueError(f"unknown selector {selector!r}")

    flat = scores.reshape(-1, S)
    if kind == "cpu":
        idx, val = score_topk_plain(flat, candidate_ids, top_k, packed)
        return idx, (val if want_values else None)
    idx, val = score_topk_op(flat, candidate_ids, top_k, packed, want_values)
    return idx, (val if want_values else None)


def _score_topk_cuda(scores, ids, top_k, packed, want_values):
    idx, val = _lib.topk_outputs(scores, scores.shape[0], top_k,
                                 want_values)
    if scores.shape[0] == 0:
        return idx, val
    code = _lib.library().rc_score_topk(
        scores.data_ptr(), int(scores.dtype == torch.bfloat16), int(packed),
        ids.data_ptr(), scores.shape[0], scores.shape[1], top_k,
        idx.data_ptr(), val.data_ptr() if want_values else None,
        _lib.stream_of(scores))
    _lib.check(code, "score_topk[packed]" if packed else "score_topk[knockout]")
    return idx, val


def _score_topk_cpu(scores, ids, top_k, packed, want_values):
    idx, val = score_topk_plain(scores, ids, top_k, packed)
    return idx, (val if want_values else val.new_empty(0))


score_topk_op = _lib.define_op(
    "score_topk(Tensor scores, Tensor ids, int top_k, bool packed, "
    "bool want_values) -> (Tensor, Tensor)",
    _score_topk_cuda, _score_topk_cpu,
    lambda scores, ids, top_k, packed, want_values: _lib.topk_outputs(
        scores, scores.shape[0], top_k, want_values))
