"""The whole segmentation head in one kernel: output conv + L2 normalise +
pixel x text scoring + masked top-k.

Port of ``rangeclip_tpu/ops/pallas/head_topk.py``
(``fused_head_score_topk``), the kernel behind the opt-in
``models/depth_unet.predict_topk_fused``.  The CUDA kernels are in
``csrc/head_topk.cu``: bf16 features with C_in <= :data:`TC_MAX_C_IN` and
D <= :data:`TC_MAX_DIMS` take the tensor-core kernel, f32 features (and
wider bf16 ones) the CUDA-core route (:func:`kernel_route`); a call counts
one launch as ``head_topk[bf16]`` or ``head_topk[fp32]``.  Both score only
the live classes: the mask's table rows gathered first, in ascending id
order, with their ids and a device count, with no host sync (the
tensor-core route by :func:`live_head_rows`, the CUDA-core one by
``csrc/live_rows.cu``'s gather inside its C entry point).  The CUDA-core
route runs the conv and the scoring as two launches of the port's f32 loop
with the f32 field in a device workspace between them, in slabs of
:func:`field_slab_rows` pixels.  :func:`head_topk_plain` is the
same function in plain PyTorch, used for CPU tensors and as the reference
the kernels are held against on the card; it masks the full table and
shares no code with the gather.

Rounding points, as in the TPU kernel: the conv of the features with the
weights (both in the features' dtype) summed in f32; s = sum f^2 in f32
(the CUDA-core route: in f64, the scale rounded once; for f32 features it
scales the sum, rs * sum(f * t), which differs by f32 rounding only);
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

The kernels take C_in and D in multiples of 8; the wrapper zero-pads other
widths (:func:`pad_head_operands`), which is exact: a zero channel adds
nothing to the conv, and a zero dim is zero in the field, its norm and
every score.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.score_topk import MAX_TOP_K

NEG_INF = -1e30
# The widest features of the tensor-core kernel, as csrc/head_topk.cu's
# tc_head::fits takes them (kMaxCIn, kMaxDims; the card test
# test_head_topk_route_matches_the_kernel holds the two together); wider
# bf16 features take the CUDA-core one.
TC_MAX_C_IN = 64
TC_MAX_DIMS = 512
# The CUDA-core route's f32 field workspace holds at most this many values
# (256 MB); more pixels run as slabs of it (field_slab_rows).
FIELD_SLAB_VALUES = 1 << 26
_ROWS = 128  # csrc/common.cuh rc::simt::kRows: pixels of a block tile


def kernel_route(dtype: torch.dtype, c_in: int, dims: int) -> str:
    """The launch-count name of the kernel that CUDA features take, at the
    widths the kernel is handed (C_in and D zero-padded to multiples of
    8)."""
    tc = (dtype == torch.bfloat16 and -(-c_in // 8) * 8 <= TC_MAX_C_IN
          and -(-dims // 8) * 8 <= TC_MAX_DIMS)
    return f"head_topk[{'bf16' if tc else 'fp32'}]"


def field_slab_rows(dims: int, n_pix: int) -> int:
    """Pixels of one slab of the CUDA-core route at width ``dims`` (the
    padded D) over ``n_pix`` pixels: all of them while their f32 field
    fits :data:`FIELD_SLAB_VALUES`, else the most whole 128-pixel block
    tiles that do (at least one).  The workspace is [slab, dims] f32."""
    fit = max(_ROWS, FIELD_SLAB_VALUES // dims // _ROWS * _ROWS)
    return max(1, min(n_pix, fit))


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


def pad_head_operands(features: torch.Tensor, rows: torch.Tensor,
                      table: torch.Tensor):
    """(features [B, h, w, C8], rows [9*C8, D8], table [C, D8]) zero-padded
    up to C8, D8, the next multiples of 8 of C_in and D; the operands
    themselves when both already are."""
    C_in, D = features.shape[-1], rows.shape[1]
    pad_c, pad_d = -C_in % 8, -D % 8
    if pad_c:
        features = F.pad(features, (0, pad_c))
        rows = F.pad(rows.reshape(9, C_in, D), (0, 0, 0, pad_c)).reshape(
            9 * (C_in + pad_c), D)
    if pad_d:
        rows = F.pad(rows, (0, pad_d))
        table = F.pad(table, (0, pad_d))
    return features, rows, table


def head_field(features: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The output conv in f32 (3x3 SAME, bias-free) of features [B, h, w,
    C_in] with ``rows`` [9*C_in, D]: the un-normalised field [B*h*w, D]."""
    C_in, D = features.shape[-1], rows.shape[1]
    weight = rows.float().reshape(3, 3, C_in, D).permute(3, 2, 0, 1)
    f = F.conv2d(features.float().permute(0, 3, 1, 2), weight, padding=1)
    return f.permute(0, 2, 3, 1).reshape(-1, D)


def live_head_rows(table: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rows of ``table`` [C, D] with ``mask`` [C] non-zero first, in
    ascending id order, then the others: (that table, in the table's dtype;
    the class id of each of its rows [C] int32; the live count [1] int32),
    on the table's device with no host sync: each row's place comes from
    cumulative sums of the mask and the rows land by ``index_copy_``."""
    live = mask != 0
    ids = torch.arange(table.shape[0], device=table.device)
    before = live.cumsum(0)  # live rows up to and including each
    count = before[-1:]
    place = torch.where(live, before - 1, count + ids - before)
    gathered = torch.empty_like(table).index_copy_(0, place, table)
    row_ids = torch.empty_like(ids).index_copy_(0, place, ids)
    return gathered, row_ids.to(torch.int32), count.to(torch.int32)


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
    features, rows, table = pad_head_operands(features.contiguous(), rows,
                                              table)
    return head_topk_op(features.contiguous(), rows.contiguous(),
                        table.contiguous(), mask, top_k)


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
    C, D = table.shape
    route = kernel_route(features.dtype, C_in, D)
    lib = _lib.library()
    out = (idx.data_ptr(), val.data_ptr())
    if route == "head_topk[bf16]":
        live_table, ids, count = live_head_rows(table, mask)
        wt = rows.T.contiguous()  # [D, 9 * C_in]: the conv's B operand
        code = lib.rc_head_topk_tc(
            features.data_ptr(), wt.data_ptr(), live_table.data_ptr(),
            ids.data_ptr(), count.data_ptr(), B, h, w, C_in, D, C, top_k,
            *out, _lib.stream_of(features))
    else:
        n_pix, ldt = B * h * w, -(-C // 4) * 4
        slab = field_slab_rows(D, n_pix)
        wrows = rows.float().contiguous()  # the loop's f32 table
        table_t = features.new_empty((D, ldt), dtype=torch.float32)
        ids = features.new_empty(C, dtype=torch.int32)
        count = features.new_empty(1, dtype=torch.int32)
        field = features.new_empty((slab, D), dtype=torch.float32)
        code = lib.rc_head_topk(
            features.data_ptr(), int(features.dtype == torch.bfloat16),
            wrows.data_ptr(), table.data_ptr(), mask.data_ptr(), B, h, w,
            C_in, D, C, top_k, table_t.data_ptr(), ldt, ids.data_ptr(),
            count.data_ptr(), field.data_ptr(), slab, *out,
            _lib.stream_of(features))
    _lib.check(code, route)
    return idx, val


head_topk_op = _lib.define_op(
    "head_topk(Tensor features, Tensor rows, Tensor table, Tensor mask, "
    "int top_k) -> (Tensor, Tensor)",
    _head_topk_cuda, None,
    lambda features, rows, table, mask, top_k: _outputs(features, top_k))
