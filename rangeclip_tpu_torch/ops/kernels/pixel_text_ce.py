"""Fused pixel-text InfoNCE cross-entropy, forward and backward.

Port of ``rangeclip_tpu/ops/pallas/pixel_text_ce.py`` (``fused_pixel_text_ce``,
a ``jax.custom_vjp``): ``sum_i sum_s valid[s, i] * CE_i(labels[s, i])`` over
``normalize(samples) . table / tau`` with the contrast set masked to -1e30;
the caller divides by n_valid and gates.  Gradients flow to the samples and
the temperature; the text table is frozen.

The CUDA kernels are ``csrc/pixel_text_ce.cu`` and, past 4 label slots in
bf16, ``csrc/pixel_text_ce_slots.cu``; each pair is an operator,
``rangeclip::pixel_text_ce`` with ``rangeclip::pixel_text_ce_backward``
registered as its gradient, and ``rangeclip::pixel_text_ce_slots`` with
``rangeclip::pixel_text_ce_slots_backward``.  The forward operators also
return each row's max logit and sum-exp ([2, N] f32, not differentiable),
which the backwards read instead of scoring the members once more.  CPU
tensors run the plain versions, :func:`pixel_text_ce_plain` and
:func:`pixel_text_ce_backward_plain`, as a ``torch.autograd.Function``; the
operators have no CPU implementation.

Rounding points, as in the TPU kernel: rows normalised in f32 with
``rsqrt(max(sum x^2, 1e-24))`` (the sum in f64 and the scale rounded once,
as in ``pixel_text_topk``), rounded to the table's dtype (the samples'
dtype: bf16 or f32) before the product, f32 sums, logits = sim * (1/tau),
non-members at -1e30, and in the backward ``delta`` rounded to the table's
dtype before its product with the table.  The kernels differ from the plain
versions by f32 summation order, and the forward by an online max across
class tiles (none with one tile, as in the packed form).

Packed contrast (``packed=(table, mask, class_ids, use_packed)``): the
members' rows gathered into a fixed-capacity [K, D] table with their global
ids (sentinel C in padded slots, mask 0); labels stay global.  ``use_packed``
is a device flag, n_contrast <= K: the kernels read it and score either the
packed or the full table, so choosing the branch needs no host sync (the
plain versions read it on the host).

Routes on the card (by shape on the host, one for both directions): bf16
with 5-16 label slots (a field at H/4 upsampled x4 has 16; the wrapper pads
5-15 to 16 with slots of weight 0, which add exactly nothing) and D <=
1280 takes the tensor-core pair past 4 slots (:func:`slots_route`: one
pass over the 16 slots and every contrast member of the table the flag
selects, gathered in bf16 by :func:`member_rows`), whatever the flag and
the member count.  bf16 with a packed table, D <= 1280, K <= 128 and at
most 4 slots (:func:`tc_route`) launches the tensor-core kernel and the
member-only CUDA-core kernel together; the first runs where the flag
selects the packed table, the second (told to skip that branch) where it
selects the full one.  Everything else, fp32 at any slot count and wider
or larger packed tables, takes the member-only kernels alone, which take
1-4 slots or 16 in one pass.  The member-only kernels score only the
contrast members of the table the flag selects (:func:`member_table`,
gathered on the device in one launch); no route scores a full table.  The
kernels take D % 8 == 0; the wrapper zero-pads any other D
(``_lib.pad_dim8``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.live_rows import (
    live_rows,
    live_rows_bf16,
)

NEG_INF = -1e30
MAX_SLOTS = 16  # csrc/pixel_text_ce.cu: member::dispatch
TC_MAX_SLOTS = 4  # tc_shape_ok
TC_MAX_DIM = 1280  # csrc/pixel_text_ce.cu kMaxTcDims: the A tile in smem
TC_MAX_CLASSES = 128  # kMaxTcBwdClasses: the backward's delta is one tile

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def row_scale(x: torch.Tensor) -> torch.Tensor:
    """[N, D] f32 -> [N, 1] f32 rsqrt(max(sum x^2, 1e-24)), the sum in f64
    and the scale rounded once (pixel_text_topk.normalize_rows_rsqrt)."""
    sq = x.double().square().sum(dim=-1, keepdim=True)
    return (1.0 / sq.clamp_min(1e-24).sqrt()).float()


def _choose(table, mask, packed: Optional[Packed]):
    """(table, mask, ids or None) of the branch the flag selects."""
    if packed is not None and bool(packed[3]):
        return packed[0], packed[1], packed[2]
    return table, mask, None


def _logits(samples, temperature, table, mask):
    x = samples.reshape(-1, samples.shape[-1]).float()
    rs = row_scale(x)
    emb = x * rs
    inv_temp = 1.0 / temperature.float()
    sim = emb.to(table.dtype).float() @ table.float().T
    logits = torch.where(mask[None, :] != 0, sim * inv_temp,
                         torch.full_like(sim, NEG_INF))
    return rs, emb, inv_temp, logits


def _onehots(labels, ids, C):
    ids = (torch.arange(C, dtype=torch.int32, device=labels.device)
           if ids is None else ids)
    return [ids[None, :] == labels[s][:, None] for s in range(labels.shape[0])]


def pixel_text_ce_plain(samples, temperature, labels, valid, table, mask,
                        packed: Optional[Packed] = None) -> torch.Tensor:
    """The summed weighted CE (f32 scalar); arguments as in
    :func:`fused_pixel_text_ce` after its normalisation (labels and valid
    [S, N], table in the samples' dtype, mask int32)."""
    table, mask, ids = _choose(table, mask, packed)
    _, _, _, logits = _logits(samples, temperature, table, mask)
    m = logits.max(dim=1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=1))
    wsum = torch.zeros_like(lse)
    wpick = torch.zeros_like(lse)
    for s, onehot in enumerate(_onehots(labels, ids, table.shape[0])):
        picked = torch.where(onehot, logits, 0.0).sum(dim=1)
        wsum = wsum + valid[s]
        wpick = wpick + valid[s] * picked
    return (wsum * lse - wpick).sum()


def pixel_text_ce_backward_plain(grad, samples, temperature, labels, valid,
                                 table, mask, packed: Optional[Packed] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d samples in the samples' dtype and shape, d temperature): the TPU
    kernel's backward (pixel_text_ce.py:124-180, 478-481) written out."""
    table, mask, ids = _choose(table, mask, packed)
    rs, emb, inv_temp, logits = _logits(samples, temperature, table, mask)
    m = logits.max(dim=1, keepdim=True).values
    e = torch.exp(logits - m)
    inv_z = 1.0 / e.sum(dim=1, keepdim=True)
    coeff = grad.float()
    onehots = _onehots(labels, ids, table.shape[0])
    wsum = torch.zeros_like(inv_z)
    for s in range(len(onehots)):
        wsum = wsum + coeff * valid[s][:, None]
    delta = e * (wsum * inv_z)
    wpick = torch.zeros_like(inv_z)
    for s, onehot in enumerate(onehots):
        w = coeff * valid[s][:, None]
        wpick = wpick + w * torch.where(onehot, logits, 0.0).sum(
            dim=1, keepdim=True)
        delta = delta - torch.where(onehot, w, 0.0)
    exp_logit = (e * logits).sum(dim=1, keepdim=True) * inv_z
    dtau = wpick - wsum * exp_logit
    d_emb = (delta.to(table.dtype).float() @ table.float()) * inv_temp
    proj = (emb * d_emb).sum(dim=1, keepdim=True)
    dx = (rs * (d_emb - emb * proj)).to(samples.dtype)
    return dx.reshape(samples.shape), dtau.sum() / temperature


class _PlainCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, samples, temperature, labels, valid, table, mask,
                ptable, pmask, pids, use_packed):
        packed = None if ptable is None else (ptable, pmask, pids, use_packed)
        ctx.save_for_backward(samples, temperature, labels, valid, table,
                              mask)
        ctx.packed = packed
        return pixel_text_ce_plain(samples, temperature, labels, valid, table,
                                   mask, packed)

    @staticmethod
    def backward(ctx, grad):
        dx, dt = pixel_text_ce_backward_plain(grad, *ctx.saved_tensors,
                                              packed=ctx.packed)
        return (dx, dt.reshape(ctx.saved_tensors[1].shape)) + (None,) * 8


def ce_operands(samples, temperature, labels, valid, table, mask,
                    packed: Optional[Packed]):
    """The operators' argument forms: flat [N, D] samples, [S, N] int32
    labels and f32 valid, int32 masks, the packed members and flag."""
    D = samples.shape[-1]
    flat = samples.reshape(-1, D)
    N = flat.shape[0]
    labels = labels.reshape(-1, N).to(torch.int32).contiguous()
    valid = valid.reshape(-1, N).to(torch.float32).contiguous()
    C = table.shape[0]
    mask = mask.to(torch.int32).contiguous()
    ptable = pmask = pids = flag = None
    if packed is not None:
        ptable = packed[0].contiguous()
        pmask = packed[1].to(torch.int32).contiguous()
        pids = packed[2].to(torch.int32).contiguous()
        flag = packed[3].to(torch.int32).reshape(1).contiguous()
    _lib.require(samples.dtype in (torch.float32, torch.bfloat16),
                 f"pixel_text_ce: samples must be f32 or bf16, got "
                 f"{samples.dtype}")
    _lib.require(table.dtype == samples.dtype
                 and (ptable is None or ptable.dtype == samples.dtype),
                 "pixel_text_ce: the tables must be in the samples' dtype")
    _lib.require(tuple(table.shape) == (C, D) and tuple(mask.shape) == (C,),
                 f"pixel_text_ce: table [C, {D}] and mask [C] expected")
    _lib.require(labels.shape == valid.shape,
                 "pixel_text_ce: labels and valid must have one shape")
    _lib.require(temperature.numel() == 1
                 and temperature.dtype == torch.float32,
                 "pixel_text_ce: temperature must be a f32 scalar")
    if ptable is not None:
        K = ptable.shape[0]
        _lib.require(tuple(ptable.shape) == (K, D)
                     and tuple(pmask.shape) == (K,)
                     and tuple(pids.shape) == (K,),
                     "pixel_text_ce: packed table [K, D], mask and ids [K]")
    return flat, labels, valid, mask, ptable, pmask, pids, flag


def pixel_text_ce_reference(samples: torch.Tensor, temperature: torch.Tensor,
                            labels: torch.Tensor, valid: torch.Tensor,
                            table: torch.Tensor, mask: torch.Tensor,
                            packed: Optional[Packed] = None) -> torch.Tensor:
    """:func:`fused_pixel_text_ce` through the plain versions on any device
    (a ``torch.autograd.Function`` of :func:`pixel_text_ce_plain` and
    :func:`pixel_text_ce_backward_plain`): the CPU route, and the reference
    a CUDA run is held against."""
    flat, labels, valid, mask, ptable, pmask, pids, flag = ce_operands(
        samples, temperature, labels, valid, table, mask, packed)
    return _PlainCE.apply(flat, temperature, labels, valid, table, mask,
                          ptable, pmask, pids, flag)


def fused_pixel_text_ce(samples: torch.Tensor, temperature: torch.Tensor,
                        labels: torch.Tensor, valid: torch.Tensor,
                        table: torch.Tensor, mask: torch.Tensor,
                        packed: Optional[Packed] = None) -> torch.Tensor:
    """sum_i valid_i * CE_i (f32 scalar), differentiable in ``samples`` and
    ``temperature``.

    Args:
      samples: [N, D] un-normalised pixel embeddings or the [B, h, w, D]
        field with contiguous rows, f32 or bf16.
      temperature: scalar f32 tensor; logits = cos-sim * (1 / temperature).
      labels: [N] int32 or [S, N] label slots, S <= MAX_SLOTS (a field at
        H/4 upsampled x4 has 16).
      valid: [N] or [S, N] f32 weights.
      table: [C, D] L2-normalised rows in the samples' dtype.
      mask: [C] contrast-set membership.
      packed: optional (table [K, D], mask [K], class_ids [K] int32, flag):
        the packed member table, chosen where the device flag is non-zero.

    CUDA tensors launch the kernels; CPU tensors run the plain versions
    (:func:`pixel_text_ce_reference`).
    """
    tensors = [t for t in (samples, temperature, labels, valid, table, mask)
               + tuple(packed or ()) if t is not None]
    kind = _lib.require_device("pixel_text_ce", *tensors)
    if kind == "cpu":
        return pixel_text_ce_reference(samples, temperature, labels, valid,
                                       table, mask, packed)
    flat, labels, valid, mask, ptable, pmask, pids, flag = ce_operands(
        samples, temperature, labels, valid, table, mask, packed)
    S = labels.shape[0]
    _lib.require(flat.is_contiguous(),
                 "pixel_text_ce: the samples' rows must be contiguous")
    _lib.require(1 <= S <= MAX_SLOTS,
                 f"pixel_text_ce: the kernels take 1..{MAX_SLOTS} slots; got "
                 f"S={S}")
    if TC_MAX_SLOTS < S < MAX_SLOTS:
        labels, valid = padded_slots(labels, valid)
    # D zero-padded to a multiple of 8: a zero column adds nothing to a
    # row's f64 sum of squares, to a product or to the sum-exp, and d
    # samples comes back sliced to D through the pad's gradient
    flat, table, ptable = (_lib.pad_dim8(flat),
                           _lib.pad_dim8(table.contiguous()),
                           _lib.pad_dim8(ptable))
    op = (pixel_text_ce_slots_op if slots_route(flat, labels.shape[0])
          else pixel_text_ce_op)
    return op(flat, temperature.reshape(()).contiguous(), labels, valid,
              table, mask, ptable, pmask, pids, flag)[0]


def padded_slots(labels: torch.Tensor, valid: torch.Tensor):
    """[S, N] labels and weights padded to MAX_SLOTS slots of label -1 and
    weight 0: the kernels' instances past 4 slots take 16.  A padded slot
    adds 0 to every sum and picks no class."""
    pad = MAX_SLOTS - labels.shape[0]
    return (torch.nn.functional.pad(labels, (0, 0, 0, pad), value=-1),
            torch.nn.functional.pad(valid, (0, 0, 0, pad)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(*tensors):
    _lib.require(all(t is None or t.data_ptr() % 16 == 0 for t in tensors),
                 "pixel_text_ce: samples and tables must be 16-byte aligned")


def tc_route(samples: torch.Tensor, ptable: Optional[torch.Tensor],
             slots: int = 1) -> bool:
    """Whether the packed branch runs on the tensor-core kernels: bf16
    samples with a packed table, D <= TC_MAX_DIM, K <= TC_MAX_CLASSES and
    at most TC_MAX_SLOTS label slots, in both directions (the tensor-core
    forward writes no row statistics for a member-only backward).  The
    device flag still chooses packed or full."""
    return (ptable is not None and samples.dtype == torch.bfloat16
            and samples.shape[1] <= TC_MAX_DIM
            and ptable.shape[0] <= TC_MAX_CLASSES
            and slots <= TC_MAX_SLOTS)


def slots_route(samples: torch.Tensor, slots: int) -> bool:
    """Whether the call runs on the tensor-core pair past 4 slots
    (``csrc/pixel_text_ce_slots.cu``), in both directions: bf16 samples
    [N, D] with D <= TC_MAX_DIM (after the wrapper's padding to a multiple
    of 8) and 5-16 label slots, with or without a packed table, whatever
    the device flag and the member count."""
    return (samples.dtype == torch.bfloat16
            and samples.shape[-1] <= TC_MAX_DIM
            and TC_MAX_SLOTS < slots <= MAX_SLOTS)


def transposed_table(ptable: torch.Tensor) -> torch.Tensor:
    """The packed table [K, D] as the backward's B operand: [D, K8], K8 = K
    rounded up to a multiple of 8, zero columns past K."""
    K, D = ptable.shape
    out = ptable.new_zeros((D, -(-K // 8) * 8))
    out[:, :K] = ptable.T
    return out


def member_table(table, mask, ptable=None, pmask=None, pids=None,
                 use_packed=None):
    """The member-only kernels' table operand: the members of the table the
    device flag selects (the packed one where it is non-zero, else the full
    one), first and in table order, as :func:`live_rows.live_table` gives
    them ([D, Cp] f32), with their global ids and a [1] device count; no
    host sync.  With a packed table both tables are gathered, the selected
    one first, each row live only where its branch is selected: with no
    member, the selected table's rows lead in table order.  CUDA tensors
    take one launch (:func:`live_rows.live_rows`)."""
    return live_rows(table, None, mask,
                     _second(ptable, pmask, pids, use_packed))


def _second(ptable, pmask, pids, use_packed):
    """The gathers' second table, the packed one, or None."""
    if ptable is None:
        return None
    return (ptable, pids.to(torch.int32), pmask.to(torch.int32),
            use_packed.to(torch.int32).reshape(1))


def member_rows(table, mask, ptable=None, pmask=None, pids=None,
                use_packed=None):
    """The tensor-core kernels' member operands past 4 slots: the rows of
    :func:`member_table` in bf16, row-major [R, D] and transposed [D, Rt]
    (Rt = R rounded up to a multiple of 8), with their global ids and a [1]
    device count; no host sync.  CUDA tensors take one launch
    (:func:`live_rows.live_rows_bf16`)."""
    return live_rows_bf16(table, None, mask,
                          _second(ptable, pmask, pids, use_packed))


def delta_pitch(rows: int) -> int:
    """The row pitch of the backward's delta workspace past 4 slots: the
    gathered rows rounded up to whole 128-class tiles."""
    return -(-rows // 128) * 128


def _slots_fwd_cuda(samples, temperature, labels, valid, table, mask, ptable,
                    pmask, pids, use_packed):
    _aligned(samples, table, ptable)
    _lib.require(labels.shape[0] == MAX_SLOTS,
                 f"pixel_text_ce_slots: {MAX_SLOTS} label slots expected")
    N, D = samples.shape
    stats = samples.new_empty((2, N), dtype=torch.float32)
    if N == 0:
        return samples.new_zeros((), dtype=torch.float32), stats
    ce = samples.new_empty(N, dtype=torch.float32)
    rows, _, ids, count = member_rows(table, mask, ptable, pmask, pids,
                                      use_packed)
    K = 0 if ptable is None else ptable.shape[0]
    _lib.check(_lib.library().rc_pixel_text_ce_slots_fwd(
        samples.data_ptr(), temperature.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), N, D, rows.data_ptr(), ids.data_ptr(),
        count.data_ptr(), rows.shape[0], mask.data_ptr(), table.shape[0],
        _ptr(pmask), _ptr(pids), K, _ptr(use_packed), ce.data_ptr(),
        stats.data_ptr(), _lib.stream_of(samples)),
        "pixel_text_ce_slots[fwd]")
    return ce.sum(), stats


def _slots_bwd_cuda(grad, stats, samples, temperature, labels, valid, table,
                    mask, ptable, pmask, pids, use_packed):
    _aligned(samples, table, ptable)
    _lib.require(labels.shape[0] == MAX_SLOTS,
                 f"pixel_text_ce_slots: {MAX_SLOTS} label slots expected")
    N, D = samples.shape
    dx = torch.empty_like(samples)
    if N == 0:
        return dx, torch.zeros_like(temperature)
    coeff = grad.float().reshape(()).contiguous()
    dtau = samples.new_empty(N, dtype=torch.float32)
    rows, rows_t, ids, count = member_rows(table, mask, ptable, pmask, pids,
                                           use_packed)
    R = rows.shape[0]
    # workspaces: delta [N, whole class tiles] in bf16, the row scales and
    # each slot's coefficient of a non-member label's row
    delta = samples.new_empty((N, delta_pitch(R)))
    rs = samples.new_empty(N, dtype=torch.float32)
    coef = samples.new_empty((MAX_SLOTS, N), dtype=torch.float32)
    K = 0 if ptable is None else ptable.shape[0]
    _lib.check(_lib.library().rc_pixel_text_ce_slots_bwd(
        samples.data_ptr(), temperature.data_ptr(), coeff.data_ptr(),
        labels.data_ptr(), valid.data_ptr(), N, D, rows.data_ptr(),
        rows_t.data_ptr(), rows_t.shape[1], ids.data_ptr(), count.data_ptr(),
        R, table.data_ptr(), mask.data_ptr(), table.shape[0], _ptr(ptable),
        _ptr(pmask), _ptr(pids), K, _ptr(use_packed), stats.data_ptr(),
        delta.data_ptr(), delta.shape[1], rs.data_ptr(), coef.data_ptr(),
        dx.data_ptr(), dtau.data_ptr(), _lib.stream_of(samples)),
        "pixel_text_ce_slots[bwd]")
    return dx, dtau.sum() / temperature


def _fwd_cuda(samples, temperature, labels, valid, table, mask, ptable,
              pmask, pids, use_packed):
    _aligned(samples, table, ptable)
    N, D = samples.shape
    stats = samples.new_empty((2, N), dtype=torch.float32)
    if N == 0:
        return samples.new_zeros((), dtype=torch.float32), stats
    ce = samples.new_empty(N, dtype=torch.float32)
    lib, stream = _lib.library(), _lib.stream_of(samples)
    K = 0 if ptable is None else ptable.shape[0]
    tc = tc_route(samples, ptable, labels.shape[0])
    if tc:
        # the tensor-core kernel, and beside it the member-only kernel,
        # which returns at once unless the flag selects the full table: one
        # of the two writes the CE and the row statistics
        _lib.check(lib.rc_pixel_text_ce_tc_fwd(
            samples.data_ptr(), temperature.data_ptr(), labels.data_ptr(),
            valid.data_ptr(), labels.shape[0], N, D, ptable.data_ptr(),
            pmask.data_ptr(), pids.data_ptr(), K, use_packed.data_ptr(),
            ce.data_ptr(), stats.data_ptr(), stream),
            "pixel_text_ce_tc[fwd]")
    table_t, ids, count = member_table(table, mask, ptable, pmask, pids,
                                       use_packed)
    code = lib.rc_pixel_text_ce_members_fwd(
        samples.data_ptr(), int(samples.dtype == torch.bfloat16),
        temperature.data_ptr(), labels.data_ptr(), valid.data_ptr(),
        labels.shape[0], N, D, table_t.data_ptr(), table_t.shape[1],
        ids.data_ptr(), count.data_ptr(), mask.data_ptr(), table.shape[0],
        _ptr(pmask), _ptr(pids), K, _ptr(use_packed), int(tc),
        ce.data_ptr(), stats.data_ptr(), stream)
    _lib.check(code, "pixel_text_ce[fwd]")
    return ce.sum(), stats


def _bwd_cuda(grad, stats, samples, temperature, labels, valid, table, mask,
              ptable, pmask, pids, use_packed):
    _aligned(samples, table, ptable)
    N, D = samples.shape
    dx = torch.empty_like(samples)
    if N == 0:
        return dx, torch.zeros_like(temperature)
    coeff = grad.float().reshape(()).contiguous()
    dtau = samples.new_empty(N, dtype=torch.float32)
    lib, stream = _lib.library(), _lib.stream_of(samples)
    K = 0 if ptable is None else ptable.shape[0]
    tc = tc_route(samples, ptable, labels.shape[0])
    if tc:
        ptable_t = transposed_table(ptable)
        _lib.check(lib.rc_pixel_text_ce_tc_bwd(
            samples.data_ptr(), temperature.data_ptr(), coeff.data_ptr(),
            labels.data_ptr(), valid.data_ptr(), labels.shape[0], N, D,
            ptable.data_ptr(), ptable_t.data_ptr(),
            pmask.data_ptr(), pids.data_ptr(), K, use_packed.data_ptr(),
            dx.data_ptr(), dtau.data_ptr(), stream), "pixel_text_ce_tc[bwd]")
    # the member-only backward (returning at once where the tensor-core
    # kernel writes): its delta and d_emb slices live in a workspace
    table_t, ids, count = member_table(table, mask, ptable, pmask, pids,
                                       use_packed)
    work = _lib.workspace("rc_pixel_text_ce_workspace", samples,
                          table_t.shape[1] + D, N)
    code = lib.rc_pixel_text_ce_bwd(
        samples.data_ptr(), int(samples.dtype == torch.bfloat16),
        temperature.data_ptr(), coeff.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), labels.shape[0], N, D, table_t.data_ptr(),
        table_t.shape[1], ids.data_ptr(), count.data_ptr(), table.data_ptr(),
        mask.data_ptr(), table.shape[0], _ptr(ptable), _ptr(pmask),
        _ptr(pids), K, _ptr(use_packed), int(tc), stats.data_ptr(),
        dx.data_ptr(), dtau.data_ptr(), _ptr(work), stream)
    _lib.check(code, "pixel_text_ce[bwd]")
    return dx, dtau.sum() / temperature


_ARGS = ("Tensor samples, Tensor temperature, Tensor labels, Tensor valid, "
         "Tensor table, Tensor mask, Tensor? packed_table, "
         "Tensor? packed_mask, Tensor? packed_ids, Tensor? use_packed")


def _fake_forward(samples, *rest):
    return (samples.new_empty((), dtype=torch.float32),
            samples.new_empty((2, samples.shape[0]), dtype=torch.float32))


def _fake_backward(grad, stats, samples, temperature, *rest):
    return torch.empty_like(samples), torch.empty_like(temperature)


def _setup_context(ctx, inputs, output):
    # the row statistics take no gradient, and no zeros are made for one
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(output[1], *[t for t in inputs if t is not None])
    ctx.present = [t is not None for t in inputs]


def _define_pair(name: str, forward, backward):
    """``rangeclip::<name>`` and ``rangeclip::<name>_backward``, the second
    registered as the first's gradient."""
    fwd_op = _lib.define_op(f"{name}({_ARGS}) -> (Tensor, Tensor)", forward,
                            None, _fake_forward)
    bwd_op = _lib.define_op(
        f"{name}_backward(Tensor grad, Tensor stats, {_ARGS}) -> "
        "(Tensor, Tensor)", backward, None, _fake_backward)

    def _backward(ctx, grad, _grad_stats):
        stats, *saved = ctx.saved_tensors
        saved = iter(saved)
        inputs = [next(saved) if p else None for p in ctx.present]
        dx, dt = bwd_op(grad, stats, *inputs)
        return (dx, dt) + (None,) * 8

    torch.library.register_autograd(f"rangeclip::{name}", _backward,
                                    setup_context=_setup_context,
                                    lib=_lib.OPS)
    return fwd_op, bwd_op


pixel_text_ce_op, pixel_text_ce_backward_op = _define_pair(
    "pixel_text_ce", _fwd_cuda, _bwd_cuda)
pixel_text_ce_slots_op, pixel_text_ce_slots_backward_op = _define_pair(
    "pixel_text_ce_slots", _slots_fwd_cuda, _slots_bwd_cuda)
