"""The live rows of a score table, gathered on the device for the CUDA-core
scoring kernels (``pixel_text_topk``'s fp32 kernel and ``pixel_text_ce``'s
member-only forward and backward) and, in bf16, for ``pixel_text_ce``'s
tensor-core kernels past 4 label slots: rows that cannot change the answer
are left out with no host sync, and the kernels read the live count from
device memory.

:func:`live_rows` and :func:`live_rows_bf16` launch ``csrc/live_rows.cu``
(one launch, counted as ``live_rows``) on CUDA tensors; :func:`live_table`
and :func:`live_table_bf16` are their plain versions, which CPU tensors
run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rangeclip_tpu_torch.ops.kernels import _lib

Gathered = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _in_order(table: torch.Tensor, ids: torch.Tensor,
              live: Optional[torch.Tensor]):
    """(the rows of ``table`` with the live ones first, each part in table
    order; their ids; the live count [1] int32)."""
    if live is None:
        live = ids >= 0
    order = torch.argsort((~live).to(torch.uint8), stable=True)
    return (table.index_select(0, order), ids.index_select(0, order),
            live.sum(dtype=torch.int32).reshape(1))


def live_table(table: torch.Tensor, ids: torch.Tensor,
               live: Optional[torch.Tensor] = None) -> Gathered:
    """The live rows of ``table`` [C, D] first, in ascending order, then the
    others: (that table transposed, [D, Cp] f32 with Cp = C rounded up to a
    multiple of 4 (16-byte rows; the padding zero); ``ids`` [C] in that
    order; the live count [1] int32), on the table's device, with no host
    sync.  ``live`` [C] bool defaults to ``ids >= 0`` (masked rows have id
    -1).  A bf16 table widens exactly."""
    rows, ids, count = _in_order(table, ids, live)
    C, D = table.shape
    table_t = table.new_zeros((D, -(-C // 4) * 4), dtype=torch.float32)
    table_t[:, :C] = rows.T
    return table_t, ids, count


def live_table_bf16(table: torch.Tensor, ids: torch.Tensor,
                    live: Optional[torch.Tensor] = None):
    """:func:`live_table` of a bf16 table in the tensor-core kernels' forms:
    (the rows in that order [C, D]; the same transposed, [D, Ct] with Ct =
    C rounded up to a multiple of 8, the padding zero; the ids; the live
    count), each row copied exactly."""
    rows, ids, count = _in_order(table, ids, live)
    C, D = table.shape
    rows_t = rows.new_zeros((D, -(-C // 8) * 8))
    rows_t[:, :C] = rows.T
    return rows, rows_t, ids, count


Second = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def live_rows(table: torch.Tensor, ids: Optional[torch.Tensor] = None,
              live: Optional[torch.Tensor] = None,
              second: Optional[Second] = None) -> Gathered:
    """:func:`live_table` of ``table`` [C, D] (f32 or bf16) with ``ids`` [C]
    int32 (default 0..C-1) and ``live`` [C] (bool or int32; default ``ids
    >= 0``).  ``second`` = (table [K, D], ids [K] int32, live [K] int32,
    flag [1] int32 on the device) adds a second table: the flag selects
    which of the two has live rows (the second where it is non-zero), and
    that one comes first in the concatenation that is gathered.  CUDA
    tensors take one launch of the kernel; CPU tensors run
    :func:`live_table` (the flag read on the host)."""
    return _gather(table, ids, live, second, bf16_rows=False)


def live_rows_bf16(table: torch.Tensor, ids: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None,
                   second: Optional[Second] = None):
    """:func:`live_rows` of bf16 tables in the tensor-core kernels' forms:
    (rows [R, D], rows_t [D, Rt], ids [R], count [1]) as
    :func:`live_table_bf16` gives them over the rows' concatenation (R = C
    plus the second table's K), the selected table first; no host sync.
    CUDA tensors take one launch of the kernel (counted as ``live_rows``);
    CPU tensors run :func:`live_table_bf16`."""
    _lib.require(table.dtype == torch.bfloat16,
                 f"live_rows_bf16: bf16 rows, got {table.dtype}")
    return _gather(table, ids, live, second, bf16_rows=True)


def _gather(table, ids, live, second, bf16_rows: bool):
    C, D = table.shape
    kind = _lib.require_device("live_rows", table,
                               *[t for t in (ids, live) if t is not None],
                               *(second or ()))
    if kind == "cpu":
        plain = live_table_bf16 if bf16_rows else live_table
        ids = torch.arange(C, dtype=torch.int32) if ids is None else ids
        live = (ids >= 0) if live is None else live != 0
        if second is None:
            return plain(table, ids, live)
        table_b, ids_b, live_b, flag = second
        on = bool(flag.reshape(()))
        parts = [(table, ids, live & (not on)),
                 (table_b, ids_b, (live_b != 0) & on)]
        if on:
            parts.reverse()
        return plain(*(torch.cat(p) for p in zip(*parts)))
    _lib.require(ids is not None or live is not None,
                 "live_rows: give the ids or the live mask")
    _lib.require(table.dtype in (torch.float32, torch.bfloat16),
                 f"live_rows: f32 or bf16 rows, got {table.dtype}")
    _lib.require(all(t is None or t.is_contiguous()
                     for t in (table, ids, live, *(second or ()))),
                 "live_rows: contiguous tensors expected")
    rows = C + (0 if second is None else second[0].shape[0])
    out_ids = table.new_empty(rows, dtype=torch.int32)
    count = table.new_empty(1, dtype=torch.int32)
    if live is not None and live.dtype != torch.int32:
        live = live.to(torch.int32)
    b = b_ids = b_live = flag = None
    if second is not None:
        b, b_ids, b_live, flag = second
        _lib.require(b.dtype == table.dtype and b.shape[1] == D
                     and b_ids.dtype == torch.int32
                     and b_live.dtype == torch.int32,
                     "live_rows: the second table [K, D] in the first's "
                     "dtype, int32 ids and live mask")
    segments = (table.data_ptr(), _ptr(ids), _ptr(live), C, _ptr(b),
                _ptr(b_ids), _ptr(b_live), 0 if b is None else b.shape[0],
                _ptr(flag), D)
    lib, stream = _lib.library(), _lib.stream_of(table)
    if bf16_rows:
        out = (table.new_empty((rows, D)),
               table.new_empty((D, -(-rows // 8) * 8)))
        code = lib.rc_live_rows_bf16(
            *segments, out[0].data_ptr(), out[1].data_ptr(), out[1].shape[1],
            out_ids.data_ptr(), count.data_ptr(), stream)
    else:
        out = (table.new_empty((D, -(-rows // 4) * 4), dtype=torch.float32),)
        code = lib.rc_live_rows(
            *segments, int(table.dtype == torch.bfloat16), out[0].data_ptr(),
            out[0].shape[1], out_ids.data_ptr(), count.data_ptr(), stream)
    _lib.check(code, "live_rows")
    return (*out, out_ids, count)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
