"""The live rows of a score table, gathered on the device for the CUDA-core
scoring kernels (``pixel_text_topk``'s fp32 kernel and ``pixel_text_ce``'s
member-only forward): rows that cannot change the answer are left out with
no host sync, and the kernels read the live count from device memory."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def live_table(table: torch.Tensor, ids: torch.Tensor,
               live: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The live rows of ``table`` [C, D] first, in ascending order, then the
    others: (that table transposed, [D, Cp] f32 with Cp = C rounded up to a
    multiple of 4 (16-byte rows; the padding zero); ``ids`` [C] in that
    order; the live count [1] int32), on the table's device, with no host
    sync.  ``live`` [C] bool defaults to ``ids >= 0`` (masked rows have id
    -1).  A bf16 table widens exactly."""
    if live is None:
        live = ids >= 0
    order = torch.argsort((~live).to(torch.uint8), stable=True)
    C, D = table.shape
    table_t = table.new_zeros((D, -(-C // 4) * 4), dtype=torch.float32)
    table_t[:, :C] = table.index_select(0, order).T
    return (table_t, ids.index_select(0, order),
            live.sum(dtype=torch.int32).reshape(1))
