"""The UNet's layers over a 'spatial' grid axis: each rank holds a block of
every feature map's rows, and a layer that reads across a block's edge
fetches the rows it needs from their owners (no JAX counterpart: GSPMD
inserts these halo exchanges itself, ``rangeclip_tpu/parallel/mesh.py``).

Row ownership is one rule at every level, from global coordinates:
``parallel/mesh.owned_rows`` (GSPMD's ``ceil(h / n)`` tiles; a rank may own
no row of a deep level and still joins every collective).  A layer's
output rows are the rows its rank owns at the output level; the input rows
they read follow from the layer's stride, padding and dilation
(:func:`input_rows`).  Rows above the image's global top and below its
bottom are the layer's padding (zeros for a convolution, -inf for the max
pool); a shard's edge is never padded.

One transport, :class:`_Fetch`: ``all_reduce`` only, so that ranks sharing
one card over gloo can run it.  Forward, every owner writes the rows that
another rank reads into one zero buffer, which is summed as int32 bits
(``mesh.all_reduce_exact``: the values travel exactly); backward, every
rank writes the gradient of the rows it read from others into a zero f32
(f64) buffer, the sum adds the readers' gradients of a row, and the owner
adds it to its own.  Which rows travel is computed alike on every rank
from the global shapes, so a layer whose rows all lie at home on every
rank runs no collective.

:class:`RowShards` holds a forward's levels (the global height of each
width) and is what ``ops/blocks.spatial_rows`` routes the model's
convolutions, max pool, transposed convolutions, bilinear resizes,
normalisation statistics and means through, and what gathers the MiT's
attention map whole (:meth:`RowShards.whole`); :func:`sharded_rows` enters
it for the step, predict and validation.  A statistic over rows is a differentiable sum
over the 'spatial' group (:class:`_SpatialSum`: its backward is the same
sum of the readers' gradients).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops import blocks
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    all_reduce_exact,
    all_reduce_sum,
    owned_rows,
)

Window = Tuple[int, int]


def input_rows(o0: int, o1: int, kernel: int, stride: int = 1,
               padding: int = 0, dilation: int = 1) -> Window:
    """Global input rows ``[a, b)`` that output rows ``[o0, o1)`` of a
    convolution or pooling window read (``a < 0`` and ``b`` past the
    height are padding); ``(a, a)`` for no output row."""
    a = o0 * stride - padding
    if o1 <= o0:
        return a, a
    return a, (o1 - 1) * stride - padding + dilation * (kernel - 1) + 1


def transposed_input_rows(o0: int, o1: int, kernel: int, stride: int,
                          padding: int, height: int) -> Window:
    """Input rows ``[a, b)`` (within ``[0, height)``) whose transposed
    convolution reaches output rows ``[o0, o1)``: output row ``o`` takes
    input row ``i`` where ``0 <= o + padding - i * stride < kernel``."""
    if o1 <= o0:
        return 0, 0
    a = max(-((kernel - 1 - o0 - padding) // stride), 0)
    b = min((o1 - 1 + padding) // stride + 1, height)
    return a, max(a, b)


def _split(window: Window, own: Window, height: int):
    """``window`` cut into (fill rows above, remote rows before the own
    ones, own rows, remote rows after, fill rows below), each a range of
    global rows."""
    a, b = window
    lo, hi = own
    need_lo, need_hi = max(a, 0), min(b, height)
    top = max(0, min(b, 0) - a)
    bottom = max(0, b - max(a, height))
    if need_hi <= need_lo:
        return top, (0, 0), (0, 0), (0, 0), bottom
    span = lambda s, e: (s, max(s, e))  # noqa: E731
    before = span(need_lo, min(need_hi, lo))
    mid = span(max(need_lo, lo), min(need_hi, hi))
    after = span(max(need_lo, hi), need_hi)
    return top, before, mid, after, bottom


def remote_rows(height: int, n: int, windows: Sequence[Window]) -> List[int]:
    """The sorted global rows that some rank's window reads from another
    rank: the rows that travel."""
    rows = set()
    for r, window in enumerate(windows):
        _, before, _, after, _ = _split(window, owned_rows(height, n, r),
                                        height)
        rows.update(range(*before))
        rows.update(range(*after))
    return sorted(rows)


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s memory format (channels_last stays so)."""
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _rows(x: torch.Tensor, index: Sequence[int]) -> torch.Tensor:
    return x.index_select(2, torch.tensor(index, dtype=torch.long,
                                          device=x.device))


class _Fetch(torch.autograd.Function):
    """Rows ``windows[index]`` of the ``height``-row map whose rows each
    rank of ``group`` holds its :func:`owned_rows` of (NCHW ``x``), fill
    outside the map; backward returns each fetched row's gradient to its
    owner.  Every rank of the group calls it with the same ``windows``."""

    @staticmethod
    def forward(ctx, x, height, windows, index, group, fill):
        n = len(windows)
        own = owned_rows(height, n, index)
        rows = remote_rows(height, n, windows)
        pos = {j: i for i, j in enumerate(rows)}
        N, C, _, W = x.shape
        buf = x.new_zeros((N, C, len(rows), W))
        mine = [j for j in rows if own[0] <= j < own[1]]
        if mine:
            buf.index_copy_(2, torch.tensor([pos[j] for j in mine],
                                            device=x.device),
                            _rows(x, [j - own[0] for j in mine]))
        buf = all_reduce_exact(buf, group)
        top, before, mid, after, bottom = _split(windows[index], own, height)
        pieces = [x.new_full((N, C, top, W), fill),
                  _rows(buf, [pos[j] for j in range(*before)]),
                  x[:, :, mid[0] - own[0]:mid[1] - own[0]],
                  _rows(buf, [pos[j] for j in range(*after)]),
                  x.new_full((N, C, bottom, W), fill)]
        ctx.plan = (own, rows, pos, mine, (top, before, mid, after))
        ctx.group, ctx.shape, ctx.dtype = group, x.shape, x.dtype
        return _like(torch.cat(pieces, dim=2), x)

    @staticmethod
    def backward(ctx, g):
        own, rows, pos, mine, (top, before, mid, after) = ctx.plan
        N, C, h, W = ctx.shape
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        # the window's rows: fill, before, own, after, fill
        at_mid = top + before[1] - before[0]
        at_after = at_mid + mid[1] - mid[0]
        gbuf = g.new_zeros((N, C, len(rows), W))
        for span, start in ((before, top), (after, at_after)):
            if span[1] > span[0]:
                gbuf.index_copy_(2, torch.tensor(
                    [pos[j] for j in range(*span)], device=g.device),
                    g[:, :, start:start + span[1] - span[0]])
        all_reduce_sum([gbuf], ctx.group)
        dx = g.new_zeros((N, C, h, W))
        dx[:, :, mid[0] - own[0]:mid[1] - own[0]] = g[:, :, at_mid:at_after]
        if mine:
            dx.index_add_(2, torch.tensor([j - own[0] for j in mine],
                                          device=g.device),
                          _rows(gbuf, [pos[j] for j in mine]))
        return dx.to(ctx.dtype), None, None, None, None, None


class _SpatialSum(torch.autograd.Function):
    """``x`` summed over the 'spatial' group, every rank using the sum;
    backward, the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        all_reduce_sum([out], group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_sum([g], ctx.group)
        return g, None


class RowShards:
    """One forward's rows over a grid's 'spatial' axis: this rank's index
    along it, its group, and the global height of every level, keyed by
    the level's width (the width is never sharded).  The input level is
    ``(height, width)``; each layer records the level it makes (two levels
    of one width and different heights are refused)."""

    def __init__(self, grid: Grid, height: int, width: int):
        self.n = grid.n_spatial
        self.index = grid.s
        self.group = grid.group("spatial")
        self.heights = {int(width): int(height)}

    # levels --------------------------------------------------------------

    def height(self, width: int) -> int:
        """The global height of the level ``width`` wide."""
        try:
            return self.heights[int(width)]
        except KeyError:
            raise ValueError(f"no level {width} wide in this forward "
                             f"(levels {self.heights})") from None

    def record(self, width: int, height: int) -> None:
        known = self.heights.setdefault(int(width), int(height))
        if known != height:
            raise ValueError(
                f"two levels {width} wide, of {known} and {height} rows: "
                "a spatial grid keys its levels by width (use a wider "
                "image)")

    def owned(self, height: int, index: Optional[int] = None) -> Window:
        return owned_rows(height, self.n, self.index if index is None
                          else index)

    def shape(self, x: torch.Tensor) -> Tuple[int, int]:
        """The global (height, width) of NCHW ``x``."""
        return self.height(x.shape[3]), x.shape[3]

    # the transport ---------------------------------------------------------

    def fetch(self, x: torch.Tensor, height: int, windows: Sequence[Window],
              fill: float = 0.0) -> torch.Tensor:
        """Rows ``windows[self.index]`` of the map this level's ranks hold
        (:class:`_Fetch`); when no rank reads a row it does not own, a
        local slice and fill rows, with no collective."""
        windows = tuple(tuple(w) for w in windows)
        if remote_rows(height, self.n, windows):
            return _Fetch.apply(x, height, windows, self.index, self.group,
                                fill)
        own = self.owned(height)
        top, _, mid, _, bottom = _split(windows[self.index], own, height)
        x_mid = x[:, :, mid[0] - own[0]:mid[1] - own[0]]
        if not top and not bottom:
            return x_mid
        N, C, _, W = x.shape
        return _like(torch.cat([x.new_full((N, C, top, W), fill), x_mid,
                                x.new_full((N, C, bottom, W), fill)], 2), x)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every row of NCHW ``x``'s level on every rank, in global order
        (its owners' rows through :class:`_Fetch`: each row's gradient,
        summed over the ranks that read it, returns to its owner).  A rank
        that owns no row still takes part."""
        height, _ = self.shape(x)
        return self.fetch(x, height, [(0, height)] * self.n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the spatial ranks, differentiably."""
        return x if self.n == 1 else _SpatialSum.apply(x, self.group)

    # layers ----------------------------------------------------------------

    def _windows(self, h_out: int, rows) -> List[Window]:
        return [rows(*self.owned(h_out, r)) for r in range(self.n)]

    def _empty(self, window: torch.Tensor, rows: int, layer) -> torch.Tensor:
        """No output row here: ``layer`` on ``rows`` fill rows, sliced to
        none, so that the graph (and its backward's collectives) is every
        rank's."""
        window = F.pad(window, (0, 0, 0, rows - window.shape[2]))
        return layer(window)[:, :, :0]

    def conv2d(self, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride, padding, dilation,
               groups: int) -> torch.Tensor:
        """``F.conv2d`` on this rank's output rows: zero padding at the
        image's top and bottom, the halo from the neighbours."""
        (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                        _pair(dilation))
        kh, kw = weight.shape[2:]
        layer = lambda t: F.conv2d(t, weight, bias, (sh, sw),  # noqa: E731
                                   (0, pw), (dh, dw), groups)
        if kh == 1 and sh == 1 and ph == 0:  # row by row: nothing crosses
            return layer(x) if x.shape[2] else self._empty(x, 1, layer)
        h_in, W = self.shape(x)
        h_out = (h_in + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        self.record((W + 2 * pw - dw * (kw - 1) - 1) // sw + 1, h_out)
        window = self.fetch(x, h_in, self._windows(
            h_out, lambda o0, o1: input_rows(o0, o1, kh, sh, ph, dh)))
        o0, o1 = self.owned(h_out)
        if o1 <= o0:
            return self._empty(window, dh * (kh - 1) + 1, layer)
        return layer(window)

    def max_pool2d(self, x: torch.Tensor, kernel: int, stride: int,
                   padding: int) -> torch.Tensor:
        """``F.max_pool2d`` on this rank's output rows, -inf above and
        below the image."""
        h_in, W = self.shape(x)
        h_out = (h_in + 2 * padding - kernel) // stride + 1
        self.record((W + 2 * padding - kernel) // stride + 1, h_out)
        window = self.fetch(x, h_in, self._windows(
            h_out, lambda o0, o1: input_rows(o0, o1, kernel, stride,
                                             padding)), -math.inf)
        layer = lambda t: F.max_pool2d(t, kernel, stride,  # noqa: E731
                                       (0, padding))
        o0, o1 = self.owned(h_out)
        if o1 <= o0:
            return self._empty(window, kernel, layer)
        return layer(window)

    def conv_transpose2d(self, x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], stride: int,
                         padding: int, output_padding: int) -> torch.Tensor:
        """``F.conv_transpose2d`` (IOHW ``weight``, no dilation or groups)
        on this rank's output rows: the input rows that reach them, the
        transposed convolution of that window, its rows cut to the owned
        ones (rows no input reaches, from ``output_padding``, are the
        bias)."""
        h_in, W = self.shape(x)
        kh, kw = weight.shape[2:]
        h_out = (h_in - 1) * stride - 2 * padding + kh + output_padding
        self.record((W - 1) * stride - 2 * padding + kw + output_padding,
                    h_out)
        window = self.fetch(x, h_in, self._windows(
            h_out, lambda o0, o1: transposed_input_rows(
                o0, o1, kh, stride, padding, h_in)))
        o0, o1 = self.owned(h_out)
        a, _ = transposed_input_rows(o0, o1, kh, stride, padding, h_in)
        if window.shape[2] == 0:
            window = F.pad(window, (0, 0, 0, 1))
        y = F.conv_transpose2d(window, weight, bias, stride=stride,
                               padding=(0, padding),
                               output_padding=(0, output_padding))
        r0 = o0 - a * stride + padding
        r1 = r0 + max(o1 - o0, 0)
        if o1 > o0 and r1 > y.shape[2]:  # rows past every input's reach
            N, C, _, Wo = y.shape
            fill = (y.new_zeros((N, C, r1 - y.shape[2], Wo)) if bias is None
                    else bias.reshape(1, -1, 1, 1).expand(
                        N, C, r1 - y.shape[2], Wo))
            y = _like(torch.cat([y, fill], 2), y)
        return y[:, :, r0:r1]

    def resize_bilinear_align_corners(self, x: torch.Tensor, size
                                      ) -> torch.Tensor:
        """The bilinear align_corners resize of NCHW ``x`` to the global
        ``size``, in f32 and back (``ops/resize``): the owned output rows
        of ``F.interpolate`` over the map of the input rows they read,
        zero elsewhere, so that each kept row is the whole map's."""
        h_in, W = self.shape(x)
        h_out, w_out = int(size[0]), int(size[1])
        if (h_in, W) == (h_out, w_out):
            return x
        self.record(w_out, h_out)
        scale = (h_in - 1) / (h_out - 1) if h_out > 1 else 0.0

        def rows(o0, o1):
            if o1 <= o0:
                return 0, 0
            return (max(int(math.floor(o0 * scale)) - 1, 0),
                    min(int(math.floor((o1 - 1) * scale)) + 3, h_in))

        windows = self._windows(h_out, rows)
        window = self.fetch(x, h_in, windows).float()
        a = windows[self.index][0]
        full = F.pad(window, (0, 0, a, h_in - a - window.shape[2]))
        out = F.interpolate(full, size=(h_out, w_out), mode="bilinear",
                            align_corners=True)
        o0, o1 = self.owned(h_out)
        return out[:, :, o0:o1].to(x.dtype)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of NCHW ``x`` over its global rows and columns, [N, C]
        in ``x``'s dtype: the local sums in f32 (f64 for f64) summed over
        the spatial ranks, over the global count."""
        h, W = self.shape(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        return (self.sum(x.to(acc).sum(dim=(2, 3))) / (h * W)).to(x.dtype)

    def instance_norm(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """``F.instance_norm`` (no affine, biased variance) of f32 NCHW
        ``x`` over each image's global rows: the mean, then the centred
        sum of squares, each summed over the spatial ranks."""
        h, W = self.shape(x)
        count = h * W
        mean = self.sum(x.sum(dim=(2, 3), keepdim=True)) / count
        centred = x - mean
        var = self.sum(centred.square().sum(dim=(2, 3), keepdim=True)) / count
        return centred * torch.rsqrt(var + eps)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@contextlib.contextmanager
def sharded_rows(grid: Optional[Grid], shape):
    """While entered, the model's layers run on this rank's rows of a
    forward whose input is ``shape = (height, width)`` globally
    (``ops/blocks.spatial_rows``); a grid without a spatial axis (or
    ``None``) changes nothing.  Yields the :class:`RowShards`, or None."""
    if grid is None or grid.n_spatial == 1:
        yield None
        return
    shards = RowShards(grid, *shape)
    with blocks.spatial_rows(shards):
        yield shards


def active_shards(grid: Optional[Grid]) -> Optional[RowShards]:
    """The :class:`RowShards` a loss on ``grid``'s rows reads its global
    heights and owned rows from: None without a spatial axis; raises if
    the forward's :func:`sharded_rows` is not entered."""
    if grid is None or grid.n_spatial == 1:
        return None
    if blocks._SPATIAL is None:
        raise ValueError("a grid with a 'spatial' axis runs its forward and "
                         "loss inside halo.sharded_rows")
    return blocks._SPATIAL
