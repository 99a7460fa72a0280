"""Device grids and the process group (``rangeclip_tpu/parallel/mesh.py``).

JAX names one mesh of devices and lets XLA insert the collectives.  The
port keeps the things that mesh is used for, each in its own form:

* :func:`make_mesh`: an ``[n_data][n_model]`` grid of ``torch.device``s
  that one process drives (``parallel/predict.py``, ``cli/serve
  --data_parallel``).  A device may stand in the grid more than once: four
  CPU cells stand in for JAX's virtual CPU devices in the tests, and
  ``[cuda:0] * 4`` runs the grid on one card.  It takes no 'spatial' axis:
  one process has no transport for the convolutions' halo rows, so a
  spatial axis is a process grid (:func:`make_grid`).
* :func:`init_distributed` and the helpers after it: the process group that
  ``--distributed`` training runs over, one process per GPU as ``torchrun``
  starts them (JAX runs one process over all of a host's devices).  The
  batch is sharded by the loader (``data/loader.py`` ``shard_id``,
  ``num_shards``); the global batch is the ranks' rows concatenated in rank
  order (JAX's process-major ``shard_batch``), :func:`row_block` is this
  rank's block of an array over the global batch and :func:`gather_rows`
  the global array from every rank's block.  ``replicate`` broadcasts rank
  0's parameters and buffers once.
* :func:`make_grid`: JAX's three-axis mesh ``("data", "spatial",
  "model")`` over the ranks of the process group, rank-major as JAX
  reshapes its mesh: rank ``(d * n_spatial + s) * n_model + m``.  A rank
  holds data block ``d`` of the images, spatial block ``s`` of their rows
  (``parallel/halo.py``: the halo rows the convolutions read are exchanged
  between the ranks of a 'spatial' group) and model slice ``m`` of the
  class tables (:func:`shard_class_tables`).  A plain process group is the
  grid ``(world, 1, 1)`` (:func:`as_grid`).

Collectives are explicit (:func:`all_reduce_sum`, :func:`all_reduce_mean`,
:func:`broadcast`), in one flattened bucket per dtype, and use only
``all_reduce``, ``broadcast`` and ``barrier``: the three that gloo also
takes on CUDA tensors, so that several ranks can share one card over gloo
where NCCL refuses them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from rangeclip_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[r][c]``: the device of data row ``r`` and model column
    ``c``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the grid once, in row-major order."""
        seen: List[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def _canonical(device) -> torch.device:
    """``torch.device(device)`` with a CUDA index filled in, so that
    ``cuda`` and ``cuda:0`` name one cell."""
    device = resolve_device(str(device))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices() -> List[torch.device]:
    """Every CUDA device of this host; raises without CUDA (the CPU is used
    only when a caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass the "
                           "devices (e.g. [torch.device('cpu')] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              n_spatial: int = 1) -> Mesh:
    """The first ``n_data * n_model`` of ``devices`` (default: every local
    CUDA device) as an ``[n_data][n_model]`` grid, row-major as JAX lays
    its mesh out; ``n_data`` defaults to as many rows as fit.  A 'spatial'
    axis is refused: its halo rows travel between processes, so it is a
    process grid (:func:`make_grid`)."""
    if n_spatial != 1:
        raise ValueError(
            "a 'spatial' axis exchanges the convolutions' halo rows between "
            "processes, which a grid driven by one process cannot: build it "
            "with parallel.mesh.make_grid over a process group (one rank a "
            "cell)")
    devices = [_canonical(d) for d in (local_devices() if devices is None
                                       else devices)]
    if n_data is None:
        n_data = len(devices) // (n_model * n_spatial)
    total = n_data * n_model * n_spatial
    assert 0 < total <= len(devices), (
        f"mesh data={n_data} x spatial={n_spatial} x model={n_model} does "
        f"not fit {len(devices)} devices (model*spatial alone may exceed "
        "the device count)"
    )
    return Mesh(tuple(tuple(devices[r * n_model:(r + 1) * n_model])
                      for r in range(n_data)))


# --- the process group ---------------------------------------------------


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: str = "cuda") -> torch.device:
    """Join the process group (``jax.distributed.initialize``); returns
    this rank's device.

    With ``coordinator_address`` (``host:port``, or any ``scheme://`` init
    method such as ``file://``) the world is ``num_processes`` ranks and
    this one is ``process_id``.  Without it torchrun's environment names
    them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``device`` 'cuda' puts the rank on ``cuda:LOCAL_RANK`` (without
    ``LOCAL_RANK``: the rank modulo the local device count, so that ranks
    on one card share it), over NCCL; 'cpu' over gloo.  ``backend``
    overrides the choice (gloo on CUDA tensors lets several ranks share one
    card, which NCCL refuses); NCCL on the CPU is refused, and nothing is
    switched silently."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world_size, rank_id = num_processes, process_id
    else:
        assert num_processes is None and process_id is None, (
            "--num_processes/--process_id have no effect without "
            "--coordinator_address (outside a managed cluster all "
            "three must be given together)"
        )
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "--distributed without --coordinator_address reads "
                f"torchrun's environment, which lacks {missing}")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank_id = int(os.environ["RANK"])
    if kind == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", rank_id % max(1, torch.cuda.device_count())))
        rank_device = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(rank_device)
    elif kind == "cpu":
        rank_device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r} (use cuda or cpu)")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank_id)
    return rank_device


def shutdown_distributed() -> None:
    """Leave the process group, if one is open."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank(group) if _initialized() else 0


def world(group=None) -> int:
    """The ranks in ``group`` (1 outside a process group)."""
    import torch.distributed as dist

    return dist.get_world_size(group) if _initialized() else 1


def is_main() -> bool:
    """Rank 0 of the world: the rank that logs and writes summaries and
    checkpoints."""
    return rank() == 0


def barrier(group=None) -> None:
    import torch.distributed as dist

    if world(group) > 1:
        dist.barrier(group)


def _buckets(tensors: Iterable[torch.Tensor]):
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def _collective(tensors: Iterable[torch.Tensor], op) -> None:
    """Run ``op(flat)`` on one flattened copy per dtype, then copy each
    piece back into its tensor (any memory format)."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view(t.shape))


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its sum over the ranks of
    ``group``; every rank ends with the same bits.  A group of one is left
    alone."""
    import torch.distributed as dist

    if world(group) == 1 or not tensors:
        return
    _collective(tensors, lambda flat: dist.all_reduce(
        flat, op=dist.ReduceOp.SUM, group=group))


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its mean over the ranks of
    ``group`` (a sum, then a division by the world size: gloo has no
    average).  Every rank ends with the same bits."""
    import torch.distributed as dist

    n = world(group)
    if not tensors:
        return

    def op(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)

    _collective(tensors, op)


def row_block(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` over the global batch along ``dim``:
    rows ``rank * n .. (rank + 1) * n`` of its ``world * n``."""
    n = world(group)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} global rows do not split over "
                         f"{n} ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, rank(group) * per, per)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ``[world * n, ...]`` concatenation of every rank's ``[n, ...]``
    block in rank order (an all-gather as the all-reduce of a zero buffer
    in which each rank fills its own block).  Not differentiated."""
    n = world(group)
    if n == 1:
        return x
    out = x.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
    row_block(out, group).copy_(x)
    all_reduce_sum([out], group)
    return out


def broadcast(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite each tensor, in place, with group rank 0's."""
    import torch.distributed as dist

    if world(group) == 1 or not tensors:
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    _collective(tensors, lambda flat: dist.broadcast(flat, src, group=group))


def owned_rows(height: int, n: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a ``height``-row axis that block ``index`` of
    ``n`` owns: GSPMD's tiles of ``ceil(height / n)`` rows, so the last
    blocks may be shorter or empty.  The one ownership rule of every split
    of rows or classes in the port's grids."""
    tile = -(-height // n)
    return min(index * tile, height), min((index + 1) * tile, height)


def all_reduce_exact(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over ``group`` where every byte has at most one rank
    that holds it non-zero (each rank fills its own cells of a zero
    buffer): the sum of int32 views, so the bits travel exactly (-0.0,
    NaN payloads and any dtype).  Returns the reduced tensor."""
    import torch.distributed as dist

    if world(group) == 1:
        return buf
    raw = buf.contiguous().reshape(-1).view(torch.uint8)
    nbytes = raw.numel()
    pad = -nbytes % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    ints = raw.view(torch.int32)
    dist.all_reduce(ints, op=dist.ReduceOp.SUM, group=group)
    return ints.view(torch.uint8)[:nbytes].view(buf.dtype).view(buf.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """This rank's cell of a ``data x spatial x model`` process grid
    (:func:`make_grid`): the axes' sizes, its coordinates ``(d, s, m)``
    and the process groups of its axes, ``None`` for an axis of one rank.
    ``batch`` is the ``data x spatial`` group of its model column: the
    ranks over whose pixels a loss's sums and BatchNorm's statistics are
    taken.  Every collective of the grid goes through :meth:`sum` and
    :meth:`gather`, which leave an axis of one rank alone."""

    n_data: int
    n_spatial: int
    n_model: int
    d: int
    s: int
    m: int
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "spatial": self.n_spatial,
                "model": self.n_model}

    def size(self, axis: str) -> int:
        if axis == "batch":
            return self.n_data * self.n_spatial
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's place along ``axis`` (``batch``: data-major)."""
        if axis == "batch":
            return self.d * self.n_spatial + self.s
        return {"data": self.d, "spatial": self.s, "model": self.m}[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def sum(self, tensors: Sequence[torch.Tensor], axis: str) -> None:
        """:func:`all_reduce_sum` of ``tensors`` over ``axis``, in place."""
        if self.size(axis) > 1:
            all_reduce_sum(tensors, self.groups[axis])

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
        """The concatenation along ``dim`` of the ``axis`` ranks' equal
        blocks ``x``, in their order along the axis, the bits exact
        (:func:`all_reduce_exact`).  Not differentiated."""
        n = self.size(axis)
        if n == 1:
            return x
        shape = list(x.shape)
        per = shape[dim]
        shape[dim] = n * per
        out = x.new_zeros(shape)
        out.narrow(dim, self.index(axis) * per, per).copy_(x)
        return all_reduce_exact(out, self.groups[axis])

    def image_block(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's data block of ``x``'s images along ``dim``."""
        if x.shape[dim] % self.n_data:
            raise ValueError(f"{x.shape[dim]} images do not split over "
                             f"{self.n_data} data blocks")
        per = x.shape[dim] // self.n_data
        return x.narrow(dim, self.d * per, per)

    def row_block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's spatial block of ``x``'s rows along ``dim``
        (:func:`owned_rows`)."""
        lo, hi = owned_rows(x.shape[dim], self.n_spatial, self.s)
        return x.narrow(dim, lo, hi - lo)

    def local_batch(self, batch: Dict[str, torch.Tensor],
                    batch_axis: int = 0) -> Dict[str, torch.Tensor]:
        """This rank's block of a global batch: its data block of every
        array, and its spatial block of the image rows of those with a
        height (depth [.., B, H, W, 1], segmentation [.., B, H, W]), as
        JAX's ``shard_batch`` places them.  Under a 'spatial' axis the
        height must divide by 2 x its size, so every block holds the same
        even count of rows."""
        out = {}
        for k, v in batch.items():
            v = self.image_block(v, batch_axis)
            if v.dim() >= batch_axis + 3:
                height = v.shape[batch_axis + 1]
                if self.n_spatial > 1 and height % (2 * self.n_spatial):
                    raise ValueError(f"height {height} must divide by 2x "
                                     f"the 'spatial' size {self.n_spatial}")
                v = self.row_block(v, batch_axis + 1)
            out[k] = v.contiguous()
        return out


def as_grid(group) -> Optional[Grid]:
    """``group`` as a grid: a :class:`Grid` as it is, a process group as
    the grid ``(world, 1, 1)`` over it (the global-batch step of one data
    axis), ``None`` as ``None``."""
    if group is None or isinstance(group, Grid):
        return group
    n = world(group)
    many = group if n > 1 else None
    return Grid(n, 1, 1, rank(group), 0, 0,
                {"data": many, "spatial": None, "model": None,
                 "batch": many})


def make_grid(n_data: Optional[int] = None, n_spatial: int = 1,
              n_model: int = 1) -> Optional[Grid]:
    """JAX's ``make_mesh`` over the process group: the world's first
    ``n_data * n_spatial * n_model`` ranks as a ``(data, spatial, model)``
    grid, rank ``(d * n_spatial + s) * n_model + m`` (JAX's reshape of its
    device list); ``n_data`` defaults to as many as fit.  Every rank must
    call it, in the same order as any other group it creates: it creates
    the groups of every axis (each set of ranks once; the world's own
    group where a set is the world).  A rank outside the grid gets None.
    Outside a process group the grid is the one cell ``(1, 1, 1)``."""
    import torch.distributed as dist

    size = world()
    if n_data is None:
        n_data = size // (n_model * n_spatial)
    total = n_data * n_model * n_spatial
    assert 0 < total <= size, (
        f"mesh data={n_data} x spatial={n_spatial} x model={n_model} does "
        f"not fit {size} devices (model*spatial alone may exceed "
        "the device count)"
    )
    cell = lambda d, s, m: (d * n_spatial + s) * n_model + m  # noqa: E731
    D, S, M = range(n_data), range(n_spatial), range(n_model)
    members = {
        "data": {(s, m): tuple(cell(d, s, m) for d in D) for s in S
                 for m in M},
        "spatial": {(d, m): tuple(cell(d, s, m) for s in S) for d in D
                    for m in M},
        "model": {(d, s): tuple(cell(d, s, m) for m in M) for d in D
                  for s in S},
        "batch": {m: tuple(cell(d, s, m) for d in D for s in S) for m in M},
    }
    made: Dict[Tuple[int, ...], object] = {}
    for axis in ("data", "spatial", "model", "batch"):
        for ranks in members[axis].values():
            if len(ranks) > 1 and ranks not in made:
                made[ranks] = (dist.group.WORLD
                               if ranks == tuple(range(size))
                               else dist.new_group(list(ranks)))
    me = rank()
    if me >= total:
        return None
    d, rest = divmod(me, n_spatial * n_model)
    s, m = divmod(rest, n_model)
    keys = {"data": (s, m), "spatial": (d, m), "model": (d, s), "batch": m}
    groups = {axis: made.get(members[axis][key])
              for axis, key in keys.items()}
    return Grid(n_data, n_spatial, n_model, d, s, m, groups)


@dataclasses.dataclass(frozen=True)
class ClassSlice:
    """Model rank ``m``'s slice of a class table: entries ``[lo, lo +
    local.shape[axis])`` of the ``total`` classes along ``axis`` (rows of
    the text table, columns of a [C, C] matrix)."""

    local: torch.Tensor
    total: int
    lo: int
    axis: int


def shard_class_tables(text_table: torch.Tensor, medium_matrix: torch.Tensor,
                       hard_matrix: torch.Tensor,
                       shard_classes: bool = False,
                       grid: Optional[Grid] = None):
    """Place the train step's frozen class tables (JAX's
    ``shard_class_tables``).  With ``shard_classes`` on a grid of more than
    one model rank, model rank ``m`` keeps its :func:`owned_rows` slice of
    the classes (rows of the [C, D] text table, the same columns of both
    [C, C] matrices) as :class:`ClassSlice`s, which the step gathers whole
    over the 'model' group before the loss (:func:`gather_class_table`);
    otherwise every rank holds them whole, as JAX replicates them."""
    if not shard_classes or grid is None or grid.n_model == 1:
        return text_table, medium_matrix, hard_matrix
    C = text_table.shape[0]
    lo, hi = owned_rows(C, grid.n_model, grid.m)
    return (ClassSlice(text_table[lo:hi].clone(), C, lo, 0),
            ClassSlice(medium_matrix[:, lo:hi].clone(), C, lo, 1),
            ClassSlice(hard_matrix[:, lo:hi].clone(), C, lo, 1))


def gather_class_table(table, grid: Optional[Grid]) -> torch.Tensor:
    """A :class:`ClassSlice` gathered whole over the grid's 'model' group
    (each rank writes its slice into a zero table: the bits exact); a
    tensor as it is.  The tables are frozen: not differentiated."""
    if not isinstance(table, ClassSlice):
        return table
    if grid is None or grid.n_model == 1:
        raise ValueError("a model-sharded class table needs the grid it "
                         "was sharded over")
    shape = list(table.local.shape)
    shape[table.axis] = table.total
    out = table.local.new_zeros(shape)
    out.narrow(table.axis, table.lo, table.local.shape[table.axis]).copy_(
        table.local)
    return all_reduce_exact(out, grid.group("model"))


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Start every rank from rank 0's parameters and buffers (JAX's
    ``replicate``/``shard_state``: the state is replicated, not sharded)."""
    with torch.no_grad():
        broadcast([p.data for p in module.parameters()]
                  + list(module.buffers()), group)
    return module
