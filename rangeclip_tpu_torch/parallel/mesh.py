"""Device grids and the process group (``rangeclip_tpu/parallel/mesh.py``).

JAX names one mesh of devices and lets XLA insert the collectives.  The
port keeps the two things that mesh is used for, each in its own form:

* :func:`make_mesh`: an ``[n_data][n_model]`` grid of ``torch.device``s
  that one process drives (``parallel/predict.py``, ``cli/serve
  --data_parallel``).  A device may stand in the grid more than once: four
  CPU cells stand in for JAX's virtual CPU devices in the tests, and
  ``[cuda:0] * 4`` runs the grid on one card.  No 'spatial' axis yet
  (ROADMAP item 10b).
* :func:`init_distributed` and the helpers after it: the process group that
  ``--distributed`` training runs over, one process per GPU as ``torchrun``
  starts them (JAX runs one process over all of a host's devices).  The
  batch is sharded by the loader (``data/loader.py`` ``shard_id``,
  ``num_shards``); the global batch is the ranks' rows concatenated in rank
  order (JAX's process-major ``shard_batch``), :func:`row_block` is this
  rank's block of an array over the global batch and :func:`gather_rows`
  the global array from every rank's block.  ``replicate`` broadcasts rank
  0's parameters and buffers once, and the class tables are built by every
  rank alike (JAX's ``shard_class_tables`` without ``shard_classes``;
  model-sharded tables are item 10b).

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

ITEM_10B = "ROADMAP item 10b"


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
    its mesh out; ``n_data`` defaults to as many rows as fit."""
    if n_spatial != 1:
        raise NotImplementedError(
            "a 'spatial' mesh axis (the image height sharded, conv halos "
            f"exchanged) is not ported yet: {ITEM_10B}")
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


def shard_class_tables(text_table: torch.Tensor, medium_matrix: torch.Tensor,
                       hard_matrix: torch.Tensor,
                       shard_classes: bool = False):
    """The train step's frozen class tables: held whole by every rank, as
    JAX replicates them.  ``shard_classes`` (the class axis split over a
    'model' axis of a 2-D grid of process groups) is refused."""
    if shard_classes:
        raise NotImplementedError(
            "model-sharded class tables in training (a 2-D grid of process "
            f"groups) are not ported yet: {ITEM_10B}")
    return text_table, medium_matrix, hard_matrix


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Start every rank from rank 0's parameters and buffers (JAX's
    ``replicate``/``shard_state``: the state is replicated, not sharded)."""
    with torch.no_grad():
        broadcast([p.data for p in module.parameters()]
                  + list(module.buffers()), group)
    return module
