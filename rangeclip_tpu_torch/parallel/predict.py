"""Data-parallel, class-sharded predict (``rangeclip_tpu/parallel/
predict.py``): the serving path over a grid of devices.

* 'data' rows: the batch.  Each row's cells run the UNet on that row's
  batch rows; rows never talk to each other.
* 'model' columns: the candidate table.  Each cell scores only its slice
  of the padded table (:func:`pad_class_table`), whose rows carry global
  class ids, and selects a local top-k with its values; the row's columns
  are then merged exactly on the row's first device.

The merge is exact: every slice's ids ascend, each local selection breaks
ties to the smaller id, and the merge orders the gathered (value, id)
pairs by value descending, then id ascending (a stable sort by id, then a
stable sort by value), so a tie across slices also goes to the smaller
global id.  The values compared are the ones each cell's selection ranked
by: the packed bf16 selector's decoded scores, the fused conv's, or the
f32 cosine logits of ``pixel_text_topk``, whose per-pixel scale is the
same in every cell.

One process drives every cell, one model replica per distinct device,
with no host synchronisation inside the loop, so that cells on distinct
GPUs run at once.  On one card the grid names ``cuda:0`` several times
(the cells then run one after another): the result is the same, and the
time is the merge's cost, not a speed-up.  The UNet is run again in each
column (the parameters are replicated), as in JAX: where sharding the
table matters, scoring outweighs the forward.

JAX's 'spatial' axis (``_make_spatial_sharded_predict``) runs over a process
grid (:func:`make_grid_predict`, ``parallel/mesh.make_grid``): each rank
runs ``native_field`` on its data block's images and its spatial block of
their rows (the convolutions' halo rows fetched from its spatial
neighbours, ``parallel/halo.py``), scores its model slice of the table with
``pixel_text_topk``, joins the exact merge over its 'model' group and
upsamples its own label rows; :func:`gather_label_blocks` puts the ranks'
blocks together for a caller that wants the whole map.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.cli.common import PREDICT_PATHS, use_folded
from rangeclip_tpu_torch.models.depth_unet import (
    SLOT_MULTIPLE,
    DepthUNet,
    normalize_native_field,
    predict_folded,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
    pixel_text_topk,
    select_topk,
)
from rangeclip_tpu_torch.ops.resize import resize_nearest
from rangeclip_tpu_torch.parallel import halo
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    Mesh,
    all_reduce_exact,
    owned_rows,
)
from rangeclip_tpu_torch.utils.math import l2_normalize


def pad_class_table(table: torch.Tensor, n_model: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a [C, D] table so that the class axis splits evenly over
    ``n_model`` slices, each a multiple of the kernels' slot quantum
    (``SLOT_MULTIPLE``, 128) on CUDA and of 8 elsewhere, as the table's
    device says, and build the [C_pad] global ids, -1 on the pad rows.
    Returns (padded_table, ids)."""
    C = table.shape[0]
    quantum = SLOT_MULTIPLE if table.device.type == "cuda" else 8
    per = -(-C // n_model)
    per = -(-per // quantum) * quantum
    total = per * n_model
    ids = torch.arange(C, dtype=torch.int32, device=table.device)
    if total != C:
        table = F.pad(table, (0, 0, 0, total - C))
        ids = F.pad(ids, (0, total - C), value=-1)
    return table, ids


@dataclasses.dataclass(frozen=True)
class ClassShards:
    """The padded table and its ids cut into the grid's column slices,
    each on its cell's device: ``tables[r][c]``, ``ids[r][c]``."""

    tables: Tuple[Tuple[torch.Tensor, ...], ...]
    ids: Tuple[Tuple[torch.Tensor, ...], ...]


def shard_predict_inputs(mesh: Mesh, table: torch.Tensor,
                         ids: torch.Tensor) -> ClassShards:
    """Place a padded table (:func:`pad_class_table`) on the grid: column
    ``c`` of every row takes rows ``c * S/p .. (c+1) * S/p``.  Serving does
    this once at start-up."""
    n_model = mesh.shape["model"]
    if table.shape[0] % n_model or ids.shape != table.shape[:1]:
        raise ValueError(f"a table of {table.shape[0]} rows (ids "
                         f"{tuple(ids.shape)}) does not split into "
                         f"{n_model} slices: pad it with pad_class_table")
    tables = table.chunk(n_model)
    id_slices = ids.to(torch.int32).chunk(n_model)
    return ClassShards(
        tuple(tuple(tables[c].to(d) for c, d in enumerate(row))
              for row in mesh.devices),
        tuple(tuple(id_slices[c].to(d) for c, d in enumerate(row))
              for row in mesh.devices))


def _score_field_topk(field: torch.Tensor, table_slice: torch.Tensor,
                      ids_slice: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score an un-normalised [B, h, w, D] field against a table slice whose
    rows carry the global ``ids_slice``: a local top-k with its f32 values
    ([B, h, w, k] each), as ``DepthUNet.predict`` scores the full table (the
    ``pixel_text_topk`` kernel on CUDA, the normalised f32 product and the
    knockout selection on the CPU)."""
    B, h, w, D = field.shape
    text = l2_normalize(table_slice.float(), dim=-1)
    if field.device.type == "cuda":
        idx, val = pixel_text_topk(field, text, ids_slice >= 0, top_k=top_k,
                                   want_values=True, candidate_ids=ids_slice)
    else:
        logits = normalize_native_field(field).reshape(-1, D).float() @ text.T
        idx, val = select_topk(logits, ids_slice, top_k)
    return idx.reshape(B, h, w, top_k), val.reshape(B, h, w, top_k)


def merge_topk(picks: List[Tuple[torch.Tensor, torch.Tensor]],
               device: torch.device, top_k: int) -> torch.Tensor:
    """The exact merge of the columns' local (ids, values) [..., k] pairs
    on ``device``: ids by value descending, then id ascending; the first
    ``top_k``."""
    idx = torch.cat([i.to(device) for i, _ in picks], dim=-1)
    val = torch.cat([v.to(device) for _, v in picks], dim=-1)
    order = torch.sort(idx, dim=-1, stable=True).indices
    idx, val = idx.gather(-1, order), val.gather(-1, order)
    order = torch.sort(val, dim=-1, descending=True, stable=True).indices
    return idx.gather(-1, order)[..., :top_k]


def _local_topk(model: DepthUNet, depth: torch.Tensor,
                table_slice: torch.Tensor, ids_slice: torch.Tensor,
                top_k: int, predict_path: str, n_model: int):
    """One cell's native-resolution (ids, values) [B, h, w, k] over its
    table slice: ``predict_folded`` or ``native_field`` and
    :func:`_score_field_topk`, by ``predict_path`` ('auto': the CLIs'
    rule on the slice's slot count and the cell's batch, as JAX decides it
    from the slice's static shape)."""
    S, D = table_slice.shape
    if use_folded(predict_path, S, D, depth.shape[0], model.compute_dtype,
                  depth.device):
        return predict_folded(
            model, depth, table_slice, top_k=top_k,
            candidate_ids=ids_slice, want_values=True, upsample=False,
            # the slices are an even split of the padded global table
            max_candidate_id=S * n_model - 1)
    field = model.native_field(depth, normalize=False)
    return _score_field_topk(field, table_slice, ids_slice, top_k)


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def make_sharded_predict(model: DepthUNet, mesh: Mesh, top_k: int = 5,
                         predict_path: str = "auto"
                         ) -> Callable[..., torch.Tensor]:
    """``fn(depth, table, ids=None) -> ids [B, H, W, top_k]`` over the grid.

    ``depth`` is [B, H, W(, 1)] with B divisible by the 'data' size, on any
    device; ``table`` is a :class:`ClassShards`, or a padded [S, D] table
    with its ``ids`` (placed on each call).  The result lies on the first
    cell's device.

    ``predict_path`` picks each cell's scoring: 'folded' (``predict_folded``
    over the slice, with ``candidate_ids`` and the padded global table's
    last id as the packed selector's bound), 'default' (``native_field``,
    then ``pixel_text_topk`` over the slice), or 'auto': the CLIs' rule
    (``cli.common.use_folded``) on the per-slice slot count and the cell's
    batch, as JAX decides it from the slice's static shape
    (``predict_folded`` checks the fused kernel's gate again on the real
    operands, the global id bound included).  The model must be in eval
    mode.
    """
    if predict_path not in PREDICT_PATHS:
        raise ValueError(f"unknown predict path {predict_path!r}")
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    home = next(model.parameters()).device
    replicas: Dict[torch.device, DepthUNet] = {
        d: model if d == home else copy.deepcopy(model).to(d).eval()
        for d in mesh.distinct_devices()}

    @torch.no_grad()
    def fn(depth: torch.Tensor, table, ids: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
        shards = (table if isinstance(table, ClassShards)
                  else shard_predict_inputs(mesh, table, ids))
        if depth.dim() == 3:
            depth = depth[..., None]
        B, H, W = depth.shape[:3]
        if B % n_data:
            raise ValueError(f"batch {B} does not split over {n_data} data "
                             "rows")
        b = B // n_data
        # every cell's input first, so that no copy waits behind a cell's
        # compute
        inputs: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        for r, row in enumerate(mesh.devices):
            for d in row:
                if (r, d) not in inputs:
                    inputs[r, d] = depth[r * b:(r + 1) * b].to(d)
        rows = []
        for r, row in enumerate(mesh.devices):
            picks = []
            for c, d in enumerate(row):
                with _on(d):
                    picks.append(_local_topk(
                        replicas[d], inputs[r, d], shards.tables[r][c],
                        shards.ids[r][c], top_k, predict_path, n_model))
            with _on(row[0]):
                idx = (merge_topk(picks, row[0], top_k) if n_model > 1
                       else picks[0][0])
                rows.append(resize_nearest(idx, (H, W)))
        out = mesh.devices[0][0]
        return torch.cat([r.to(out) for r in rows])

    return fn


def make_grid_predict(model: DepthUNet, grid: Grid, top_k: int = 5,
                      predict_path: str = "default"
                      ) -> Callable[..., torch.Tensor]:
    """JAX's spatially sharded ``make_sharded_predict`` over a ``data x
    spatial x model`` process grid: ``fn(depth, table, ids) -> this rank's
    labels`` [B / n_data, its rows of H, W, top_k] on the model's device,
    every rank of the grid calling it with the same arguments.

    ``depth`` is the whole [B, H, W(, 1)] batch (each rank cuts its block:
    ``Grid.local_batch``); ``table`` and ``ids`` the padded table
    (:func:`pad_class_table` over the 'model' size), of which each rank
    scores its slice.  A rank runs ``native_field`` on its block inside
    ``halo.sharded_rows`` (its halo rows from its spatial neighbours),
    scores its slice with ``pixel_text_topk`` (the plain version on the
    CPU), merges the 'model' group's (value, id) pairs exactly
    (:func:`merge_topk`) and upsamples its own label rows.  The formulation
    is 'default' ('auto' picks it); JAX's refusals: 'folded' cannot
    spatially shard, and H must divide by the model's ``field_scale`` (2
    for the ResNet, 4 for the MiT) x the 'spatial' size, so that every
    rank holds whole rows of the field.  A grid
    without a 'spatial' axis is :func:`make_sharded_predict`'s.  The model
    must be in eval mode."""
    if predict_path not in PREDICT_PATHS:
        raise ValueError(f"unknown predict path {predict_path!r}")
    n_spatial, n_model = grid.n_spatial, grid.n_model
    if predict_path == "folded":
        raise ValueError(
            "predict_path='folded' cannot spatially shard (the folded "
            "conv would need halo exchange inside shard_map); use "
            "'default' or 'auto'")
    if n_spatial == 1:
        raise ValueError("a grid without a 'spatial' axis predicts with "
                         "make_sharded_predict")

    @torch.no_grad()
    def fn(depth: torch.Tensor, table: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
        if depth.dim() == 3:
            depth = depth[..., None]
        B, H, W = depth.shape[:3]
        if B % grid.n_data:
            raise ValueError(f"batch {B} does not split over "
                             f"{grid.n_data} data blocks")
        scale = model.field_scale
        if H % (scale * n_spatial):
            raise ValueError(f"height {H} must divide by {scale}x the "
                             f"'spatial' size {n_spatial} (the field is at "
                             f"H/{scale})")
        if table.shape[0] % n_model or ids.shape != table.shape[:1]:
            raise ValueError(f"a table of {table.shape[0]} rows (ids "
                             f"{tuple(ids.shape)}) does not split into "
                             f"{n_model} slices: pad it with "
                             "pad_class_table")
        device = next(model.parameters()).device
        local = grid.local_batch({"depth": depth})["depth"].to(device)
        table_slice = table.chunk(n_model)[grid.m].to(device)
        ids_slice = ids.to(torch.int32).chunk(n_model)[grid.m].to(device)
        with halo.sharded_rows(grid, (H, W)):
            idx, val = _local_topk(model, local, table_slice, ids_slice,
                                   top_k, "default", n_model)
        if n_model > 1:
            idx = grid.gather(idx[None], "model")
            val = grid.gather(val[None], "model")
            idx = merge_topk(list(zip(idx.unbind(), val.unbind())), device,
                             top_k)
        return resize_nearest(idx, local.shape[1:3])

    return fn


def gather_label_blocks(labels: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole [B, H, W, k] map from every rank's block of
    :func:`make_grid_predict` (the 'batch' group's blocks, each rank
    writing its own into a zero map: the ids exact); the same on every
    rank."""
    b, rows, W, k = labels.shape
    H = rows * grid.n_spatial
    out = labels.new_zeros((b * grid.n_data, H, W, k))
    lo, hi = owned_rows(H, grid.n_spatial, grid.s)
    out[grid.d * b:(grid.d + 1) * b, lo:hi] = labels
    return all_reduce_exact(out, grid.group("batch"))
