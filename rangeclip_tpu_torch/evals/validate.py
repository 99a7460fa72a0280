"""Validation (``rangeclip_tpu/evals/validate.py``: ``make_val_step`` and
``validate_model``).

Reference: validate.py:34-266.  Per val batch: reduced-candidate predict
(the classes present plus 50 drawn negatives, top-5), the
equivalence-aware metric update, and the val loss recomputed at the
decoder's native resolution, the area-image term included.  The
accumulators stay on the device and cross to the host once at the end.
Best results are tracked on top-k mIoU; ``latest_val_loss`` feeds the
plateau schedule.

The model runs in eval mode (BatchNorm on its running statistics) under
``torch.inference_mode()`` and is put back in its previous mode after.
Batch ``i`` draws from generators keyed positionally by (seed, i), apart
from the training generators, so a validation changes nothing a later
train step sees.  Every draw can be passed in instead (the candidate mask's
Gumbel noise and the loss's :class:`Draws`), which is how the tests feed
JAX's draws.

Over a process group (``group``; JAX's ``validate_model(mesh=...)``,
validate.py:159-205) each rank feeds its val-loader shard, and batch ``i``
is the global batch of every rank's batch ``i`` in rank order: the
candidate set is the classes present in any rank's rows plus negatives
drawn from the same noise on every rank, the loss is the global batch's
(its draws made for the whole batch, each rank keeping its rows), and the
metric accumulators and loss sums are SUM all-reduced at the end.  Every
rank returns the same results; only rank 0 prints.

Over a ``data x spatial x model`` grid (``group`` a ``parallel/mesh.Grid``:
JAX's ``validate_model(mesh=...)`` on a mesh with a 'spatial' axis, whose
``shard_batch`` shards H) every rank of a data block is fed that block's
val-loader shard and keeps its spatial block of the rows
(``Grid.row_block``); the model ranks compute the same rows with the whole
class tables (``mesh.gather_class_table``).  The candidate mask is taken
over the grid's 'batch' group (data x spatial), from the same noise on
every rank; the predict (``DepthUNet.predict``: ``pixel_text_topk`` on the
rank's field, its labels upsampled by the field's scale) and the val loss
(the grid step's loss path: the area pooling summed over the spatial
ranks, the plain TV with its halo row, the image-level term once per data
block) run inside ``parallel/halo.sharded_rows``; the metrics update on the
rank's own rows.  The accumulators and loss sums are summed over the
'batch' group only (never over 'model'), then model rank 0's are broadcast
over the 'model' group, so that every rank returns the same results.
Rank 0 renders the summary grids from the gathered label blocks
(``parallel/predict.gather_label_blocks``).
"""

from __future__ import annotations

import importlib.util
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.data.loader import BATCH_DTYPES
from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)
from rangeclip_tpu_torch.losses.hybrid import (
    Draws,
    HybridLossConfig,
    compute_hybrid_loss,
)
from rangeclip_tpu_torch.losses.pooling import per_item_masked_pooling
from rangeclip_tpu_torch.models.clip.crops import prepare_image_crops
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    build_candidate_mask,
)
from rangeclip_tpu_torch.parallel.halo import sharded_rows
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    as_grid,
    broadcast,
    gather_class_table,
)
from rangeclip_tpu_torch.training.train_step import microbatch_generator
from rangeclip_tpu_torch.utils.logging import log

VAL_SEED = 999  # the trainer's validation key (JAX: jax.random.key(999))


def make_val_step(loss_config: HybridLossConfig = HybridLossConfig(),
                  top_k: int = 5, num_negatives: int = 50,
                  group=None) -> Callable:
    """The per-batch validation step

      step(model, batch, rng, pct_medium, pct_hard, text_table,
           medium_matrix, hard_matrix, equivalence_tensor, equiv_class_map,
           image_embeddings, acc, candidate_gumbel=None, draws=None)
        -> (acc, loss_parts [4] f32, pred_topk [B, H, W, k])

    ``batch`` holds depth [B, H, W, 1] f32, segmentation [B, H, W],
    object_label [B] and sample_valid [B] on the model's device; the model
    must be in eval mode.  ``rng`` is (seed, batch index): the candidate
    mask draws from a CPU generator keyed (seed, index, 0), the loss from a
    device generator keyed (seed, index, 1), unless ``candidate_gumbel``
    ([C]) and ``draws`` are given.  ``loss_parts`` are the total, text,
    image and smoothness losses.  With ``group`` (more than one rank) the
    batch is this rank's rows of the global batch, ``draws`` the global
    batch's, ``acc`` and ``pred_topk`` this rank's rows' and ``loss_parts``
    this rank's shares.  On a grid with a 'spatial' axis the depth and
    segmentation are the rank's spatial block of its data block's images
    (of a height that divides by the model's ``field_scale`` x the
    'spatial' size), the rest its data block's."""
    grid = _grid(group)

    @torch.inference_mode()
    def val_step(model: DepthUNet, batch: Dict[str, torch.Tensor],
                 rng: Tuple[int, int], pct_medium: float, pct_hard: float,
                 text_table: torch.Tensor, medium_matrix: torch.Tensor,
                 hard_matrix: torch.Tensor,
                 equivalence_tensor: torch.Tensor,
                 equiv_class_map: torch.Tensor,
                 image_embeddings: torch.Tensor,
                 acc: Dict[str, torch.Tensor],
                 candidate_gumbel: Optional[torch.Tensor] = None,
                 draws: Optional[Draws] = None):
        device = batch["depth"].device
        num_classes = text_table.shape[0]
        cand_gen = loss_gen = None
        if candidate_gumbel is None:
            cand_gen = microbatch_generator(rng[0], rng[1], 0,
                                            torch.device("cpu"))
        if draws is None:
            loss_gen = microbatch_generator(rng[0], rng[1], 1, device)
        seg = batch["segmentation"]
        cand_mask = build_candidate_mask(seg, num_classes, num_negatives,
                                         gumbel=candidate_gumbel,
                                         generator=cand_gen, group=grid)
        rows, width = seg.shape[1:]
        shape = (rows * (1 if grid is None else grid.n_spatial), width)
        with sharded_rows(grid, shape):
            # the loss consumes the native-resolution normalised field
            # through the exact upsample identities (hybrid.py
            # label_upsample)
            pred_topk, pixel_emb, temp_text = model.predict(
                batch["depth"], text_table, cand_mask, top_k,
                return_embeddings="native")
            ups = rows // pixel_emb.shape[1]
            valid = batch["sample_valid"]
            acc = metrics_update(acc, pred_topk, seg, equivalence_tensor,
                                 equiv_class_map, pixel_weight=valid)
            area = per_item_masked_pooling(pixel_emb, seg,
                                           batch["object_label"],
                                           upsample=ups, group=grid)
            _, info = compute_hybrid_loss(
                pixel_emb, seg, text_table, medium_matrix, hard_matrix,
                temp_text, model.log_temperature_image.exp(), pct_medium,
                pct_hard, area, image_embeddings, area_valid=valid,
                sample_weight=valid, config=loss_config, label_upsample=ups,
                draws=draws, generator=loss_gen, group=grid)
        loss_parts = torch.stack([info[k].float() for k in (
            "total_loss", "text_contrastive_loss", "image_contrastive_loss",
            "smoothness_loss")])
        return acc, loss_parts, pred_topk

    return val_step


def _grid(group) -> Optional[Grid]:
    """``group`` as a grid (``mesh.as_grid``); one rank is no grid."""
    grid = as_grid(group)
    if grid is not None and grid.size("batch") * grid.n_model == 1:
        return None
    return grid


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device,
                    keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The loader's numpy arrays as tensors of the step's dtypes."""
    return {k: torch.from_numpy(np.asarray(batch[k]).astype(BATCH_DTYPES[k])
                                ).to(device) for k in keys}


def validate_model(
    model: DepthUNet,
    dataloader,
    text_table: torch.Tensor,
    medium_matrix: torch.Tensor,
    hard_matrix: torch.Tensor,
    equivalence_tensor: torch.Tensor,
    equiv_class_map: torch.Tensor,
    curriculum: Dict[str, float],
    image_provider,
    step: int,
    best_results: Dict,
    seed: int = VAL_SEED,
    loss_config: HybridLossConfig = HybridLossConfig(),
    top_k: int = 5,
    num_negatives: int = 50,
    log_path: Optional[str] = None,
    summary_writer=None,
    candidate_labels: Optional[Sequence[str]] = None,
    n_sample_per_summary: int = 0,
    group=None,
) -> Dict:
    """Run the validation loop on the model's device; returns the updated
    ``best_results``.  With ``group`` (a process group, or a
    ``parallel/mesh.Grid``) every rank of it calls this on its data
    block's shard of the val split, with as many batches on every rank
    (the module docstring); the results are the global batches', on every
    rank.  The tables may be ``mesh.shard_class_tables``' model slices.
    With ``candidate_labels`` and ``n_sample_per_summary`` set, the first
    batch's samples are rendered as [depth | image | GT | prediction] grids
    through the summary writer (reference validate.py:140-146); without
    matplotlib they are skipped, with a line in the log.  Batch ``i`` is
    keyed (seed, i)."""
    grid = _grid(group)
    spatial = grid is not None and grid.n_spatial > 1
    text_table, medium_matrix, hard_matrix = (
        gather_class_table(t, grid)
        for t in (text_table, medium_matrix, hard_matrix))
    device = text_table.device
    num_classes = text_table.shape[0]
    val_step = make_val_step(loss_config, top_k, num_negatives, grid)
    eq = equivalence_tensor.to(device)
    ecm = equiv_class_map.to(device)
    acc = metrics_init(num_classes, device)
    loss_sums = torch.zeros(4, dtype=torch.float32, device=device)
    n_batches = 0
    grids = candidate_labels is not None and n_sample_per_summary > 0
    was_training = model.training
    model.eval()
    try:
        for i, batch in enumerate(dataloader):
            tensors = batch_to_device(batch, device, (
                "depth", "segmentation", "object_label", "sample_valid",
                "image", "object_bbox"))
            with torch.inference_mode():
                image_embeddings = image_provider(prepare_image_crops(
                    tensors.pop("image"), tensors.pop("object_bbox")))
            if spatial:
                # every rank checks the same global height before any
                # collective, so all raise together
                height, scale = tensors["depth"].shape[1], model.field_scale
                if height % (scale * grid.n_spatial):
                    raise ValueError(
                        f"height {height} must divide by {scale}x the "
                        f"'spatial' size {grid.n_spatial} (the field is at "
                        f"H/{scale})")
                for k in ("depth", "segmentation"):
                    tensors[k] = grid.row_block(tensors[k], 1).contiguous()
            acc, loss_parts, pred_topk = val_step(
                model, tensors, (seed, i), curriculum["pct_medium"],
                curriculum["pct_hard"], text_table, medium_matrix,
                hard_matrix, eq, ecm, image_embeddings, acc)
            loss_sums = loss_sums + loss_parts
            n_batches += 1
            if i == 0 and grids and spatial:
                from rangeclip_tpu_torch.parallel.predict import (
                    gather_label_blocks,
                )

                b = pred_topk.shape[0]
                pred_topk = gather_label_blocks(pred_topk, grid)[
                    grid.d * b:(grid.d + 1) * b]
            if i == 0 and grids and summary_writer is not None:
                _write_grids(summary_writer, batch, pred_topk,
                             candidate_labels, n_sample_per_summary, step,
                             log_path)
    finally:
        model.train(was_training)

    if grid is not None:
        with torch.inference_mode():
            present = acc["gt_present"].float()
            sums = ([v for k, v in acc.items() if k != "gt_present"]
                    + [loss_sums, present])
            grid.sum(sums, "batch")
            if grid.n_model > 1:
                broadcast(sums, grid.group("model"))
            acc["gt_present"] = present > 0
    console = grid is None or (grid.d, grid.s, grid.m) == (0, 0, 0)
    results = metrics_finalize(acc)
    avg = loss_sums.cpu().numpy() / max(n_batches, 1)
    results.update(
        avg_loss=float(avg[0]),
        avg_text_contrastive_loss=float(avg[1]),
        avg_image_contrastive_loss=float(avg[2]),
        avg_smoothness_loss=float(avg[3]),
    )
    log(f"[Val] [Step {step}] Top-1 pixel accuracy (equiv): "
        f"{results['pixel_accuracy_t1']:.4f}", log_path, console)
    log(f"[Val] [Step {step}] Top-k pixel accuracy (equiv): "
        f"{results['pixel_accuracy_tk']:.4f}", log_path, console)
    log(f"[Val] [Step {step}] Top-1 mIoU (equiv): {results['mIoU_t1']:.4f}",
        log_path, console)
    log(f"[Val] [Step {step}] Top-k mIoU (equiv): {results['mIoU_tk']:.4f}",
        log_path, console)
    log(f"[Val] Step {step} | Loss: {results['avg_loss']:.4f}, "
        f"Text Contrastive: {results['avg_text_contrastive_loss']:.4f}, "
        f"Image Contrastive: {results['avg_image_contrastive_loss']:.4f}, "
        f"Smoothness: {results['avg_smoothness_loss']:.4f}", log_path,
        console)

    # the latest (not best) validation loss: the plateau schedule's metric
    best_results["latest_val_loss"] = results["avg_loss"]
    if best_results.get("mIoU_tk", 0.0) < results["mIoU_tk"]:
        best_results.update(
            step=step,
            loss=results["avg_loss"],
            mIoU_t1=results["mIoU_t1"],
            mIoU_tk=results["mIoU_tk"],
            pixel_accuracy_t1=results["pixel_accuracy_t1"],
            pixel_accuracy_tk=results["pixel_accuracy_tk"],
            avg_text_contrastive_loss=results["avg_text_contrastive_loss"],
            avg_image_contrastive_loss=results["avg_image_contrastive_loss"],
            avg_smoothness_loss=results["avg_smoothness_loss"],
        )
    if "loss" in best_results and best_results.get("step", -1) >= 0:
        log(f"Best validation loss: {best_results['loss']:.4f} at step "
            f"{best_results['step']}", log_path, console)
    if summary_writer is not None:
        summary_writer.add_scalars("val", results, step)
    return best_results


def _write_grids(writer, batch, pred_topk, candidate_labels, n_samples,
                 step, log_path) -> None:
    if importlib.util.find_spec("matplotlib") is None:
        log("[Val] matplotlib is not installed: the prediction grids "
            "(--n_sample_per_summary) are not drawn", log_path)
        return
    from rangeclip_tpu_torch.utils.visualization import prediction_grid

    pred_t1 = pred_topk[..., 0].cpu().numpy()
    depth = np.asarray(batch["depth"])
    image = np.asarray(batch["image"]) if "image" in batch else None
    seg = np.asarray(batch["segmentation"])
    for s in range(min(n_samples, seg.shape[0])):
        grid = prediction_grid(depth[s], image[s] if image is not None
                               else None, seg[s], pred_t1[s],
                               candidate_labels)
        writer.add_image(f"val/sample{s}", grid, step)
