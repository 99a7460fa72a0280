"""End-to-end training (``rangeclip_tpu/training/trainer.py``:
``TrainerConfig``, ``train_depth_clip_model``) on one device.

Data and label structures, the frozen text table (computed once, by the CLIP
text tower or the hash stub), the image provider (the CLIP vision tower,
``--clip_checkpoint_path random`` for seeded random weights, or the hash
stub), the model and Adam, restore (``--auto_resume``, then
``--restore_path_encoder``, then ``--restore_path_model``), then the epoch
loop: the curriculum and the learning rate per epoch, one
accumulation window per optimizer step, one image-tower call per window
(skipped when the image loss is off), summaries, validation and checkpoints
on the JAX cadence, a final save.  Step s always trains under the positional key
(seed + 1, s), so a run killed and resumed takes the same steps as a
straight one; a resume inside an epoch skips the windows the epoch already
consumed (trainer.py:380-421).

Validation (trainer.py:488-510) runs when ``step >= validation_start_step``
and ``step % (n_step_per_validation or n_step_per_summary) == 0``, in eval
mode on its own generators (``evals/validate``), so the training steps,
their draws, the BatchNorm statistics and the loader order are those of a
run without it; the best results are logged and returned, and the latest
val loss is the plateau schedule's metric.

The frozen-encoder finetune (trainer.py:252-295): ``freeze_encoder=None``
freezes exactly when ``restore_path_encoder`` is given; the encoder then
runs in eval mode and is not the optimizer's (``DepthUNetConfig.
freeze_encoder``, ``training/optim.optimized_parameters``).

``profile_dir`` (trainer.py:447-459) traces the optimizer steps
``start_step + 2`` to ``start_step + 4`` with ``utils/monitoring.
device_trace`` (a Chrome trace of ``torch.profiler``), the device
synchronised before the trace closes; a run that ends sooner closes it at
its end.  The trace reads no random stream, so the steps are those of a
run without it.

Multi-GPU (``ddp_parity``, ``distributed``: ROADMAP item 10) raises
``NotImplementedError`` at start-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from rangeclip_tpu_torch.cli.common import set_precision
from rangeclip_tpu_torch.data.labels import (
    build_equivalence_class_map,
    build_equivalence_tensor,
    build_similarity_matrices,
    load_equivalence_dict,
    load_label_similarity_sets,
)
from rangeclip_tpu_torch.data.loader import BATCH_DTYPES, setup_dataloaders
from rangeclip_tpu_torch.evals.validate import VAL_SEED, validate_model
from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
from rangeclip_tpu_torch.models.clip.crops import prepare_image_crops
from rangeclip_tpu_torch.models.clip.provider import (
    get_image_provider,
    get_text_provider,
)
from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
from rangeclip_tpu_torch.training.curriculum import get_curriculum_schedule
from rangeclip_tpu_torch.training.optim import make_lr_schedule
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step
from rangeclip_tpu_torch.utils.device import describe_device, resolve_device
from rangeclip_tpu_torch.utils.logging import (
    ScalarWriter,
    log,
    log_configuration,
    log_training_summary,
)
from rangeclip_tpu_torch.utils.monitoring import device_trace


@dataclasses.dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields, plus ``device``."""

    labeled_metadata_path: str = ""
    labels_path: str = ""
    equivalence_dict_path: str = ""
    batch_size: int = 2
    n_height: int = 224
    n_width: int = 224
    unet_architecture: str = "resnet"
    learning_rates: Sequence[float] = (2e-4, 1e-4, 5e-5, 1e-5)
    learning_schedule: Sequence[int] = (10, 20, 30, 35)
    scheduler_type: str = "multi_step"
    w_weight_decay: float = 1e-4
    checkpoint_path: str = "checkpoints"
    n_step_per_checkpoint: int = 1000
    n_step_per_summary: int = 500
    n_step_per_validation: Optional[int] = None
    n_sample_per_summary: int = 32
    validation_start_step: int = 5000
    restore_path_model: Optional[str] = None
    restore_path_encoder: Optional[str] = None
    freeze_encoder: Optional[bool] = None
    clip_checkpoint_path: Optional[str] = None
    clip_vocab_path: Optional[str] = None
    clip_merges_path: Optional[str] = None
    accumulation_steps: int = 8
    w_text: float = 1.0
    w_image: float = 0.5
    w_smooth: float = 2e2
    contrast_capacity: int = 128
    class_balanced: bool = False
    embedding_dim: int = 512
    use_batch_norm: bool = True
    seed: int = 0
    bf16: bool = False
    ddp_parity: bool = False
    distributed: bool = False
    max_steps: Optional[int] = None
    auto_resume: bool = False
    profile_dir: Optional[str] = None
    encoder_filters: Optional[Sequence[int]] = None
    device: str = "cuda"


def check_supported(cfg: TrainerConfig) -> None:
    """Refuse the options of later slices, naming their ROADMAP item."""
    if cfg.ddp_parity or cfg.distributed:
        raise NotImplementedError(
            "--ddp_parity and --distributed (multi-GPU) are not ported yet "
            "(ROADMAP slice 18, item 10)")


def _close_trace(trace: contextlib.ExitStack, written: list,
                 device: torch.device, log_path: str) -> None:
    """End the profile_dir trace once the device has finished its steps,
    and log where it went."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace.close()
    for path in written:
        log(f"Profiler trace written to {path}", log_path)


def _window(microbatches, keys, device):
    return {k: torch.from_numpy(np.stack([mb[k] for mb in microbatches])
                                .astype(BATCH_DTYPES[k])).to(device)
            for k in keys}


def train_depth_clip_model(cfg: TrainerConfig) -> Dict:
    """Run the training job; returns the best validation results
    ({"step": -1, "loss": inf} while no validation has run)."""
    device = resolve_device(cfg.device)
    set_precision(cfg.bf16)  # fp32 keeps cuDNN and matmuls off TF32
    time_start = time.time()
    ckpt_root = os.path.abspath(cfg.checkpoint_path)
    log_path = os.path.join(ckpt_root, "results.txt")
    n_epoch = cfg.learning_schedule[-1]

    check_supported(cfg)
    (train_loader, val_loader, _test_loader, n_train_steps,
     candidate_labels) = setup_dataloaders(
        cfg.labeled_metadata_path, cfg.labels_path,
        (cfg.n_height, cfg.n_width), cfg.batch_size, n_epoch)
    opt_steps_per_epoch = max(1, len(train_loader) // cfg.accumulation_steps)
    num_classes = len(candidate_labels)

    similarity_sets = load_label_similarity_sets(cfg.equivalence_dict_path,
                                                 num_classes)
    medium_np, hard_np = build_similarity_matrices(similarity_sets,
                                                   num_classes)
    medium_matrix = torch.from_numpy(medium_np).to(device)
    hard_matrix = torch.from_numpy(hard_np).to(device)
    equivalence_tensor = build_equivalence_tensor(
        load_equivalence_dict(cfg.equivalence_dict_path), num_classes)
    equiv_class_map = torch.from_numpy(
        build_equivalence_class_map(equivalence_tensor)).to(device)
    equivalence_tensor = torch.from_numpy(equivalence_tensor).to(device)

    text_provider = get_text_provider(cfg.clip_checkpoint_path,
                                      cfg.clip_vocab_path,
                                      cfg.clip_merges_path,
                                      dim=cfg.embedding_dim, device=device)
    image_provider = get_image_provider(cfg.clip_checkpoint_path,
                                        dim=cfg.embedding_dim, device=device)
    log(f"Precomputing text embeddings for {num_classes} candidate "
        "labels...", log_path)
    text_table = torch.from_numpy(text_provider(candidate_labels)).to(device)

    freeze_encoder = (cfg.freeze_encoder if cfg.freeze_encoder is not None
                      else cfg.restore_path_encoder is not None)
    model_kwargs = {}
    if cfg.encoder_filters is not None:
        model_kwargs["encoder_filters"] = tuple(cfg.encoder_filters)
    model_cfg = DepthUNetConfig(
        unet_type=cfg.unet_architecture, embedding_dim=cfg.embedding_dim,
        use_batch_norm=cfg.use_batch_norm,
        dtype=torch.bfloat16 if cfg.bf16 else None,
        freeze_encoder=freeze_encoder, **model_kwargs)
    state = create_train_state(model_cfg, device, cfg.w_weight_decay,
                               cfg.seed)
    ckpt = CheckpointManager(os.path.join(ckpt_root, "checkpoints"))
    if cfg.auto_resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log(f"Auto-resumed from step {state.step} (preemption recovery).",
            log_path)
    elif cfg.restore_path_encoder:
        CheckpointManager(cfg.restore_path_encoder).restore_encoder(state)
        log("Restored encoder weights"
            + (" (frozen-encoder finetune)." if freeze_encoder else "."),
            log_path)
    elif cfg.restore_path_model:
        CheckpointManager(cfg.restore_path_model).restore(state)
        log(f"Restored checkpoint at step {state.step}.", log_path)
    start_step = state.step

    loss_cfg = HybridLossConfig(
        w_text=cfg.w_text, w_image=cfg.w_image, w_smooth=cfg.w_smooth,
        contrast_capacity=cfg.contrast_capacity or None,
        class_balanced=cfg.class_balanced)
    train_step = make_train_step(loss_cfg, cfg.accumulation_steps)
    schedule = make_lr_schedule(cfg.scheduler_type, cfg.learning_rates,
                                cfg.learning_schedule)
    n_opt_steps_total = opt_steps_per_epoch * n_epoch
    log_configuration(log_path, {
        "metadata": cfg.labeled_metadata_path,
        "batch_size": cfg.batch_size,
        "resolution": f"{cfg.n_height}x{cfg.n_width}",
        "architecture": cfg.unet_architecture,
        "n_parameters": sum(p.numel() for p in state.model.parameters()),
        "n_train_steps": n_train_steps,
        "n_optimizer_steps": n_opt_steps_total,
        "learning_rates": list(cfg.learning_rates),
        "learning_schedule": list(cfg.learning_schedule),
        "scheduler": cfg.scheduler_type,
        "weight_decay": cfg.w_weight_decay,
        "accumulation_steps": cfg.accumulation_steps,
        "loss_weights": (cfg.w_text, cfg.w_image, cfg.w_smooth),
        "device": describe_device(device),
        "precision": "bf16" if cfg.bf16 else "fp32",
        "checkpoint_path": ckpt_root,
    })
    event_path = os.path.join(ckpt_root, "tensorboard")
    train_writer = ScalarWriter(event_path + "-train")
    val_writer = ScalarWriter(event_path + "-val")

    best_results: Dict = {"step": -1, "loss": float("inf")}
    epoch_start = min(start_step // opt_steps_per_epoch, n_epoch - 1) + 1
    skip_windows = start_step - (epoch_start - 1) * opt_steps_per_epoch
    if start_step and (epoch_start > 1 or skip_windows):
        log(f"Resuming at epoch {epoch_start}/{n_epoch} (step {start_step}; "
            f"skipping {skip_windows} consumed window(s) of epoch "
            f"{epoch_start}).", log_path)
    log("Begin training...", log_path)

    keys = ("depth", "segmentation", "object_label", "sample_valid")
    step_count = start_step
    done = False
    written = None  # the open trace's output paths (profile_dir)
    with contextlib.ExitStack() as trace:
        for epoch in range(epoch_start, n_epoch + 1):
            if done:
                break
            train_loader.set_epoch(epoch)
            curriculum = get_curriculum_schedule(epoch, n_epoch)
            lr = schedule(epoch - 1)
            loss_sum, loss_count = None, 0
            microbatches = []
            for batch in train_loader:
                microbatches.append(batch)
                if len(microbatches) < cfg.accumulation_steps:
                    continue
                if epoch == epoch_start and skip_windows > 0:
                    skip_windows -= 1
                    microbatches = []
                    continue
                step_batch = _window(microbatches, keys, device)
                A, B = step_batch["object_label"].shape
                if cfg.w_image > 0:
                    # one tower call per accumulation window
                    win = _window(microbatches, ("image", "object_bbox"),
                                  device)
                    crops = prepare_image_crops(
                        win["image"].reshape((A * B,)
                                             + win["image"].shape[2:]),
                        win["object_bbox"].reshape(A * B, 4))
                    step_batch["image_embeddings"] = image_provider(
                        crops).reshape(A, B, -1)
                else:  # the step never reads them
                    step_batch["image_embeddings"] = torch.zeros(
                        A, B, cfg.embedding_dim, device=device)
                microbatches = []
                if cfg.profile_dir and step_count == start_step + 1:
                    written = trace.enter_context(
                        device_trace(cfg.profile_dir))
                state, info = train_step(
                    state, step_batch, (cfg.seed + 1, step_count), lr,
                    curriculum["pct_medium"], curriculum["pct_hard"],
                    text_table, medium_matrix, hard_matrix)
                step_count += 1
                if written is not None and step_count == start_step + 4:
                    _close_trace(trace, written, device, log_path)
                    written = None
                loss_sum = (info["total_loss"] if loss_sum is None
                            else loss_sum + info["total_loss"])
                loss_count += 1

                if step_count % cfg.n_step_per_summary == 0:
                    for tag, key in (("Loss/train_step", "total_loss"),
                                     ("Loss/text_contrast",
                                      "text_contrastive_loss"),
                                     ("Loss/image_contrast",
                                      "image_contrastive_loss"),
                                     ("Loss/smoothness", "smoothness_loss"),
                                     ("Params/temperature_text",
                                      "temperature_text"),
                                     ("Params/temperature_image",
                                      "temperature_image")):
                        train_writer.add_scalar(tag, float(info[key]),
                                                step_count)
                    train_writer.add_scalar("Params/learning_rate", lr,
                                            step_count)
                    train_writer.add_scalars("train/curriculum", curriculum,
                                             step_count)
                if (step_count >= cfg.validation_start_step
                        and step_count % (cfg.n_step_per_validation
                                          or cfg.n_step_per_summary) == 0):
                    best_results = validate_model(
                        state.model, val_loader, text_table, medium_matrix,
                        hard_matrix, equivalence_tensor, equiv_class_map,
                        curriculum, image_provider, step_count, best_results,
                        seed=VAL_SEED, loss_config=loss_cfg,
                        log_path=log_path,
                        summary_writer=val_writer,
                        candidate_labels=candidate_labels,
                        n_sample_per_summary=cfg.n_sample_per_summary)
                if step_count % cfg.n_step_per_checkpoint == 0:
                    avg = float(loss_sum) / loss_count if loss_count else 0.0
                    log_training_summary(log_path, step_count,
                                         n_opt_steps_total, start_step, avg,
                                         time_start)
                    ckpt.save(state)
                if cfg.max_steps is not None and step_count >= cfg.max_steps:
                    done = True
                    break
            avg_epoch = float(loss_sum) / loss_count if loss_count else 0.0
            log(f"Epoch {epoch} END | Step {step_count} | Avg Loss: "
                f"{avg_epoch:.7f} | LR: {lr}", log_path)
            train_writer.add_scalar("Loss/train_epoch", avg_epoch, epoch)
            # plateau scheduling keys on the latest validation loss once one
            # has run, on the epoch's train loss before
            schedule.step_metric(best_results.get("latest_val_loss",
                                                  avg_epoch))
        if written is not None:  # a run shorter than the profiled steps
            _close_trace(trace, written, device, log_path)

    ckpt.save(state)
    log("Training finished.", log_path)
    train_writer.close()
    val_writer.close()
    return best_results
