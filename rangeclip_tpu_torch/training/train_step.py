"""The train step (``rangeclip_tpu/training/train_step.py``,
``make_train_step`` in its default configuration): one accumulation window
of A microbatches, then one Adam update.

For each microbatch: ``forward_native`` in train mode (BatchNorm normalises
with the batch's statistics and updates its running ones, as the JAX scan
carry does), per-item area pooling, the hybrid loss at native resolution,
backward.  Then the gradients (summed by autograd) are divided by A, Adam
steps with the learning rate set for this step, and the info dict is the
mean over A plus ``learning_rate`` and ``grad_norm`` (the global norm of
the averaged gradients).  One device; BatchNorm over the microbatch.

Random state: microbatch ``i`` of the step keyed (seed, step) draws from a
``torch.Generator`` seeded by (seed, step, i) on the batch's device (under
``ddp_parity``, rank r > 0 by (seed, step, i, r), as JAX folds the rank
into the key; rank 0 keeps the single-device stream), in the JAX order: pixel draws (``loss_config.pixel_sampler``: the histogram's
uniform draws, or the multinomial counts), then the medium/hard Gumbel
noise, then the random one (``fold_in(rng, i)``, ``split`` into pixel and
contrast keys, ``split`` again).  Every draw can be passed in instead
(``draws``), which is how the tests feed the JAX draws.  JAX hoists the
multinomial sampler out of its scan and gradient
(train_step.py:172-180,236-270) only because XLA re-runs
``jax.random.binomial``'s rejection loops there; this loop is eager, so the
sampler runs where the loss calls it.

Over a process group (``group``, a ``torch.distributed`` group of more
than one rank, each holding B rows of every microbatch) there are two
steps:

* The global-batch step (the default; JAX's step jitted over a 'data'
  mesh, train_step.py:22-30).  Every rank ends with what the single-device
  step gives on the ``world * B``-row batch formed by the ranks' rows in
  rank order: the same loss, info, gradients, BatchNorm running statistics
  and parameters, up to the rounding of the sums' order.  BatchNorm takes
  the global batch's statistics (``ops/blocks.sync_batch_norm``, entered
  for the step's duration); the microbatch generators are the rank-less
  ones, so the pixel draws are made for the whole global batch and each
  rank keeps its rows, and the Gumbel noise is the same on every rank; the
  contrast set is taken over every rank's rows, and each loss term is this
  rank's share, its rows' partial sums over the global denominators
  (``losses/``, ``parallel/kernel_shard.py``).  The gradients (summed over
  the window, over A) and the info's loss terms are SUM all-reduced once a
  window; ``grad_norm`` is taken on the reduced gradients, and Adam moves
  every replica alike.  ``draws`` then hold the global batch's draws.  A
  group of one rank is the single-device step, bit for bit.
* ``ddp_parity`` (JAX ``train_step.py:32-44,186-218``) is the reference's
  torch DDP: each rank runs the single-device step on its own rows (its
  BatchNorm normalises with its local statistics, its losses normalise
  over its rows), then, by explicit collectives in flattened buckets
  (``parallel/mesh.all_reduce_mean``): after each microbatch the BatchNorm
  running statistics are averaged over the ranks (JAX's pmean merge of
  ``new_stats``, where torch DDP broadcasts rank 0's), and after the window
  the gradients (once a window, not once a microbatch: the sum over
  microbatches and the mean over ranks commute, so only the f32 rounding
  order differs, within JAX's own test tolerances) and the info.  The
  ``DistributedDataParallel`` wrapper is not used: the step calls
  ``forward_native``, which its reducer never sees, and it broadcasts
  buffers where JAX averages them.

On a grid (``group`` a ``parallel/mesh.Grid``: JAX's step jitted over a
``data x spatial x model`` mesh, ``tests/test_parallel.py:77-113``) the
global-batch step holds its data block of the images and its spatial block
of their rows (``Grid.local_batch``).  The forward and the loss run inside
``parallel/halo.sharded_rows``: the convolutions fetch their halo rows from
the neighbouring spatial ranks, forward and backward.  BatchNorm's
statistics, the loss's pixel sums and the gradients are summed over the
'batch' group (data x spatial of the rank's model column, never over
'model', whose ranks compute the same rows; model rank 0's gradients,
losses and statistics are broadcast over the 'model' group, so that the
replicas end bit-equal even where a kernel rounds otherwise from run to
run, as oneDNN's bf16 convolutions do on the CPU); image-level terms per
data block.  Class tables sharded over 'model'
(``mesh.shard_class_tables(shard_classes=True)``) are gathered whole once
a step before the loss; they are frozen.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.losses.hybrid import (
    Draws,
    HybridLossConfig,
    compute_hybrid_loss,
)
from rangeclip_tpu_torch.losses.pooling import per_item_masked_pooling
from rangeclip_tpu_torch.models.depth_unet import DepthUNet
from rangeclip_tpu_torch.ops.blocks import sync_batch_norm
from rangeclip_tpu_torch.parallel.halo import sharded_rows
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    all_reduce_mean,
    as_grid,
    broadcast,
    gather_class_table,
)
from rangeclip_tpu_torch.parallel.mesh import rank as group_rank
from rangeclip_tpu_torch.parallel.mesh import world as group_world
from rangeclip_tpu_torch.training.optim import set_learning_rate
from rangeclip_tpu_torch.training.state import TrainState

LOSS_KEYS = ("total_loss", "text_contrastive_loss", "image_contrastive_loss",
             "smoothness_loss")
INFO_KEYS = LOSS_KEYS + ("temperature_text", "temperature_image", "W_text",
                         "W_image", "W_smooth")


def microbatch_generator(seed: int, step: int, index: int,
                         device: torch.device, rank: Optional[int] = None
                         ) -> torch.Generator:
    """The generator of microbatch ``index`` of step ``step`` (of ``rank``
    under ``ddp_parity``; rank 0 draws what one device draws, and so does
    every rank of the global-batch step): positional, so a resumed run draws
    what a straight run draws."""
    key = (seed, step, index) + ((rank,) if rank else ())
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def microbatch_loss(model: DepthUNet, mb: Dict[str, torch.Tensor],
                    pct_medium: float, pct_hard: float,
                    text_table: torch.Tensor, medium_matrix: torch.Tensor,
                    hard_matrix: torch.Tensor,
                    loss_config: HybridLossConfig = HybridLossConfig(),
                    draws: Optional[Draws] = None,
                    generator: Optional[torch.Generator] = None,
                    group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch's hybrid loss (train_step.py:69-130): ``mb`` holds
    depth [B, H, W, 1], segmentation [B, H, W], object_label [B],
    image_embeddings [B, D] and sample_valid [B]; under ``group`` these are
    this rank's block of the global batch and the losses its shares (under
    a 'spatial' axis, inside ``halo.sharded_rows``)."""
    field, temp_t, temp_i = model.forward_native(mb["depth"])
    H = mb["depth"].shape[1]
    ups = H // field.shape[1]
    if H != ups * field.shape[1]:
        raise ValueError(f"depth height {H} vs native field {field.shape}")
    use_image = loss_config.w_image > 0
    area = image = None
    if use_image:
        area = per_item_masked_pooling(field, mb["segmentation"],
                                       mb["object_label"], upsample=ups,
                                       group=group)
        image = mb["image_embeddings"]
    return compute_hybrid_loss(
        field, mb["segmentation"], text_table, medium_matrix, hard_matrix,
        temp_t, temp_i, pct_medium, pct_hard, area, image,
        area_valid=mb["sample_valid"] if use_image else None,
        sample_weight=mb["sample_valid"], config=loss_config,
        label_upsample=ups, draws=draws, generator=generator, group=group)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def running_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The floating buffers of the modules in train mode: the BatchNorm
    running statistics a train-mode forward updates (a frozen encoder's
    stay out)."""
    return [b for m in model.modules() if m.training
            for b in m.buffers(recurse=False) if b.is_floating_point()]


def make_train_step(loss_config: HybridLossConfig = HybridLossConfig(),
                    accum_steps: int = 8, ddp_parity: bool = False,
                    group=None):
    """The step function

      step(state, batch, rng, lr, pct_medium, pct_hard, text_table,
           medium_matrix, hard_matrix, draws=None) -> (state, info)

    ``batch`` holds tensors with a leading accumulation axis A == accum_steps
    on the model's device: depth [A, B, H, W, 1] f32, segmentation
    [A, B, H, W] int32, object_label [A, B] int32, image_embeddings
    [A, B, D] f32, sample_valid [A, B] f32.  ``rng`` is (seed, step) and
    keys the microbatch generators; ``draws`` (a list of A
    :class:`Draws`) replaces them.  The state is updated in place and
    returned; the info values are f32 scalar tensors (no host sync).

    With ``group`` (a ``torch.distributed`` process group, or
    ``torch.distributed.group.WORLD``) ``batch`` is this rank's rows, and
    the step is the module docstring's global-batch step, or its DDP with
    ``ddp_parity``; with a grid (``parallel/mesh.make_grid``) it is this
    rank's block (``Grid.local_batch``: its images, and under a 'spatial'
    axis an even count of rows, the same on every spatial rank), and the
    tables may be ``shard_class_tables``' model slices.  Without ``group``
    it is the single-device step.
    """
    if ddp_parity and isinstance(group, Grid):
        raise ValueError("ddp_parity takes a process group (each rank the "
                         "single-device step on its rows), not a grid")
    reduce = group is not None and ddp_parity
    # the global-batch step's grid; one rank is the single-device step
    grid = None if ddp_parity else as_grid(group)
    if grid is not None and grid.size("batch") * grid.n_model == 1:
        grid = None
    rank = (group_rank(group) if group is not None else 0) \
        if ddp_parity else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   rng: Tuple[int, int], lr: float, pct_medium: float,
                   pct_hard: float, text_table, medium_matrix, hard_matrix,
                   draws: Optional[List[Draws]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, optimizer = state.model, state.optimizer
        A = batch["depth"].shape[0]
        if A != accum_steps:
            raise ValueError(f"batch has {A} microbatches, the step "
                             f"accumulates {accum_steps}")
        text_table, medium_matrix, hard_matrix = (
            gather_class_table(t, grid)
            for t in (text_table, medium_matrix, hard_matrix))
        rows, width = batch["depth"].shape[2:4]
        if grid is not None and grid.n_spatial > 1:
            # every spatial rank must see the same global height: the same
            # even count of rows on each (a collective, so all raise)
            blocks = grid.gather(torch.tensor(
                [rows], device=batch["depth"].device), "spatial").tolist()
            if len(set(blocks)) > 1 or rows % 2:
                raise ValueError(f"spatial blocks of {blocks} rows: the "
                                 f"height must divide by 2 x the 'spatial' "
                                 f"size {grid.n_spatial}")
        shape = (rows * (1 if grid is None else grid.n_spatial), width)
        model.train()
        # every parameter's, not only the optimizer's: a frozen encoder's
        # gradients count in grad_norm and must not add up over steps
        model.zero_grad(set_to_none=True)
        info_sum = None
        with sync_batch_norm(None if grid is None else grid.group("batch")), \
                sharded_rows(grid, shape):
            for idx in range(A):
                mb = {k: v[idx] for k, v in batch.items()}
                generator = (None if draws is not None
                             else microbatch_generator(
                                 rng[0], rng[1], idx, batch["depth"].device,
                                 rank))
                total, info = microbatch_loss(
                    model, mb, pct_medium, pct_hard, text_table,
                    medium_matrix, hard_matrix, loss_config,
                    draws[idx] if draws is not None else None, generator,
                    grid)
                total.backward()
                if reduce:
                    with torch.no_grad():
                        all_reduce_mean(running_statistics(model), group)
                info = {k: info[k].detach().float() for k in INFO_KEYS}
                info_sum = info if info_sum is None else {
                    k: info_sum[k] + info[k] for k in INFO_KEYS}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        for g in grads:
            g.div_(A)
        info = {k: v / A for k, v in info_sum.items()}
        if grid is not None:
            # the shares add up to the global batch's gradients and losses
            losses = torch.stack([info[k] for k in LOSS_KEYS])
            grid.sum(grads + [losses], "batch")
            if grid.n_model > 1:
                # the model replicas computed the same rows, but a kernel
                # may round otherwise from run to run: one set of bits
                broadcast(grads + [losses] + running_statistics(model),
                          grid.group("model"))
            info.update(zip(LOSS_KEYS, losses.unbind()))
        if reduce:
            all_reduce_mean(grads, group)
            mean = torch.stack([info[k] for k in INFO_KEYS])
            all_reduce_mean([mean], group)
            info = dict(zip(INFO_KEYS, mean.unbind()))
        info["grad_norm"] = global_norm(grads)
        info["learning_rate"] = info["grad_norm"].new_tensor(lr)
        set_learning_rate(optimizer, lr)
        optimizer.step()
        state.step += 1
        return state, info

    return train_step
