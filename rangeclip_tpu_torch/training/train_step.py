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
``torch.Generator`` seeded by (seed, step, i) on the batch's device, in the
JAX order: pixel draws, then the medium/hard Gumbel noise, then the random
one (``fold_in(rng, i)``, ``split`` into pixel and contrast keys, ``split``
again).  Every draw can be passed in instead (``draws``), which is how the
tests feed the JAX draws.
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
from rangeclip_tpu_torch.training.optim import set_learning_rate
from rangeclip_tpu_torch.training.state import TrainState

INFO_KEYS = ("total_loss", "text_contrastive_loss", "image_contrastive_loss",
             "smoothness_loss", "temperature_text", "temperature_image",
             "W_text", "W_image", "W_smooth")


def microbatch_generator(seed: int, step: int, index: int,
                         device: torch.device) -> torch.Generator:
    """The generator of microbatch ``index`` of step ``step``: positional,
    so a resumed run draws what a straight run draws."""
    state = np.random.SeedSequence((seed, step, index)).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def microbatch_loss(model: DepthUNet, mb: Dict[str, torch.Tensor],
                    pct_medium: float, pct_hard: float,
                    text_table: torch.Tensor, medium_matrix: torch.Tensor,
                    hard_matrix: torch.Tensor,
                    loss_config: HybridLossConfig = HybridLossConfig(),
                    draws: Optional[Draws] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch's hybrid loss (train_step.py:69-130): ``mb`` holds
    depth [B, H, W, 1], segmentation [B, H, W], object_label [B],
    image_embeddings [B, D] and sample_valid [B]."""
    field, temp_t, temp_i = model.forward_native(mb["depth"])
    H = mb["depth"].shape[1]
    ups = H // field.shape[1]
    if H != ups * field.shape[1]:
        raise ValueError(f"depth height {H} vs native field {field.shape}")
    use_image = loss_config.w_image > 0
    area = image = None
    if use_image:
        area = per_item_masked_pooling(field, mb["segmentation"],
                                       mb["object_label"], upsample=ups)
        image = mb["image_embeddings"]
    return compute_hybrid_loss(
        field, mb["segmentation"], text_table, medium_matrix, hard_matrix,
        temp_t, temp_i, pct_medium, pct_hard, area, image,
        area_valid=mb["sample_valid"] if use_image else None,
        sample_weight=mb["sample_valid"], config=loss_config,
        label_upsample=ups, draws=draws, generator=generator)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(loss_config: HybridLossConfig = HybridLossConfig(),
                    accum_steps: int = 8):
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
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   rng: Tuple[int, int], lr: float, pct_medium: float,
                   pct_hard: float, text_table: torch.Tensor,
                   medium_matrix: torch.Tensor, hard_matrix: torch.Tensor,
                   draws: Optional[List[Draws]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, optimizer = state.model, state.optimizer
        A = batch["depth"].shape[0]
        if A != accum_steps:
            raise ValueError(f"batch has {A} microbatches, the step "
                             f"accumulates {accum_steps}")
        model.train()
        # every parameter's, not only the optimizer's: a frozen encoder's
        # gradients count in grad_norm and must not add up over steps
        model.zero_grad(set_to_none=True)
        info_sum = None
        for idx in range(A):
            mb = {k: v[idx] for k, v in batch.items()}
            generator = (None if draws is not None else microbatch_generator(
                rng[0], rng[1], idx, batch["depth"].device))
            total, info = microbatch_loss(
                model, mb, pct_medium, pct_hard, text_table, medium_matrix,
                hard_matrix, loss_config,
                draws[idx] if draws is not None else None, generator)
            total.backward()
            info = {k: info[k].detach().float() for k in INFO_KEYS}
            info_sum = info if info_sum is None else {
                k: info_sum[k] + info[k] for k in INFO_KEYS}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        for g in grads:
            g.div_(A)
        info = {k: v / A for k, v in info_sum.items()}
        info["grad_norm"] = global_norm(grads)
        info["learning_rate"] = info["grad_norm"].new_tensor(lr)
        set_learning_rate(optimizer, lr)
        optimizer.step()
        state.step += 1
        return state, info

    return train_step
