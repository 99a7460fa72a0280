"""The multinomial pixel sampler (``losses/infonce.py``
``multinomial_counts`` and ``sample_pixel_multiplicities_multinomial``;
``HybridLossConfig(pixel_sampler="multinomial")``) on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the counts are
held to their law, as JAX's own test holds its sampler
(tests/test_losses.py:455-494): every row sums to exactly n, and over many
rows each bin's mean is n / n_bins within 4.5 standard errors and the
Pearson statistic passes a chi-square test at p > 1e-4.  The slot layout is
held exactly: with every label valid, JAX's ``slots=1`` output for a key is
its counts; fed to the port's slotting, they give JAX's ``slots=s`` output
for the same key.  Then the hybrid loss and a train step with the sampler
are finite, with finite gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rangeclip_tpu.losses import infonce as jax_infonce
from rangeclip_tpu_torch.losses.hybrid import (
    Draws,
    HybridLossConfig,
    compute_hybrid_loss,
)
from rangeclip_tpu_torch.losses.infonce import (
    multinomial_counts,
    sample_pixel_multiplicities_multinomial,
)

Z_LIMIT = 4.5
P_LIMIT = 1e-4


@pytest.mark.parametrize("n, n_bins", [(1000, 48), (700, 64), (45, 7),
                                       (9, 1)])
def test_multinomial_counts_law(n, n_bins):
    gen = torch.Generator().manual_seed(n_bins)
    rows = 400
    counts = multinomial_counts(n, n_bins, batch=rows, generator=gen)
    assert counts.shape == (rows, n_bins) and counts.dtype == torch.float32
    c = counts.numpy().astype(np.float64)
    np.testing.assert_array_equal(c.sum(axis=1), n)
    assert (c >= 0).all() and (c == np.round(c)).all()
    if n_bins == 1:
        return
    p = 1.0 / n_bins
    z = (c.mean(axis=0) - n * p) / np.sqrt(n * p * (1 - p) / rows)
    assert np.abs(z).max() < Z_LIMIT, z
    pearson = ((c - n * p) ** 2 / (n * p)).sum()
    assert stats.chi2.sf(pearson, rows * (n_bins - 1)) > P_LIMIT
    assert stats.chi2.cdf(pearson, rows * (n_bins - 1)) > P_LIMIT


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_slot_layout_matches_jax_on_jax_counts(slots):
    B, H, W = 2, 8, 16
    rng = np.random.default_rng(slots)
    key = jax.random.key(11 + slots)
    valid_seg = rng.integers(1, 6, (B, H, W)).astype(np.int32)
    counts, _ = jax_infonce.sample_pixel_multiplicities_multinomial(
        key, jnp.asarray(valid_seg), percent=0.7, slots=1)
    counts = np.array(counts).reshape(B, H * W)
    assert counts.sum() == 2 * int(0.7 * H * W)

    seg = valid_seg.copy()
    seg[:, :3] = 0  # background rows: weight 0
    for target in (valid_seg, seg):
        want_w, want_l = jax_infonce.sample_pixel_multiplicities_multinomial(
            key, jnp.asarray(target), percent=0.7, slots=slots)
        got_w, got_l = sample_pixel_multiplicities_multinomial(
            torch.from_numpy(target), percent=0.7, slots=slots,
            counts=torch.from_numpy(counts))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def _loss_inputs(gen, B=2, h=8, w=8, s=2, C=12, D=16):
    field = torch.nn.functional.normalize(
        torch.randn(B, h, w, D, generator=gen), dim=-1).requires_grad_()
    seg = torch.randint(0, 6, (B, h * s, w * s), generator=gen,
                        dtype=torch.int32)
    text = torch.randn(C, D, generator=gen)
    medium = torch.rand(C, C, generator=gen) < 0.2
    hard = torch.rand(C, C, generator=gen) < 0.2
    return field, seg, text, medium, hard


def test_hybrid_loss_multinomial_finite_with_gradient():
    gen = torch.Generator().manual_seed(0)
    field, seg, text, medium, hard = _loss_inputs(gen)
    cfg = HybridLossConfig(pixel_sampler="multinomial")
    total, info = compute_hybrid_loss(
        field, seg, text, medium, hard, torch.tensor(0.07), torch.tensor(0.1),
        0.0, 0.75, sample_weight=torch.tensor([1.0, 0.0]), config=cfg,
        label_upsample=2, generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(total) and info["text_contrastive_loss"] > 0
    total.backward()
    assert torch.isfinite(field.grad).all() and field.grad.abs().sum() > 0

    # injected counts replace the draw: one count on every pixel of the
    # first image weighs its valid pixels alike, whatever the generator
    counts = torch.zeros(2, 16 * 16)
    counts[0] = 1.0
    losses = [compute_hybrid_loss(
        field, seg, text, medium, hard, torch.tensor(0.07), torch.tensor(0.1),
        0.0, 0.75, config=cfg, label_upsample=2, draws=Draws(
            counts=counts, gumbel=(torch.zeros(12), torch.zeros(12))),
        generator=torch.Generator().manual_seed(seed))[1][
            "text_contrastive_loss"] for seed in (5, 6)]
    assert torch.isfinite(losses[0]) and losses[0] == losses[1]


def test_train_step_with_the_multinomial_sampler():
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
    from rangeclip_tpu_torch.training.state import create_train_state
    from rangeclip_tpu_torch.training.train_step import make_train_step

    gen = torch.Generator().manual_seed(1)
    state = create_train_state(
        DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                        embedding_dim=32), torch.device("cpu"), 1e-3, seed=2)
    seg = torch.randint(0, 6, (2, 2, 32, 32), generator=gen,
                        dtype=torch.int32)
    batch = {"depth": torch.randn(2, 2, 32, 32, 1, generator=gen),
             "segmentation": seg, "object_label": seg[:, :, 5, 5],
             "image_embeddings": torch.randn(2, 2, 32, generator=gen),
             "sample_valid": torch.ones(2, 2)}
    step = make_train_step(HybridLossConfig(pixel_sampler="multinomial"), 2)
    text = torch.randn(12, 32, generator=gen)
    mask = torch.rand(12, 12, generator=gen) < 0.2
    state, info = step(state, batch, (0, 0), 1e-3, 0.0, 0.75, text, mask,
                       mask)
    assert state.step == 1
    assert all(torch.isfinite(v) for v in info.values()), info
    assert info["text_contrastive_loss"] > 0


def test_unknown_sampler_is_refused():
    with pytest.raises(ValueError, match="pixel_sampler"):
        HybridLossConfig(pixel_sampler="poisson")
