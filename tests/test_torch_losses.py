"""The port's losses against the JAX package's, on the CPU, with the same
draws on both sides: the JAX draws are rebuilt from its key derivation
(``split(rng)`` into pixel and contrast keys, ``randint`` for the pixels,
``split`` again and ``gumbel`` for the two distractor draws) and handed to
the port.  Held against JAX's default CPU path and, where stated, against
its kernel path traced under ``RANGECLIP_PLATFORM=interpret`` (the TPU's
dispatch: slot-order histogram, class presence, packed CE, ``tv_rowtile``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.losses import hybrid as jax_hybrid
from rangeclip_tpu.losses import infonce as jax_infonce
from rangeclip_tpu.losses.pooling import (
    per_item_masked_pooling as jax_pooling,
)
from rangeclip_tpu.losses.smoothness import (
    total_variation_loss as jax_tv_loss,
)
from rangeclip_tpu_torch.losses import hybrid, infonce
from rangeclip_tpu_torch.losses.pooling import per_item_masked_pooling
from rangeclip_tpu_torch.losses.smoothness import total_variation_loss

t = torch.from_numpy


def jax_draws(key, B, H, W, C, percent=0.7):
    """The port's Draws for what ``compute_hybrid_loss(key, ...)`` draws."""
    key_pix, key_contrast = jax.random.split(key)
    n = infonce.n_draws(H, W, percent)
    pixels = jax.random.randint(key_pix, (B, n), 0, H * W)
    key_mh, key_rand = jax.random.split(key_contrast)
    gumbel = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                   for k in (key_mh, key_rand))
    return hybrid.Draws(t(np.array(pixels, np.int32)), gumbel)


def _similarity(rng, C, per_row=3):
    medium = np.zeros((C, C), bool)
    hard = np.zeros((C, C), bool)
    for row in range(C):
        medium[row, rng.choice(C, per_row, replace=False)] = True
        hard[row, rng.choice(C, per_row, replace=False)] = True
    return medium, hard


@pytest.fixture(params=["default", "interpret"])
def jax_path(request, monkeypatch):
    if request.param == "interpret":
        monkeypatch.setenv("RANGECLIP_PLATFORM", "interpret")
    return request.param


@pytest.mark.parametrize("slots", [1, 2])
def test_sample_pixel_multiplicities_match_jax(slots, jax_path):
    """Weights and labels equal, in both slot layouts and both JAX paths
    (scatter or the interpret-mode histogram kernel)."""
    rng = np.random.default_rng(0)
    target = rng.integers(0, 6, (2, 12, 16)).astype(np.int32)
    key = jax.random.key(1)
    w_j, l_j = jax_infonce.sample_pixel_multiplicities(
        key, jnp.asarray(target), 0.7, slots=slots)
    draws = jax.random.randint(key, (2, infonce.n_draws(12, 16)), 0, 12 * 16)
    w, lab = infonce.sample_pixel_multiplicities(
        t(target), 0.7, slots=slots, draws=t(np.array(draws, np.int32)))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l_j))


@pytest.mark.parametrize("C,k,pct", [
    (40, 50, (0.0, 0.75)),   # the default split; pool and rest < n
    (120, 50, (1.0, 0.0)),   # all medium
    (120, 50, (0.3, 0.5)),   # mixed
    (120, 50, (0.0, 0.0)),   # no medium/hard draw: n == 0
    (120, 0, (0.5, 0.5)),    # k = 0: present labels only
])
def test_build_contrast_mask_matches_jax(C, k, pct, jax_path):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 12, (4, 300)).astype(np.int32)
    valid = (rng.random((4, 300)) > 0.4).astype(np.float32)
    medium, hard = _similarity(rng, C)
    key = jax.random.key(3)
    want = jax_infonce.build_contrast_mask(
        key, jnp.asarray(labels), jnp.asarray(valid), C, jnp.asarray(medium),
        jnp.asarray(hard), k, pct[0], pct[1])
    key_mh, key_rand = jax.random.split(key)
    gumbel = tuple(t(np.array(jax.random.gumbel(kk, (C,))))
                   for kk in (key_mh, key_rand))
    got = infonce.build_contrast_mask(t(labels), t(valid), C, t(medium),
                                      t(hard), k, pct[0], pct[1], gumbel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_contrast_set_matches_jax():
    rng = np.random.default_rng(4)
    text = rng.standard_normal((300, 16)).astype(np.float32)
    for members in (5, 128, 200):
        mask = np.zeros(300, bool)
        mask[rng.choice(300, members, replace=False)] = True
        want = jax_infonce.pack_contrast_set(jnp.asarray(mask),
                                             jnp.asarray(text), 128)
        got = infonce.pack_contrast_set(t(mask), t(text), 128)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pixel_text_infonce_matches_jax(jax_path):
    """f32 slots [4, N] over the [2, 8, 8, 32] field: the port (rows scaled
    by rsqrt, logits times 1/tau) against JAX's XLA formulation (x / norm,
    logits / tau) or its kernel: value and gradients within rtol 1e-5 /
    1e-4; a mask with one member gives 0."""
    rng = np.random.default_rng(5)
    field = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    C = 60
    labels = rng.integers(0, 20, (4, 128)).astype(np.int32)
    valid = rng.integers(0, 3, (4, 128)).astype(np.float32)
    text = rng.standard_normal((C, 32)).astype(np.float32)
    mask = np.zeros(C, bool)
    mask[:20] = True
    mask[rng.choice(C, 10)] = True
    for m in (mask, np.eye(C, dtype=bool)[0]):
        fn = lambda f, tau: jax_infonce.pixel_text_infonce(  # noqa: E731
            f, jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(text),
            jnp.asarray(m), tau, 128)
        want, (gf, gt) = jax.value_and_grad(fn, argnums=(0, 1))(
            jnp.asarray(field), jnp.float32(0.07))
        xs = t(field).requires_grad_()
        ts = torch.tensor(0.07).requires_grad_()
        got = infonce.pixel_text_infonce(xs, t(labels), t(valid), t(text),
                                         t(m), ts, 128)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(xs.grad.numpy(), np.asarray(gf),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(ts.grad), float(gt), rtol=1e-4,
                                   atol=1e-9)


def test_area_image_infonce_and_pooling_match_jax():
    """f32 within rtol 1e-5; fewer than 2 valid instances give 0."""
    rng = np.random.default_rng(6)
    field = rng.standard_normal((4, 8, 8, 32)).astype(np.float32)
    seg = rng.integers(0, 5, (4, 16, 16)).astype(np.int32)
    obj = np.array([1, 2, 9, 3], np.int32)  # 9 covers no pixel
    want = jax_pooling(jnp.asarray(field), jnp.asarray(seg), jnp.asarray(obj),
                       upsample=2)
    area = per_item_masked_pooling(t(field), t(seg), t(obj), upsample=2)
    np.testing.assert_allclose(area.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert not area[2].any()
    image = rng.standard_normal((4, 32)).astype(np.float32)
    for valid in ((1, 1, 0, 1), (0, 1, 0, 0)):
        v = np.asarray(valid, np.float32)
        want = jax_infonce.area_image_infonce(
            jnp.asarray(area.numpy()), jnp.asarray(image), jnp.asarray(v),
            jnp.float32(0.1))
        got = infonce.area_image_infonce(area, t(image), t(v),
                                         torch.tensor(0.1))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dtype,shape", [("f32", (2, 6, 7, 8)),
                                         ("bf16", (3, 8, 16, 128))])
def test_total_variation_loss_matches_jax(dtype, shape, jax_path):
    """Upsample 2 and sample weights with a 0: the value within rtol 1e-5
    and the gradient bit-equal (the bf16 case runs ``tv_rowtile`` on the
    JAX interpret path)."""
    rng = np.random.default_rng(7)
    x = (rng.integers(-4, 5, shape) / 4).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    w = np.zeros(shape[0], np.float32)
    w[0] = 1.0
    w[-1] = 1.0
    for weight in (None, w):
        fn = lambda v: jax_tv_loss(  # noqa: E731
            v, 2, None if weight is None else jnp.asarray(weight))
        want, vjp = jax.vjp(fn, jnp.asarray(x).astype(jdt))
        (gx,) = vjp(jnp.float32(1.0))
        xs = t(x).to(tdt).requires_grad_()
        got = total_variation_loss(xs, 2,
                                   None if weight is None else t(weight))
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_array_equal(xs.grad.float().numpy(),
                                      np.asarray(gx.astype(jnp.float32)))


@pytest.mark.parametrize("class_balanced", [False, True])
def test_compute_hybrid_loss_matches_jax(class_balanced, jax_path):
    """Total and info of the full hybrid loss (native mode, s = 2, a padded
    batch item) with the same draws: f32 within rtol 1e-5 on the default
    path; on the interpret path JAX runs the kernels on a bf16 field (the
    packed CE, tv_rowtile), held within rtol 2e-3 (bf16 operand roundings
    of rows whose rsqrt scale differs by an ulp, see
    test_torch_train_kernels)."""
    rng = np.random.default_rng(8)
    B, h, D, C = 2, 16, 128, 48
    bf16 = jax_path == "interpret"
    field = rng.standard_normal((B, h, h, D)).astype(np.float32)
    field /= np.linalg.norm(field, axis=-1, keepdims=True)
    seg = rng.integers(0, 10, (B, 2 * h, 2 * h)).astype(np.int32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    medium, hard = _similarity(rng, C)
    area = rng.standard_normal((B, D)).astype(np.float32)
    image = rng.standard_normal((B, D)).astype(np.float32)
    sample_valid = np.array([1.0, 0.0], np.float32)
    cfg_kw = dict(class_balanced=class_balanced)
    key = jax.random.key(9)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want, winfo = jax_hybrid.compute_hybrid_loss(
        key, jnp.asarray(field).astype(jdt), jnp.asarray(seg),
        jnp.asarray(text), jnp.asarray(medium), jnp.asarray(hard),
        jnp.float32(0.07), jnp.float32(0.1), 0.3, 0.5,
        jnp.asarray(area), jnp.asarray(image), jnp.asarray(sample_valid),
        jnp.asarray(sample_valid), jax_hybrid.HybridLossConfig(**cfg_kw),
        label_upsample=2)
    draws = jax_draws(key, B, 2 * h, 2 * h, C)
    got, info = hybrid.compute_hybrid_loss(
        t(field).to(torch.bfloat16 if bf16 else torch.float32), t(seg),
        t(text), t(medium), t(hard), torch.tensor(0.07), torch.tensor(0.1),
        0.3, 0.5, t(area), t(image), t(sample_valid), t(sample_valid),
        hybrid.HybridLossConfig(**cfg_kw), label_upsample=2, draws=draws)
    rtol = 2e-3 if bf16 else 1e-5
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    assert sorted(info) == sorted(winfo)
    for k, v in winfo.items():
        np.testing.assert_allclose(float(info[k]), float(v), rtol=rtol,
                                   err_msg=k)


def test_class_balance_out_of_range_labels_weigh_zero():
    """JAX fills the weight of a label outside [0, C) with NaN
    (hybrid.py:227, ``jnp.take``'s fill); the port gives it weight 0 and
    keeps the in-range weights JAX gives."""
    labels = torch.tensor([[1, 2, 2, 7, -1]], dtype=torch.int32)
    valid = torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0]])
    got = hybrid.class_balance(labels, valid, 5)
    assert torch.isfinite(got).all()
    assert got[0, 3] == 0 and got[0, 4] == 0
    counts = np.array([0, 1, 2, 0, 0], np.float32)  # hybrid.py:218-226
    mult = counts.sum() / (2 * np.maximum(counts, 1e-9))
    np.testing.assert_allclose(got[0, :3].numpy(),
                               [mult[1], mult[2], mult[2]], rtol=1e-6)
