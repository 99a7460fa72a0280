"""The training slice's plain kernel versions against the JAX Pallas kernels
run with ``interpret=True`` on the CPU: ``histogram``, ``pixel_text_ce``
(value, d samples, d temperature) and ``tv_rowtile`` (value and VJP).  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs come from numpy
seeds; each tolerance is stated where it is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rangeclip_tpu.losses.smoothness import _tv as jax_tv
from rangeclip_tpu.ops.pallas.histogram import fused_histogram
from rangeclip_tpu.ops.pallas.pixel_text_ce import (
    fused_pixel_text_ce as jax_ce,
)
from rangeclip_tpu.ops.pallas.tv_rowtile import (
    kernel_applicable as jax_tv_applicable,
    tv_rowtile as jax_tv_rowtile,
)
from rangeclip_tpu.utils.math import l2_normalize as jax_l2
from rangeclip_tpu_torch.ops.kernels import histogram as hist_k
from rangeclip_tpu_torch.ops.kernels import pixel_text_ce as ce_k
from rangeclip_tpu_torch.ops.kernels import tv_rowtile as tv_k

t = torch.from_numpy


def test_histogram_plain_bit_equal_to_pallas():
    """-1 padding and slot-remapped draws (the s=2 native layout)."""
    rng = np.random.default_rng(0)
    B, H, W = 3, 16, 24
    draws = rng.integers(0, H * W, (B, 700))
    y, x = draws // W, draws % W
    h, w = H // 2, W // 2
    slotted = ((y % 2) * 2 + (x % 2)) * (h * w) + (y // 2) * w + (x // 2)
    for idx in (draws, slotted):
        idx = idx.astype(np.int32)
        idx[:, ::11] = -1
        want = np.asarray(fused_histogram(jnp.asarray(idx), H * W,
                                          interpret=True))
        got = hist_k.histogram(t(idx), H * W)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _ce_case(rng, dtype, shape, C, slots, packed):
    """Inputs of both sides: samples (numpy f32, cast per side), labels and
    valid [S, N] (valid labels are members of the mask), the normalised
    table, the mask and, packed, the class ids with sentinel C."""
    N = int(np.prod(shape[:-1]))
    D = shape[-1]
    samples = rng.standard_normal(shape).astype(np.float32)
    members = np.sort(rng.choice(C, 40, replace=False))
    mask = np.zeros(C, bool)
    mask[members] = True
    labels = members[rng.integers(0, 40, (slots, N))].astype(np.int32)
    valid = rng.integers(0, 3, (slots, N)).astype(np.float32)
    text = np.array(jax_l2(jnp.asarray(
        rng.standard_normal((C, D)).astype(np.float32)), axis=-1))
    ids = None
    if packed:
        ids = np.full(128, C, np.int32)
        ids[:40] = members
    return samples, labels, valid, text, mask, ids


@pytest.mark.parametrize("dtype,shape,slots,packed", [
    ("f32", (300, 32), 1, False),
    ("f32", (2, 16, 16, 128), 4, False),
    ("bf16", (2, 16, 16, 128), 4, True),
    ("bf16", (300, 32), 1, True),
    ("bf16", (2, 16, 16, 128), 1, False),
])
def test_pixel_text_ce_plain_matches_pallas(dtype, shape, slots, packed):
    """Value, d samples and d temperature of the port's CPU route (the plain
    forward and the written-out backward) against ``fused_pixel_text_ce``
    in interpret mode.  Both normalise rows with rsqrt(max(sum x^2,
    1e-24)), the port summing in f64: f32 values within rtol 1e-5,
    gradients within rtol 1e-4 (atol 1e-6 of the largest entry); bf16
    rows whose scale rounds differently round their bf16 operand
    differently, so bf16 values within rtol 1e-3, d samples within 2 bf16
    ulps of the largest entry of the row, d temperature rtol 1e-3."""
    rng = np.random.default_rng(1)
    C = 200
    samples, labels, valid, text, mask, ids = _ce_case(rng, dtype, shape, C,
                                                       slots, packed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    temp = np.float32(0.07)
    lab = labels if slots > 1 else labels[0]
    val = valid if slots > 1 else valid[0]
    if packed:
        table = text[np.minimum(ids, C - 1)]
        jmask = ids < C
    else:
        table, jmask = text, mask

    def jax_fn(s, tau):
        return jax_ce(s, tau, jnp.asarray(lab), jnp.asarray(val),
                      jnp.asarray(table), jnp.asarray(jmask), 512, True,
                      None if ids is None else jnp.asarray(ids))

    js = jnp.asarray(samples).astype(jdt)
    want, (gs, gt) = jax.value_and_grad(jax_fn, argnums=(0, 1))(js, temp)

    xs = t(samples).to(tdt).requires_grad_()
    ts = torch.tensor(temp).requires_grad_()
    ttab = t(text).to(tdt)
    packed_args = None
    if packed:
        packed_args = (t(table).to(tdt), t(ids < C), t(ids),
                       torch.tensor(True))
    got = ce_k.fused_pixel_text_ce(xs, ts, t(lab), t(val), ttab, t(mask),
                                   packed_args)
    got.backward()
    assert xs.grad.dtype == tdt and xs.grad.shape == xs.shape
    gs = np.asarray(gs.astype(jnp.float32))
    dx = xs.grad.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(dx, gs, rtol=1e-4,
                                   atol=1e-6 * np.abs(gs).max())
        np.testing.assert_allclose(float(ts.grad), float(gt), rtol=1e-4)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
        np.testing.assert_allclose(float(ts.grad), float(gt), rtol=1e-3)
        rows = dx.reshape(-1, shape[-1])
        ref = gs.reshape(-1, shape[-1])
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(rows - ref) <= 2 * scale * 2.0 ** -8).all()


def test_pixel_text_ce_packed_overflow_reads_the_flag():
    """A false flag scores the full table (the lax.cond's other branch):
    equal to the unpacked call; a true flag with every member packed
    equals it too, up to f32 summation order (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    samples, labels, valid, text, mask, ids = _ce_case(
        rng, "bf16", (256, 32), 300, 4, True)
    args = (t(samples).bfloat16(), torch.tensor(0.07), t(labels), t(valid),
            t(text).bfloat16(), t(mask))
    full = ce_k.fused_pixel_text_ce(*args)
    ptable = t(text[np.minimum(ids, 299)]).bfloat16()
    for flag in (False, True):
        packed = (ptable, t(ids < 300), t(ids), torch.tensor(flag))
        got = ce_k.fused_pixel_text_ce(*args, packed)
        np.testing.assert_allclose(float(got), float(full), rtol=1e-6)


@pytest.mark.parametrize("shape,weights,upsample", [
    ((3, 16, 16, 128), (1.0, 0.0, 1.0), 2),
    ((2, 12, 8, 128), None, 1),
])
def test_tv_rowtile_plain_matches_pallas(shape, weights, upsample):
    """bf16 with ties, several row tiles (the 1 MB forward tile is forced
    down by the image size), a zero weight: the plain value within rtol 1e-5
    (f32 partial-sum order) and its VJP bit-equal to the kernel in interpret
    mode, as the JAX package's own test finds its XLA VJP."""
    rng = np.random.default_rng(3)
    x = (rng.integers(-6, 7, shape) / 4 + rng.standard_normal(shape)
         * (rng.random(shape) > 0.5)).astype(np.float32)
    assert jax_tv_applicable(shape, jnp.bfloat16)
    assert tv_k.kernel_applicable(shape, torch.bfloat16)
    w = None if weights is None else np.asarray(weights, np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    fn = lambda v: jax_tv_rowtile(  # noqa: E731
        v, None if w is None else jnp.asarray(w), upsample, True)
    want, vjp = jax.vjp(fn, jx)
    (gx,) = vjp(jnp.float32(1.7))
    xs = t(x).bfloat16().requires_grad_()
    got = tv_k.tv_rowtile(xs, None if w is None else t(w), upsample)
    got.backward(torch.tensor(1.7))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(xs.grad.float().numpy(),
                                  np.asarray(gx.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tv_plain_vjp_matches_jax(dtype):
    """The plain TV and its hand-derived VJP against the JAX ``_tv``: the
    gradient bit-equal (+1 at ties), the value within rtol 1e-6."""
    rng = np.random.default_rng(4)
    x = (rng.integers(-3, 4, (2, 5, 7, 6)) / 2).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want, vjp = jax.vjp(lambda v: jax_tv(v, 2), jnp.asarray(x).astype(jdt))
    (gx,) = vjp(jnp.float32(0.3))
    xs = t(x).to(tdt).requires_grad_()
    got = tv_k.tv_plain(xs, 2)
    got.backward(torch.tensor(0.3))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(xs.grad.float().numpy(),
                                  np.asarray(gx.astype(jnp.float32)))


def test_fake_implementations_give_the_output_metadata():
    """The operators are CUDA-only; their fake implementations (what
    ``torch.export`` and ``torch.compile`` trace with) give the shapes and
    dtypes of the real outputs.  ``opcheck`` runs on the card."""
    with FakeTensorMode():
        idx = torch.empty(3, 50, dtype=torch.int32)
        assert hist_k.histogram_op(idx, 70).shape == (3, 70)
        x = torch.empty(2, 4, 8, 16, dtype=torch.bfloat16)
        assert tv_k.tv_rowtile_op(x, None, 2).shape == ()
        dx = tv_k.tv_rowtile_backward_op(x, None, torch.empty(()), 2)
        assert dx.shape == x.shape and dx.dtype == torch.bfloat16
        s = torch.empty(64, 16, dtype=torch.bfloat16)
        args = (s, torch.empty(()), torch.empty(4, 64, dtype=torch.int32),
                torch.empty(4, 64), torch.empty(10, 16, dtype=torch.bfloat16),
                torch.empty(10, dtype=torch.int32), None, None, None, None)
        out = ce_k.pixel_text_ce_op(*args)
        assert out.shape == () and out.dtype == torch.float32
        ds, dt = ce_k.pixel_text_ce_backward_op(torch.empty(()), *args)
        assert ds.shape == s.shape and ds.dtype == s.dtype and dt.shape == ()
