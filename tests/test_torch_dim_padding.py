"""Embedding widths D % 8 != 0 and the all-valid presence route, on the CPU.

On the card, the wrappers of ``pixel_text_ce``, ``pixel_text_topk``,
``masked_pooling`` and ``tv_loss`` zero-pad D up to a multiple of 8 before
their kernels (``masked_pooling`` also cuts D > 2048 into column chunks).
Here the same padding helpers feed the plain versions, and the result,
sliced back to D, is held against the JAX package's Pallas kernels in
interpret mode at D = 20 and 100, at the tolerances of the existing parity
tests.  Then ``class_presence``'s ``valid=None`` route and
``build_candidate_mask`` against JAX.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.models.depth_unet import (
    build_candidate_mask as jax_build_candidate_mask,
)
from rangeclip_tpu.ops.pallas.class_presence import fused_class_presence
from rangeclip_tpu.ops.pallas.masked_pooling import (
    fused_masked_pooling as jax_masked_pooling,
)
from rangeclip_tpu.ops.pallas.pixel_text_ce import (
    fused_pixel_text_ce as jax_ce,
)
from rangeclip_tpu.ops.pallas.pixel_text_topk import (
    fused_pixel_text_topk as jax_topk,
)
from rangeclip_tpu.ops.pallas.tv_loss import fused_tv_loss as jax_tv_loss
from rangeclip_tpu.utils.math import l2_normalize as jax_l2
from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels import masked_pooling as pool_k
from rangeclip_tpu_torch.ops.kernels import pixel_text_ce as ce_k
from rangeclip_tpu_torch.ops.kernels import pixel_text_topk as topk_k
from rangeclip_tpu_torch.ops.kernels import tv_loss as tv_k
from rangeclip_tpu_torch.ops.kernels.class_presence import (
    class_presence,
    class_presence_plain,
)

t = torch.from_numpy
DIMS = [20, 100]


def _d8(d):
    return -(-d // 8) * 8


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("dtype,packed", [("f32", False), ("bf16", True)])
def test_pixel_text_ce_padding_matches_pallas(D, dtype, packed):
    """_lib.pad_dim8 on each operand, then the plain forward and backward (the operands
    the kernels get on the card), against ``fused_pixel_text_ce`` in
    interpret mode on the unpadded operands: value, d samples (sliced back
    to D by the pad's gradient) and d temperature at the tolerances of
    test_pixel_text_ce_plain_matches_pallas (f32: value rtol 1e-5,
    gradients rtol 1e-4, atol 1e-6 of the largest entry; bf16: value and
    d temperature rtol 1e-3, d samples within 2 bf16 ulps of the row's
    largest entry)."""
    rng = np.random.default_rng(D)
    N, C, S, n_members = 300, 60, 4, 20
    samples = rng.standard_normal((N, D)).astype(np.float32)
    members = np.sort(rng.choice(C, n_members, replace=False))
    mask = np.zeros(C, bool)
    mask[members] = True
    labels = members[rng.integers(0, n_members, (S, N))].astype(np.int32)
    valid = rng.integers(0, 3, (S, N)).astype(np.float32)
    text = np.array(jax_l2(jnp.asarray(
        rng.standard_normal((C, D)).astype(np.float32)), axis=-1))
    ids = None
    if packed:
        ids = np.full(32, C, np.int32)
        ids[:n_members] = members
        table, jmask = text[np.minimum(ids, C - 1)], ids < C
    else:
        table, jmask = text, mask
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    temp = np.float32(0.07)

    def jax_fn(s, tau):
        return jax_ce(s, tau, jnp.asarray(labels), jnp.asarray(valid),
                      jnp.asarray(table), jnp.asarray(jmask), 512, True,
                      None if ids is None else jnp.asarray(ids))

    want, (gs, gt) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(samples).astype(jdt), temp)

    xs = t(samples).to(tdt).requires_grad_()
    ts = torch.tensor(temp).requires_grad_()
    ptable = t(table).to(tdt) if packed else None
    flat, ttab, ptab = (_lib.pad_dim8(xs), _lib.pad_dim8(t(text).to(tdt)),
                        _lib.pad_dim8(ptable))
    assert flat.shape == (N, _d8(D)) and ttab.shape == (C, _d8(D))
    packed_args = None
    if packed:
        assert ptab.shape == (32, _d8(D))
        packed_args = (ptab, t(ids < C), t(ids), torch.tensor(True))
    got = ce_k.pixel_text_ce_reference(flat, ts, t(labels), t(valid), ttab,
                                       t(mask), packed_args)
    got.backward()
    got = got.detach()
    assert xs.grad.shape == (N, D) and xs.grad.dtype == tdt
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
        scale = np.abs(gs).max(axis=1, keepdims=True)
        assert (np.abs(dx - gs) <= 2 * scale * 2.0 ** -8).all()


@pytest.mark.parametrize("D", DIMS)
def test_pixel_text_topk_padding_matches_pallas(D):
    """_lib.pad_dim8 on the field and the table, then the plain version, against
    ``fused_pixel_text_topk`` in interpret mode (fp32): ids exact, values
    within 1e-5, and the same ids and values as the unpadded plain version
    (the pad adds only exact zeros)."""
    rng = np.random.default_rng(30 + D)
    N, C, k = 256, 40, 5
    field = rng.standard_normal((N, D)).astype(np.float32)
    text = np.array(jax_l2(jnp.asarray(
        rng.standard_normal((C, D)).astype(np.float32)), axis=-1))
    mask = rng.random(C) > 0.3
    idx, val = jax_topk(jnp.asarray(field), jnp.asarray(text),
                        jnp.asarray(mask), top_k=k, interpret=True)
    ids = torch.where(t(mask), torch.arange(C, dtype=torch.int32), -1)
    f, tab = _lib.pad_dim8(t(field)), _lib.pad_dim8(t(text))
    assert f.shape == (N, _d8(D)) and tab.shape == (C, _d8(D))
    got_idx, got_val = topk_k.pixel_text_topk_plain(f, tab, ids, k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_val.numpy(), np.asarray(val), rtol=1e-5,
                               atol=1e-5)
    want_idx, want_val = topk_k.pixel_text_topk_plain(t(field), t(text), ids,
                                                      k)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(got_val, want_val)


def _pool_case(rng, P, D):
    emb = rng.standard_normal((P, D)).astype(np.float32)
    seg = rng.integers(-1, 10, P).astype(np.int32)
    objs = np.array([0, 2, 4, 4, 6, 8, 12, 99, 9], np.int32)
    return emb, seg, objs


def _pooled_by_chunks(emb, seg, objs):
    """column_chunks, the plain version on each chunk, the sums put side by
    side and sliced back to D, the counts of the first chunk: the
    wrapper's composition on the card."""
    chunks = pool_k.column_chunks(emb)
    parts = [pool_k.masked_pooling_plain(c, seg, objs) for c in chunks]
    sums = torch.cat([s for s, _ in parts], dim=1)[:, :emb.shape[1]]
    for _, counts in parts[1:]:
        assert torch.equal(counts, parts[0][1])
    return chunks, sums, parts[0][1]


@pytest.mark.parametrize("D", DIMS)
def test_masked_pooling_padding_matches_pallas(D):
    """column_chunks pads D to D8 in one chunk; sums within rtol 1e-5 of
    ``fused_masked_pooling`` in interpret mode (f32, another summation
    order), counts exact."""
    emb, seg, objs = _pool_case(np.random.default_rng(40 + D), 500, D)
    want_sums, want_counts = jax_masked_pooling(
        jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(objs), tile_p=128,
        interpret=True)
    chunks, sums, counts = _pooled_by_chunks(t(emb), t(seg), t(objs))
    assert [c.shape for c in chunks] == [(500, _d8(D))]
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_masked_pooling_column_chunks_beyond_the_kernel_width():
    """D = 2056 (past MAX_DIM = 2048) and D = 4100: contiguous chunks of at
    most 2048 columns, multiples of 8; their sums side by side equal the
    plain version over the whole rows (each column summed alone, in the
    same order), the counts of every chunk the same."""
    rng = np.random.default_rng(50)
    for D, widths in ((2056, [2048, 8]), (4100, [2048, 2048, 8])):
        emb, seg, objs = _pool_case(rng, 64, D)
        chunks, sums, counts = _pooled_by_chunks(t(emb), t(seg), t(objs))
        assert [c.shape[1] for c in chunks] == widths
        assert all(c.is_contiguous() for c in chunks)
        want_sums, want_counts = pool_k.masked_pooling_plain(
            t(emb), t(seg), t(objs))
        torch.testing.assert_close(sums, want_sums, rtol=1e-6, atol=1e-6)
        assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_tv_loss_padding_matches_pallas(D, dtype):
    """_lib.pad_dim8, then the plain value and VJP with the means over the
    TRUE D (``dim``), the gradient sliced back to D (what the wrapper and
    the operators do on the card), against ``fused_tv_loss`` in interpret mode:
    value within rtol 1e-5, the gradient within one ulp of x's dtype at the
    magnitude 2 (scale_h + scale_v), as test_fused_tv_loss_matches_jax
    holds it; quantised values give exact ties."""
    shape = (2, 6, 5, D)
    rng = np.random.default_rng(60 + D)
    x = (rng.integers(-3, 4, shape) / 4).astype(np.float32)
    x[..., ::3] += rng.standard_normal(x[..., ::3].shape).astype(np.float32)
    bf16 = dtype == "bfloat16"
    x_jax = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    x_port = t(x).to(torch.bfloat16) if bf16 else t(x)
    g = 1.7
    want = float(jax_tv_loss(x_jax, 8, True))
    want_grad = np.asarray(jax.grad(lambda v: g * jax_tv_loss(
        v, 8, True).astype(jnp.float32))(x_jax), np.float32)
    xp = _lib.pad_dim8(x_port)
    assert xp.shape == shape[:3] + (_d8(D),)
    value = tv_k.tv_loss_value(xp, dim=D)
    grad = tv_k.tv_loss_grad(xp, torch.tensor(g), dim=D)[..., :D]
    np.testing.assert_allclose(float(value), want, rtol=1e-5)
    B, H, W, _ = shape
    scale = g / (B * H * (W - 1) * D) + g / (B * (H - 1) * W * D)
    ulp = 2.0 ** (np.floor(np.log2(2 * scale)) - (7 if bf16 else 23))
    np.testing.assert_allclose(grad.float().numpy(), want_grad, rtol=0,
                               atol=ulp)
    assert torch.equal(grad, tv_k.tv_loss_grad(x_port, torch.tensor(g)))


def test_class_presence_without_valid_bit_equal_to_pallas():
    """``valid=None`` (every label valid) against ``fused_class_presence``
    with an all-ones vector in interpret mode, labels out of range too;
    the wrapper and the plain version alike."""
    rng = np.random.default_rng(70)
    N, C = 3000, 300
    labels = rng.integers(-20, C + 20, N).astype(np.int32)
    labels[labels == 17] = 18  # class 17 absent
    want = np.asarray(fused_class_presence(
        jnp.asarray(labels), jnp.ones(N, jnp.float32), C, tile_n=512,
        interpret=True))
    for fn in (class_presence, class_presence_plain):
        got = fn(t(labels), None, C)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert not want[17] and want.sum() > 200


def test_build_candidate_mask_matches_jax():
    """The port's candidate mask (presence through ``valid=None``) equals
    JAX's for the same Gumbel draw: JAX draws it from the key inside, the
    port takes it as an argument."""
    rng = np.random.default_rng(80)
    C, negatives = 50, 6
    seg = rng.integers(0, 12, (2, 8, 8)).astype(np.int32)
    seg[seg == 5] = 7  # class 5 absent
    key = jax.random.key(3)
    want = np.asarray(jax_build_candidate_mask(key, jnp.asarray(seg), C,
                                               negatives))
    gumbel = t(np.array(jax.random.gumbel(key, (C,)), np.float32))
    got = build_candidate_mask(t(seg), C, negatives, gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == len(np.unique(seg)) + negatives
