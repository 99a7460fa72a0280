"""The port's folded predict and candidate builders against the JAX ones.

The port runs on the CPU, so its kernels run as their plain versions.  JAX
runs both of its branches: the XLA one (``interpret=False``) and the Pallas
kernels in interpret mode (``interpret=True``).  fp32 labels must agree on
>= 99.9% of entries, and wherever they differ the two classes' scores must
be a near-tie (fp32 gap <= 1e-5), as in the JAX package's own
``test_predict_folded_matches_predict``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.models.depth_unet import (
    build_candidate_indices as jax_build_candidate_indices,
    build_candidate_mask as jax_build_candidate_mask,
    candidate_indices_from_mask as jax_candidate_indices_from_mask,
    folded_is_profitable as jax_folded_is_profitable,
    predict_folded as jax_predict_folded,
)
from rangeclip_tpu_torch.models.depth_unet import (
    build_candidate_indices,
    build_candidate_mask,
    candidate_indices_from_mask,
    folded_is_profitable,
    fused_head_ok,
    predict_folded,
)
from rangeclip_tpu_torch.utils.math import l2_normalize
from test_torch_model import DIM, jax_and_port

K = 5
C = 128


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    text = rng.standard_normal((C, DIM)).astype(np.float32)
    seg = rng.integers(0, 6, (2, 32, 32)).astype(np.int32)
    gumbel = np.asarray(jax.random.gumbel(jax.random.key(4), (C,)))
    cand = build_candidate_indices(torch.from_numpy(seg), C, 40, 128,
                                   gumbel=torch.from_numpy(gumbel))
    return x, text, cand.numpy()


def _check_near_ties(port, x, text, got, want):
    """>= 99.9% agreement; each mismatch is a near-tie of the pixel's fp32
    scores against the normalised table."""
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if agree.all():
        return
    field = port(torch.from_numpy(x))[0]
    logits = torch.einsum("bhwd,cd->bhwc", field,
                          l2_normalize(torch.from_numpy(text), dim=-1))
    logits = logits.detach().numpy()
    g = np.take_along_axis(logits, np.maximum(got, 0), -1)
    w = np.take_along_axis(logits, np.maximum(want, 0), -1)
    np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("form", ["candidate_indices", "full", "odd_c"])
def test_predict_folded_fp32_matches_jax(form, interpret):
    model, v, port = jax_and_port()
    x, text, cand = _inputs()
    kw, port_kw = {}, {}
    if form == "candidate_indices":
        kw = {"candidate_indices": jnp.asarray(cand)}
        port_kw = {"candidate_indices": torch.from_numpy(cand)}
    elif form == "odd_c":  # not a multiple of 128: the kernel path pads
        text = text[:100]
    want = jax.jit(lambda v, x, t, kw: jax_predict_folded(
        model, v, x, t, top_k=K, interpret=interpret, **kw))(
            v, jnp.asarray(x), jnp.asarray(text), kw)
    got = predict_folded(port, torch.from_numpy(x), torch.from_numpy(text),
                         top_k=K, **port_kw)
    assert got.dtype == torch.int32 and got.shape == (2, 32, 32, K)
    _check_near_ties(port, x, text, got.numpy(), np.asarray(want))


def test_predict_folded_bf16_top1_agreement():
    """bf16: top-1 labels agree with JAX bf16 on >= 95% of pixels.  The
    folded scores round to bf16 in both, but the two frameworks round the
    network's activations at different places; measured agreement at this
    size: 99.8% of top-1 labels (98.6% of all top-5 entries)."""
    model, v, port = jax_and_port()
    x, text, _ = _inputs()
    bf16_model = model.clone(config=dataclasses.replace(model.config,
                                                        dtype=jnp.bfloat16))
    port_bf16 = type(port)(dataclasses.replace(port.config,
                                               dtype=torch.bfloat16))
    port_bf16.load_state_dict(port.state_dict())
    port_bf16.eval()
    want = jax.jit(lambda v, x, t: jax_predict_folded(
        bf16_model, v, x, t, top_k=K))(v, jnp.asarray(x), jnp.asarray(text))
    got = predict_folded(port_bf16, torch.from_numpy(x),
                         torch.from_numpy(text), top_k=K)
    agree = (got.numpy()[..., 0] == np.asarray(want)[..., 0]).mean()
    assert agree >= 0.95, agree


def test_predict_folded_values_native_and_candidate_ids():
    """``candidate_ids`` with a static bound, ``want_values`` and
    ``upsample=False`` (the class-sharded caller's form)."""
    model, v, port = jax_and_port()
    x, text, _ = _inputs()
    ids = np.arange(C, dtype=np.int32) + 1000  # global ids of a table slice
    ids[-9:] = -1
    want_idx, want_val = jax.jit(lambda v, x, t, i: jax_predict_folded(
        model, v, x, t, top_k=K, candidate_ids=i, want_values=True,
        upsample=False, max_candidate_id=1200, interpret=True))(
            v, jnp.asarray(x), jnp.asarray(text), jnp.asarray(ids))
    got_idx, got_val = predict_folded(
        port, torch.from_numpy(x), torch.from_numpy(text), top_k=K,
        candidate_ids=torch.from_numpy(ids), want_values=True,
        upsample=False, max_candidate_id=1200)
    assert got_idx.shape == (2, 16, 16, K) and got_val.dtype == torch.float32
    assert (got_idx.numpy() == np.asarray(want_idx)).mean() >= 0.999
    np.testing.assert_allclose(got_val.numpy(), np.asarray(want_val),
                               atol=1e-5, rtol=1e-5)


def test_predict_folded_exhausted_set_and_eval_mode():
    """Fewer candidates than top_k: the -1 sentinel, as in JAX; a model in
    training mode is refused."""
    _, _, port = jax_and_port()
    x, text, _ = _inputs()
    mask = torch.zeros(C, dtype=torch.bool)
    mask[[3, 9]] = True
    got = predict_folded(port, torch.from_numpy(x), torch.from_numpy(text),
                         candidate_mask=mask, top_k=K).numpy()
    assert set(np.unique(got[..., :2])) <= {3, 9}
    assert (got[..., 2:] == -1).all()
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            predict_folded(port, torch.from_numpy(x), torch.from_numpy(text))
    finally:
        port.eval()


def test_candidate_builders_match_jax():
    """Same Gumbel noise and segmentation -> the same mask and indices."""
    rng = np.random.default_rng(12)
    num_classes = 512
    key = jax.random.key(7)
    gumbel = torch.from_numpy(np.asarray(
        jax.random.gumbel(key, (num_classes,))))
    for seg_hi, negatives, capacity in [(40, 300, 384), (6, 40, 128),
                                        (500, 300, 384), (20, 600, 700)]:
        seg = rng.integers(0, seg_hi, (2, 16, 16)).astype(np.int32)
        want_mask = jax_build_candidate_mask(key, jnp.asarray(seg),
                                             num_classes, negatives)
        mask = build_candidate_mask(torch.from_numpy(seg), num_classes,
                                    negatives, gumbel=gumbel)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(
            candidate_indices_from_mask(mask, capacity).numpy(),
            np.asarray(jax_candidate_indices_from_mask(want_mask, capacity)))
        want = jax_build_candidate_indices(key, jnp.asarray(seg),
                                           num_classes, negatives, capacity)
        got = build_candidate_indices(torch.from_numpy(seg), num_classes,
                                      negatives, capacity, gumbel=gumbel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # noise from a generator: one seed, one draw
    a = build_candidate_mask(torch.from_numpy(seg), num_classes, 50,
                             generator=torch.Generator().manual_seed(1))
    b = build_candidate_mask(torch.from_numpy(seg), num_classes, 50,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_dispatch_gates():
    for slots in (100, 384, 768, 769, 2048):
        for dim in (32, 512):
            for fused in (False, True):
                assert folded_is_profitable(slots, dim, fused) == \
                    jax_folded_is_profitable(slots, dim, fused)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert fused_head_ok(128, 512, torch.bfloat16, cuda)
    assert not fused_head_ok(128, 512, torch.float32, cuda)  # dtype
    assert not fused_head_ok(128, 2 ** 16 + 1, torch.bfloat16, cuda)  # ids
    assert not fused_head_ok(8, 512, torch.bfloat16, cuda)  # batch
    assert not fused_head_ok(128, 512, torch.bfloat16, cpu)  # no kernels
