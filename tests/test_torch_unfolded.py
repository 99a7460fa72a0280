"""The port's unfolded predict path against the JAX package, on the CPU.

Kernels' plain versions against the JAX Pallas kernels in interpret mode
(``pixel_text_topk``, ``l2_normalize``), and ``DepthUNet.predict``,
``native_field`` and ``forward_native`` against the JAX methods with the XLA
formulation.  JAX's ``predict(scoring="pallas")`` cannot run on the CPU (it
passes no ``interpret`` flag), so the port's predict, which scores with the
plain formulation on the CPU, is held against ``scoring="xla"``, and the
plain ``pixel_text_topk`` against ``fused_pixel_text_topk(interpret=True)``
directly.  Inputs are made with numpy from a seed.

Tolerances: quantised-exact inputs (rows of +-1 in 4 or 16 places: norms
are powers of two and every sum is exact) give bit-equal ids and values;
on random inputs >= 99.9% of ids agree and every mismatch is a near-tie
(f32 score gap <= 1e-5); fields and gradients atol = rtol = 1e-5 at fp32;
bf16 top-1 labels >= 95%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.ops.pallas.l2_normalize import (
    field_kernel_applicable as jax_field_kernel_applicable,
    fused_l2_normalize,
    fused_l2_normalize_field,
)
from rangeclip_tpu.ops.pallas.pixel_text_topk import fused_pixel_text_topk
from rangeclip_tpu.utils.math import l2_normalize as jax_l2_normalize
from rangeclip_tpu_torch.ops.kernels import (
    class_presence,
    conv_score_topk,
    l2_normalize as l2_kernels,
    pixel_text_topk as ptt,
    score_topk,
)
from rangeclip_tpu_torch.ops.kernels.l2_normalize import (
    field_kernel_applicable,
    l2_normalize_backward_plain,
    l2_normalize_plain,
    l2_normalize_rows,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
    normalize_rows_rsqrt,
    pixel_text_topk,
)
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.utils.math import l2_normalize
from rangeclip_tpu_torch.utils.profiling import busy_us
from test_torch_model import DIM, FILTERS, TOL, jax_and_port

K = 5


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _sparse_signs(rng, rows, dim, nonzero, scale=None):
    """Rows of +-1 in ``nonzero`` places (optionally times a power of two
    per row): norms are powers of two, so normalised values are exact."""
    x = np.zeros((rows, dim))
    for r in range(rows):
        at = rng.choice(dim, nonzero, replace=False)
        x[r, at] = rng.choice([-1.0, 1.0], nonzero)
    if scale is not None:
        x *= 2.0 ** rng.integers(-3, 4, (rows, 1))
    return x


def _quantised_case(form: str):
    """(field [N, D], normalised table [C, D], mask [C], ids [C] or None)."""
    rng = np.random.default_rng(31)
    N, D, C = 300, 32, 64
    field = _sparse_signs(rng, N, D, 16, scale=True)
    table = _sparse_signs(rng, C, D, 4) / 2.0  # norm 2 -> +-0.5 exactly
    mask = rng.random(C) > 0.3
    ids = None
    if form == "candidate_ids":  # gathered table: ascending ids, -1 padded
        ids = np.full(C, -1, np.int32)
        ids[:40] = np.sort(rng.choice(1000, 40, replace=False))
        mask = ids >= 0
    elif form == "exhausted":  # 2 candidates < top_k
        mask = np.zeros(C, bool)
        mask[[3, 9]] = True
    return field, table, mask, ids


def _run_both(field, table, mask, ids, dtype):
    f_j, f_t = _both(field, dtype)
    t_j, t_t = _both(table, dtype)
    kw_j = {} if ids is None else {"candidate_ids": jnp.asarray(ids)}
    kw_t = {} if ids is None else {"candidate_ids": torch.from_numpy(ids)}
    want = fused_pixel_text_topk(f_j, t_j, jnp.asarray(mask), top_k=K,
                                 tile_n=32, interpret=True, **kw_j)
    got = pixel_text_topk(f_t, t_t, torch.from_numpy(mask), top_k=K, **kw_t)
    return got, tuple(np.asarray(w) for w in want), f_t, t_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["mask", "candidate_ids", "exhausted"])
def test_pixel_text_topk_plain_bit_equal_on_quantised_inputs(form, dtype):
    field, table, mask, ids = _quantised_case(form)
    (idx, val), (want_idx, want_val), _, _ = _run_both(field, table, mask,
                                                       ids, dtype)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(val.numpy(), want_val)
    if form == "exhausted":
        assert set(np.unique(want_idx[:, :2])) <= {3, 9}
        assert (want_idx[:, 2:] == -1).all()
        assert (val.numpy()[:, 2:] == -1e30).all()
    else:  # the quantised scores tie often: the smallest id must win
        assert len(np.unique(want_val[:, 0])) < len(want_val)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_text_topk_plain_random_inputs_near_ties(dtype):
    rng = np.random.default_rng(32)
    N, D, C = 2000, 32, 100
    field = rng.standard_normal((N, D)) * 3
    table = np.asarray(jax_l2_normalize(jnp.asarray(
        rng.standard_normal((C, D)), jnp.float32)))
    mask = rng.random(C) > 0.2
    (idx, val), (want_idx, want_val), f_t, t_t = _run_both(
        field, table, mask, None, dtype)
    agree = idx.numpy() == want_idx
    assert agree.mean() >= 0.999, agree.mean()
    scores = (normalize_rows_rsqrt(f_t).float() @ t_t.float().T).numpy()
    got = np.take_along_axis(scores, idx.numpy(), 1)
    want = np.take_along_axis(scores, want_idx, 1)
    np.testing.assert_allclose(got[~agree], want[~agree], atol=1e-5)
    np.testing.assert_allclose(val.numpy(), want_val, atol=1e-5)


def test_pixel_text_topk_plain_bf16_decoder_field_vs_jax():
    """The plain version sums x^2 in f64 where the TPU kernel sums in f32;
    on a bf16 field the two can round a normalised pixel differently.
    Measured here on a real bf16 decoder field (D = 512, 384 classes)
    against the JAX kernel in interpret mode: >= 99.9% of ids agree, and
    every mismatch is a near-tie (<= 1e-5) or lies on a row whose bf16
    rounding differs between the two sums (a minority, < 1% of rows);
    values agree within 1e-5 on every other row."""
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=512, dtype=torch.bfloat16),
                     generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(37)
    x = rng.standard_normal((4, 64, 64, 1)).astype(np.float32)
    with torch.no_grad():
        field = port.native_field(torch.from_numpy(x), normalize=False)
    f_t = field.reshape(-1, 512)
    assert f_t.dtype == torch.bfloat16 and f_t.shape[0] == 4096
    table = np.asarray(jax_l2_normalize(jnp.asarray(
        rng.standard_normal((384, 512)), jnp.float32)))
    mask = np.ones(384, bool)
    (idx, val), (want_idx, want_val), _, t_t = _run_both(
        f_t.float().numpy(), table, mask, None, "bfloat16")

    # the TPU kernel's rounding of each pixel (pixel_text_topk.py:85-88)
    xf = jnp.asarray(f_t.float().numpy())
    jax_rows = jax.jit(lambda x: (x * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(x * x, axis=1, keepdims=True), 1e-24))).astype(
            jnp.bfloat16).astype(jnp.float32))(xf)
    port_rows = normalize_rows_rsqrt(f_t)
    differ = (np.asarray(jax_rows) != port_rows.float().numpy()).any(-1)
    assert differ.mean() < 0.01, differ.sum()

    agree = idx.numpy() == want_idx
    assert agree.mean() >= 0.999, agree.mean()
    scores = (port_rows.float() @ t_t.float().T).numpy()
    gap = np.abs(np.take_along_axis(scores, idx.numpy(), 1)
                 - np.take_along_axis(scores, want_idx, 1))
    assert ((gap <= 1e-5) | differ[:, None]).all()
    np.testing.assert_allclose(val.numpy()[~differ], want_val[~differ],
                               atol=1e-5)


def test_busy_us_is_the_union_of_intervals():
    """The profile's busy time counts overlapping device events once."""
    assert busy_us([]) == 0.0
    assert busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]) == 4.0


def test_pixel_text_topk_contract():
    f = torch.randn(10, 32)
    t = l2_normalize(torch.randn(20, 32))
    with pytest.raises(ValueError, match="top_k"):
        pixel_text_topk(f, t, top_k=9)
    with pytest.raises(ValueError, match="top_k"):  # more picks than classes
        pixel_text_topk(f, t[:3], top_k=4)
    with pytest.raises(ValueError, match="table"):
        pixel_text_topk(f, t[:, :16])
    with pytest.raises(ValueError, match="int32"):
        pixel_text_topk(f, t, candidate_ids=torch.arange(20))
    with pytest.raises(ValueError, match="contiguous"):
        pixel_text_topk(torch.randn(32, 10).T, t)
    with pytest.raises(ValueError, match="f32 or bf16"):
        pixel_text_topk(f.double(), t)
    idx, val = pixel_text_topk(f.reshape(2, 5, 32), t, want_values=False)
    assert idx.shape == (10, 5) and val is None


def _op_cases():
    g = torch.Generator().manual_seed(0)
    scores = torch.randn(16, 128, generator=g)
    ids = torch.arange(128, dtype=torch.int32)
    feats = torch.randn(2, 4, 4, 8, generator=g).bfloat16()
    rows = torch.randn(128, 72, generator=g).bfloat16()
    x = torch.randn(16, 32, generator=g)
    return {
        "score_topk": (score_topk.score_topk_op, (scores, ids, 3, False,
                                                  True)),
        "conv_score_topk": (conv_score_topk.conv_score_topk_op,
                            (feats, rows, ids, 2, False)),
        "class_presence": (class_presence.class_presence_op,
                           (torch.randint(0, 9, (50,), generator=g,
                                          dtype=torch.int32),
                            torch.ones(50), 9)),
        "pixel_text_topk": (ptt.pixel_text_topk_op,
                            (x, l2_normalize(torch.randn(20, 32,
                                                         generator=g)),
                             torch.arange(20, dtype=torch.int32), 4, True)),
        "l2_normalize": (l2_kernels.l2_normalize_op,
                         (x.clone().requires_grad_(),)),
        "l2_normalize_backward": (l2_kernels.l2_normalize_backward_op,
                                  (x, torch.randn(16, 32, generator=g))),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_custom_ops_registered(name):
    """Every kernel is ``rangeclip::<name>`` with a fake implementation
    (what ``torch.export`` traces through); ``opcheck`` runs its CPU
    implementation, the plain version, against the fake and the schema."""
    op, args = _op_cases()[name]
    assert op is getattr(torch.ops.rangeclip, name).default
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("variant", ["flat", "field"])
def test_l2_normalize_plain_matches_pallas_values_and_grads(variant):
    """Values and gradients against ``fused_l2_normalize(_field)`` in
    interpret mode (fp32, atol = rtol = 1e-5), and the operator's written
    VJP against autograd of the plain version."""
    rng = np.random.default_rng(33)
    shape = (64, 128) if variant == "flat" else (8, 4, 16, 128)
    fn = fused_l2_normalize if variant == "flat" else fused_l2_normalize_field
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, 128)[3] = 0.0  # a zero row: y = 0, dx = g / eps
    g = rng.standard_normal(shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x: fn(x, True), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    y = l2_normalize_rows(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    assert (y.detach().reshape(-1, 128)[3] == 0).all()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(
        l2_normalize_backward_plain(torch.from_numpy(x),
                                    torch.from_numpy(g)).numpy(),
        xt.grad.numpy(), rtol=1e-6, atol=1e-6)
    # the operator differentiates through its registered backward
    xo = torch.from_numpy(x).reshape(-1, 128).requires_grad_()
    l2_kernels.l2_normalize_op(xo).backward(
        torch.from_numpy(g).reshape(-1, 128))
    np.testing.assert_allclose(xo.grad.reshape(shape).numpy(),
                               xt.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_l2_normalize_bf16_within_one_ulp():
    """bf16: statistics in f32, one rounding of the result, as the kernel
    does: within one bf16 ulp of JAX's interpret-mode kernel."""
    rng = np.random.default_rng(34)
    x_j, x_t = _both(rng.standard_normal((64, 128)), "bfloat16")
    want = np.asarray(fused_l2_normalize(x_j, True).astype(jnp.float32))
    got = l2_normalize_plain(x_t).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert l2_normalize_plain(x_t).dtype == torch.bfloat16


def test_l2_normalize_gate_matches_jax():
    shapes = [(8, 4, 16, 128), (3, 4, 16, 128), (8, 4, 12, 128),
              (8, 4, 16, 96), (256, 4, 16, 128), (128, 128, 128, 512),
              (8, 128, 128, 512), (24, 2, 128, 128), (64, 256)]
    for shape in shapes:
        assert field_kernel_applicable(shape) == \
            jax_field_kernel_applicable(shape), shape


def _inputs(C=40):
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    text = rng.standard_normal((C, DIM)).astype(np.float32)
    mask = rng.random(C) > 0.3
    cand = np.full(32, -1, np.int32)
    on = np.flatnonzero(mask)
    cand[:len(on)] = on
    return x, text, mask, cand


def _check_labels(port, x, text, got, want):
    """>= 99.9% agreement; mismatches are near-ties of the fp32 scores."""
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if agree.all():
        return
    field = port(torch.from_numpy(x))[0].detach()
    logits = torch.einsum("bhwd,cd->bhwc", field,
                          l2_normalize(torch.from_numpy(text))).numpy()
    g = np.take_along_axis(logits, np.maximum(got, 0), -1)
    w = np.take_along_axis(logits, np.maximum(want, 0), -1)
    np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


@pytest.mark.parametrize("return_embeddings", [True, False, "native"])
@pytest.mark.parametrize("score_native", [True, False])
@pytest.mark.parametrize("form", ["mask", "candidate_indices"])
def test_predict_fp32_matches_jax(form, score_native, return_embeddings):
    model, v, port = jax_and_port()
    x, text, mask, cand = _inputs()
    kw = dict(score_native=score_native, return_embeddings=return_embeddings)
    jax_cand = jnp.asarray(cand) if form == "candidate_indices" else None
    want = jax.jit(lambda v, x, t, m, c: model.apply(
        v, x, t, m, K, method=JaxDepthUNet.predict, scoring="xla",
        candidate_indices=c, **kw))(v, jnp.asarray(x), jnp.asarray(text),
                                    jnp.asarray(mask), jax_cand)
    got = port.predict(
        torch.from_numpy(x), torch.from_numpy(text),
        None if form == "candidate_indices" else torch.from_numpy(mask), K,
        candidate_indices=(torch.from_numpy(cand)
                           if form == "candidate_indices" else None), **kw)
    assert got[0].dtype == torch.int32 and got[0].shape == (2, 32, 32, K)
    _check_labels(port, x, text, got[0].numpy(), np.asarray(want[0]))
    assert tuple(got[1].shape) == np.asarray(want[1]).shape
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_predict_forms_exhausted_set_and_contract():
    """The gathered and masked forms give identical labels; an exhausted
    candidate set gives -1; 'pallas' scoring refuses CPU tensors."""
    _, _, port = jax_and_port()
    x, text, mask, cand = _inputs()
    depth, table = torch.from_numpy(x), torch.from_numpy(text)
    a = port.predict(depth, table, torch.from_numpy(mask), K)[0]
    b = port.predict(depth, table, None, K,
                     candidate_indices=torch.from_numpy(cand))[0]
    assert torch.equal(a, b)
    two = torch.zeros(len(text), dtype=torch.bool)
    two[[3, 9]] = True
    got = port.predict(depth, table, two, K, return_embeddings=False)[0]
    assert set(got[..., :2].unique().tolist()) <= {3, 9}
    assert (got[..., 2:] == -1).all()
    with pytest.raises(ValueError, match="CUDA"):
        port.predict(depth, table, two, K, scoring="pallas")
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            port.predict(depth, table, two, K)
    finally:
        port.eval()


def test_native_field_and_forward_native_match_jax():
    model, v, port = jax_and_port()
    x = np.random.default_rng(36).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    for normalize in (True, False):
        want = jax.jit(lambda v, x: model.apply(
            v, x, normalize=normalize,
            method=JaxDepthUNet.native_field))(v, jnp.asarray(x))
        got = port.native_field(torch.from_numpy(x), normalize=normalize)
        assert got.shape == (2, 16, 16, DIM)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    want, t_text, t_image = jax.jit(lambda v, x: model.apply(
        v, x, method=JaxDepthUNet.forward_native))(v, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got, got_text, got_image = port.forward_native(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_text.item(), float(t_text), rtol=1e-6)
    np.testing.assert_allclose(got_image.item(), float(t_image), rtol=1e-6)
    embed = port.embed(xt)
    np.testing.assert_allclose(
        embed.detach().numpy(),
        np.asarray(jax.jit(lambda v, x: model.apply(
            v, x, method=JaxDepthUNet.embed))(v, jnp.asarray(x))), **TOL)
    # the gradient flows through the normalisation to the weights
    got.sum().backward()
    grad = port.decoder.output_conv.conv.weight.grad
    assert grad is not None and torch.isfinite(grad).all()
    port.zero_grad(set_to_none=True)


def test_predict_bf16_top1_agreement():
    """bf16 top-1 labels agree with JAX bf16 (XLA scoring) on >= 95% of
    pixels: both score normalised bf16 fields in f32, but the frameworks
    round the network's activations at different places."""
    model, v, port = jax_and_port()
    x, text, mask, _ = _inputs()
    bf16_model = model.clone(config=dataclasses.replace(model.config,
                                                        dtype=jnp.bfloat16))
    port_bf16 = type(port)(dataclasses.replace(port.config,
                                               dtype=torch.bfloat16))
    port_bf16.load_state_dict(port.state_dict())
    port_bf16.eval()
    want = jax.jit(lambda v, x, t, m: bf16_model.apply(
        v, x, t, m, K, method=JaxDepthUNet.predict, scoring="xla"))(
            v, jnp.asarray(x), jnp.asarray(text), jnp.asarray(mask))
    got, field, _ = port_bf16.predict(torch.from_numpy(x),
                                      torch.from_numpy(text),
                                      torch.from_numpy(mask), K)
    agree = (got.numpy()[..., 0] == np.asarray(want[0])[..., 0]).mean()
    assert agree >= 0.95, agree
    assert field.dtype == torch.bfloat16
