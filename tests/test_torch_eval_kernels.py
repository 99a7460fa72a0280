"""The plain versions of the masked_pooling, tv_loss and head_topk kernels,
and the public functions over them, against the JAX package on the CPU:
the Pallas kernels in interpret mode (``fused_masked_pooling``,
``fused_tv_loss``, ``fused_head_score_topk``), ``masked_average_pooling``
on both of its JAX paths and ``predict_topk_fused`` on weights carried
across.  Inputs are made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import rangeclip_tpu.ops.pallas.tv_loss as jax_tv
from rangeclip_tpu.losses.pooling import (
    masked_average_pooling as jax_masked_average_pooling,
)
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.depth_unet import (
    predict_topk_fused as jax_predict_topk_fused,
)
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.ops.pallas.head_topk import (
    fused_head_score_topk as jax_head_topk,
)
from rangeclip_tpu.ops.pallas.masked_pooling import (
    fused_masked_pooling as jax_masked_pooling,
)
from rangeclip_tpu_torch.losses.pooling import masked_average_pooling
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    predict_topk_fused,
)
from rangeclip_tpu_torch.ops.kernels.head_topk import (
    fused_head_score_topk,
    weight_rows,
)
from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
    fused_masked_pooling,
)
from rangeclip_tpu_torch.ops.kernels.tv_loss import fused_tv_loss

t = torch.from_numpy
FILTERS = (8, 16, 16, 16, 32)


def _pool_inputs(seed, P, D):
    """Labels in [-1, 10) (-1: padding), object ids with a duplicate (4),
    absent ids (12, 99) and a -1-free id list."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((P, D)).astype(np.float32)
    seg = rng.integers(-1, 10, P).astype(np.int32)
    objs = np.array([0, 2, 4, 4, 6, 8, 12, 99, 9], np.int32)
    return emb, seg, objs


@pytest.mark.parametrize("P,D", [(300, 16), (1000, 40)])
def test_masked_pooling_plain_matches_jax_kernel(P, D):
    """Sums within rtol 1e-5 (f32, another summation order), counts
    exact; absent ids give zero rows and count 0, the duplicate id the
    full sums twice, -1 labels nothing."""
    emb, seg, objs = _pool_inputs(P, P, D)
    sums, counts = jax_masked_pooling(jnp.asarray(emb), jnp.asarray(seg),
                                      jnp.asarray(objs), tile_p=128,
                                      interpret=True)
    got_sums, got_counts = fused_masked_pooling(t(emb), t(seg), t(objs))
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(counts))
    assert (got_counts.numpy()[6:8] == 0).all()
    assert (got_sums.numpy()[6:8] == 0).all()
    np.testing.assert_array_equal(got_sums[2].numpy(), got_sums[3].numpy())


@pytest.mark.parametrize("use_pallas", ["auto", "always", "never"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_masked_average_pooling_matches_jax(use_pallas, dtype):
    """Every ``use_pallas`` value of the port against both JAX paths (the
    dense XLA product and the kernel in interpret mode); a bf16 field is
    read as it is by the port and cast to f32 by JAX, which is exact."""
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    seg = rng.integers(-1, 6, (2, 8, 8)).astype(np.int32)
    objs = np.array([0, 1, 3, 3, 5, 7], np.int32)
    if dtype == "bfloat16":
        x_jax = jnp.asarray(emb).astype(jnp.bfloat16)
        x_port = t(emb).to(torch.bfloat16)
    else:
        x_jax, x_port = jnp.asarray(emb), t(emb)
    want = np.asarray(jax_masked_average_pooling(
        x_jax, jnp.asarray(seg), jnp.asarray(objs), use_pallas="never"))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jax_masked_average_pooling(
            x_jax, jnp.asarray(seg), jnp.asarray(objs), use_pallas="always"))
    got = masked_average_pooling(x_port, t(seg), t(objs), use_pallas)
    assert got.dtype == torch.float32 and got.shape == (6, 16)
    for ref in (want, want_kernel):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert (got[5] == 0).all()  # id 7 is absent
    with pytest.raises(ValueError):
        masked_average_pooling(x_port, t(seg), t(objs), "sometimes")


def _quantised(shape, seed, dtype):
    """Values on a 1/4 grid, so neighbours tie exactly (sign(0) = 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, shape) / 4).astype(np.float32)
    x[..., ::3] += rng.standard_normal(x[..., ::3].shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), t(x).to(torch.bfloat16)
    return jnp.asarray(x), t(x)


def _ulp(magnitude, dtype):
    return 2.0 ** (np.floor(np.log2(magnitude))
                   - (7 if dtype == "bfloat16" else 23))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape,tile_r,chunks", [
    ((2, 8, 4, 16), 4, False), ((3, 5, 4, 8), 8, False),
    ((2, 9, 16, 8), 4, True)])
def test_fused_tv_loss_matches_jax(monkeypatch, dtype, shape, tile_r,
                                   chunks):
    """Value within rtol 1e-5; the gradient within one ulp of x's dtype at
    the magnitude 2 (scale_h + scale_v): JAX's tile-seam and column-seam
    rows round once more than its in-tile rows and the port.  ``chunks``
    splits each row into 4 column chunks, as the JAX test does."""
    if chunks:
        monkeypatch.setattr(
            jax_tv, "_choose_chunk",
            lambda WD, D: WD // 4 if WD % 4 == 0 and WD // 4 >= 2 * D
            else WD)
    x_jax, x_port = _quantised(shape, sum(shape), dtype)
    assert bool((x_port[:, :, 1:] == x_port[:, :, :-1]).any())  # ties
    g = 1.7
    want = float(jax_tv.fused_tv_loss(x_jax, tile_r, True))
    want_grad = np.asarray(jax.grad(
        lambda x: g * jax_tv.fused_tv_loss(x, tile_r, True).astype(
            jnp.float32))(x_jax), np.float32)
    x = x_port.clone().requires_grad_()
    value = fused_tv_loss(x)
    value.backward(torch.tensor(g))
    np.testing.assert_allclose(float(value.detach()), want, rtol=1e-5)
    B, H, W, D = shape
    scale = g / (B * H * (W - 1) * D) + g / (B * (H - 1) * W * D)
    np.testing.assert_allclose(x.grad.float().numpy(), want_grad, rtol=0,
                               atol=_ulp(2 * scale, dtype))
    # the ties carry no slope: a constant field has a zero gradient
    flat = torch.zeros(shape).to(x_port.dtype).requires_grad_()
    fused_tv_loss(flat).backward()
    assert (flat.grad == 0).all()


def _head_inputs(seed, B, h, C_in, D, C):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, h, h, C_in)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, C_in, D)) / 9).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return feats, kernel, text


@pytest.mark.parametrize("live", [None, 3])
def test_head_topk_plain_matches_jax_kernel(live):
    """fp32 ids equal to the TPU kernel in interpret mode and values within
    1e-5.  With 3 live classes at k = 5 the picks past them are id 0 at
    -1e30 (the knockout's answer, not the -1 sentinel)."""
    B, h, C_in, D, C, k = 2, 6, 8, 16, 20, 5
    feats, kernel, text = _head_inputs(4, B, h, C_in, D, C)
    mask = np.zeros(C, bool)
    if live is None:
        mask[np.random.default_rng(5).choice(C, 12, replace=False)] = True
    else:
        mask[[2, 11, 17]] = True
    idx, val = jax_head_topk(jnp.asarray(feats), jnp.asarray(kernel),
                             jnp.asarray(text), jnp.asarray(mask), top_k=k,
                             interpret=True)
    rows = weight_rows(t(kernel).permute(3, 2, 0, 1))  # OIHW -> rows
    np.testing.assert_array_equal(rows.numpy(), kernel.reshape(9 * C_in, D))
    got_idx, got_val = fused_head_score_topk(t(feats), rows, t(text),
                                             t(mask), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_val.numpy(), np.asarray(val), rtol=1e-5,
                               atol=1e-5)
    if live is not None:
        assert (got_idx.numpy()[:, 3:] == 0).all()
        assert (got_val.numpy()[:, 3:] == -1e30).all()
        assert set(np.unique(got_idx.numpy()[:, :3])) <= {2, 11, 17}


@pytest.mark.parametrize("live", [None, 3])
def test_head_topk_padding_matches_jax_kernel(live):
    """C_in = 12 and D = 20, widths the CUDA kernel does not take: the
    operands zero-padded to 16 and 24 (what the wrapper hands the kernel on
    the card) give the plain version the same ids as the TPU kernel in
    interpret mode on the unpadded operands, values within 1e-5, and the
    same ids and values as the unpadded plain version (the pad adds only
    exact zeros)."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import (
        head_topk_plain,
        pad_head_operands,
    )

    B, h, C_in, D, C, k = 2, 6, 12, 20, 20, 5
    feats, kernel, text = _head_inputs(6, B, h, C_in, D, C)
    mask = np.zeros(C, bool)
    if live is None:
        mask[np.random.default_rng(7).choice(C, 12, replace=False)] = True
    else:
        mask[[2, 11, 17]] = True
    idx, val = jax_head_topk(jnp.asarray(feats), jnp.asarray(kernel),
                             jnp.asarray(text), jnp.asarray(mask), top_k=k,
                             interpret=True)
    rows = weight_rows(t(kernel).permute(3, 2, 0, 1))
    f, r, tab = pad_head_operands(t(feats), rows, t(text))
    assert f.shape[-1] == 16 and r.shape == (9 * 16, 24) and tab.shape == (
        C, 24)
    got_idx, got_val = head_topk_plain(f, r, tab, t(mask).int(), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_val.numpy(), np.asarray(val), rtol=1e-5,
                               atol=1e-5)
    want_idx, want_val = head_topk_plain(t(feats), rows, t(text),
                                         t(mask).int(), k)
    assert torch.equal(got_idx, want_idx)
    torch.testing.assert_close(got_val, want_val, rtol=1e-6, atol=1e-6)


def test_predict_topk_fused_matches_jax():
    """A narrow model (filters 8 16 16 16 32, D = 32) with the port's
    weights carried to JAX: ``predict_topk_fused`` equals JAX's (interpret
    mode) and the port's ``DepthUNet.predict(scoring='xla')`` id for id at
    fp32, which holds the OIHW -> (dy, dx, c_in) row order."""
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=32),
                     generator=torch.Generator().manual_seed(6)).eval()
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=32,
                                   use_batch_norm=True))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    C = 12
    text = rng.standard_normal((C, 32)).astype(np.float32)
    mask = np.zeros(C, bool)
    mask[[0, 1, 3, 4, 6, 8, 10, 11]] = True
    want = np.asarray(jax_predict_topk_fused(
        model, {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(text), jnp.asarray(mask), top_k=5, interpret=True))
    got = predict_topk_fused(port, t(x), t(text), t(mask), top_k=5)
    assert got.shape == (2, 32, 32, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ids, _, _ = port.predict(t(x), t(text), t(mask), 5, scoring="xla")
    np.testing.assert_array_equal(got.numpy(), ids.numpy())
    with pytest.raises(ValueError, match="eval mode"):
        predict_topk_fused(port.train(), t(x), t(text), t(mask))
