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
from rangeclip_tpu_torch.ops.kernels import tv_loss as tv_k
from rangeclip_tpu_torch.ops.kernels.head_topk import (
    fused_head_score_topk,
    head_field,
    live_head_rows,
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


@pytest.mark.parametrize("dtype,shape", [
    ("bfloat16", (2, 33, 70, 72)), (np.float32, (1, 65, 33, 40)),
    ("bfloat16", (1, 65, 33, 72)), (np.float32, (2, 33, 70, 40))])
def test_fused_tv_loss_matches_jax_at_band_edges(dtype, shape):
    """The shapes that cross the CUDA kernels' band edges (H and W not
    multiples of 32, bf16 D % 64 and f32 D % 32 not 0), through the plain
    versions against the TPU kernel in interpret mode: the value within
    rtol 1e-5, the gradient within one ulp of x's dtype at the magnitude 2
    (scale_h + scale_v), as test_fused_tv_loss_matches_jax."""
    x_jax, x_port = _quantised(shape, sum(shape), dtype)
    g = 1.7
    want = float(jax_tv.fused_tv_loss(x_jax, 8, True))
    want_grad = np.asarray(jax.grad(
        lambda x: g * jax_tv.fused_tv_loss(x, 8, True).astype(
            jnp.float32))(x_jax), np.float32)
    x = x_port.clone().requires_grad_()
    value = fused_tv_loss(x)
    value.backward(torch.tensor(g))
    np.testing.assert_allclose(float(value.detach()), want, rtol=1e-5)
    B, H, W, D = shape
    scale = g / (B * H * (W - 1) * D) + g / (B * (H - 1) * W * D)
    np.testing.assert_allclose(x.grad.float().numpy(), want_grad, rtol=0,
                               atol=_ulp(2 * scale, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (32, 128, 128, 512), (8200, 64, 2, 8), (2, 33, 70, 72),
    (3, 65, 33, 40), (1, 2, 2, 8)])
def test_tv_loss_band_blocks(dtype, shape):
    """The wrapper's mirror of the kernels' grid (csrc/band_ring.cuh
    ``band_blocks``) against a direct count: the distinct images, 32-row
    bands, 32-column W-tiles and 8-piece channel chunks that the elements
    fall in, a piece being 16 bytes (8 bf16 or 4 f32 channels); a block is
    one of each, and the forward writes two partials a block.  [8200, 64,
    2, 8] is past the grid the kernels once had (B * ceil(H / 8) <=
    65535), and the one-dimensional grid takes it."""
    B, H, W, D = shape
    per = 8 if dtype == torch.bfloat16 else 4
    # the tile of each element along each axis; a block is one tile of each
    tiles = [np.arange(B), np.arange(H) // 32, np.arange(W) // 32,
             np.arange(D) // per // 8]
    direct = int(np.prod([len(np.unique(t_)) for t_ in tiles]))
    blocks = tv_k.band_blocks(shape, dtype)
    assert blocks == direct
    assert blocks < 2 ** 31
    if shape == (8200, 64, 2, 8):
        assert B * -(-H // 8) > 65535 and blocks == 2 * B


def _head_inputs(seed, B, h, C_in, D, C):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, h, h, C_in)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, C_in, D)) / 9).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return feats, kernel, text


def _head_mask(C, live, seed):
    """12 random live classes (None), none (0), class 9 alone (1), [2, 11,
    17] (3) or every class ("all")."""
    mask = np.zeros(C, bool)
    if live is None:
        mask[np.random.default_rng(seed).choice(C, 12, replace=False)] = True
    elif live == "all":
        mask[:] = True
    else:
        mask[[9] if live == 1 else [2, 11, 17][:live]] = True
    return mask


def _select_live(scores, ids, count, top_k):
    """The tensor-core kernel's selection in plain PyTorch: top-k of f32
    ``scores`` [N, C] against a gathered table (``live_head_rows``), where
    only its first ``count`` columns can win (the knockout, ties to the
    smaller column, which is the smaller id), the columns mapped to
    ``ids``, and picks past the live columns (id 0, -1e30)."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import knockout_topk

    cols = torch.arange(scores.shape[1])
    col, val = knockout_topk(
        torch.where(cols < count, scores, scores.new_tensor(-1e30)), top_k)
    empty = torch.arange(top_k) >= count
    return torch.where(empty, 0, ids[col.long()]).to(torch.int32), val


@pytest.mark.parametrize("live", [None, 3, 0, 1, "all"])
def test_head_topk_plain_matches_jax_kernel(live):
    """fp32 ids equal to the TPU kernel in interpret mode and values within
    1e-5.  With 3, 1 or no live classes at k = 5 the picks past them are id
    0 at -1e30 (the knockout's answer, not the -1 sentinel).  The selection
    the tensor-core kernel makes, over the live rows gathered first
    (``live_head_rows``) with the columns mapped back through their ids,
    gives the same ids and values."""
    B, h, C_in, D, C, k = 2, 6, 8, 16, 20, 5
    feats, kernel, text = _head_inputs(4, B, h, C_in, D, C)
    mask = _head_mask(C, live, 5)
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
    n_live = int(mask.sum())
    if n_live < k:
        assert (got_idx.numpy()[:, n_live:] == 0).all()
        assert (got_val.numpy()[:, n_live:] == -1e30).all()
        assert set(np.unique(got_idx.numpy()[:, :n_live])) <= set(
            np.flatnonzero(mask))
    f = head_field(t(feats), rows)
    emb = f / torch.sqrt(f.square().sum(dim=1, keepdim=True).clamp_min(1e-24))
    table, ids, count = live_head_rows(t(text), t(mask).int())
    sel_idx, sel_val = _select_live(emb @ table.T, ids, count, k)
    np.testing.assert_array_equal(sel_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(sel_val.numpy(), np.asarray(val), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(sel_idx, got_idx)


def _syncing_ops(fn):
    """The ATen operators ``fn`` dispatches that read a tensor's value on
    the host (``.item()``, ``bool()``, shapes that depend on the data),
    recorded below autograd on CPU tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    syncing = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique", "_unique2", "unique_consecutive", "unique_dim",
               "repeat_interleave", "item", "equal", "is_nonzero"}

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name.split("::")[-1]
            if name == "index" and any(  # a boolean mask: its nonzero
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ())):
                name = "nonzero"
            self.names.add(name)
            return func(*args, **(kwargs or {}))

    with Record() as record:
        out = fn()
    return out, record.names & syncing, record.names


@pytest.mark.parametrize("live", [None, 0, 1, "all"])
def test_live_head_rows_gathers_on_the_device(live):
    """The tensor-core route's gather: the live rows first in ascending id
    order, then the masked ones in theirs; each row's id; the live count as
    a one-element tensor; and no operator that reads a value on the host
    (the count stays on the device, as the kernel reads it)."""
    C, D = 20, 16
    table = t(np.random.default_rng(8).standard_normal((C, D)).astype(
        np.float32)).to(torch.bfloat16)
    mask = _head_mask(C, live, 9)
    (gathered, ids, count), synced, seen = _syncing_ops(
        lambda: live_head_rows(table, t(mask).int()))
    assert not synced, synced
    assert {"cumsum", "index_copy_"} <= seen, seen
    # the recorder sees what a host sync dispatches
    for sync in (lambda: bool(table.sum() > 0), lambda: table.nonzero(),
                 lambda: table[table > 0]):
        assert _syncing_ops(sync)[1]
    order = np.concatenate([np.flatnonzero(mask), np.flatnonzero(~mask)])
    assert ids.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), order)
    assert count.shape == (1,) and int(count) == int(mask.sum())
    assert gathered.dtype == torch.bfloat16
    assert torch.equal(gathered, table[torch.from_numpy(order)])


@pytest.mark.parametrize("dtype,c_in,dims,route", [
    (torch.bfloat16, 64, 512, "bf16"), (torch.bfloat16, 8, 8, "bf16"),
    (torch.bfloat16, 61, 505, "bf16"), (torch.bfloat16, 65, 512, "fp32"),
    (torch.bfloat16, 64, 513, "fp32"), (torch.bfloat16, 32, 768, "fp32"),
    (torch.float32, 32, 512, "fp32"), (torch.float32, 8, 8, "fp32")])
def test_head_topk_route_at_the_limits(dtype, c_in, dims, route):
    """bf16 features take the tensor-core kernel while C_in and D, zero-
    padded to multiples of 8, are within 64 and 512; f32 features and wider
    bf16 ones take the CUDA-core kernel."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import kernel_route

    assert kernel_route(dtype, c_in, dims) == f"head_topk[{route}]"


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
