"""The port's MiT and ResNet-50 UNets against the JAX package on the CPU:
forward (field within 1e-4), predict and the folded predict (labels equal
up to near-ties), the MiT's native-scoring identity at its x4 upsample and
its native-resolution train step against JAX's with JAX's draws, and the
ResNet-50 state dict against the JAX package's reference export.  Tiny
widths, inputs from numpy seeds."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import (
    convert_reference_checkpoint,
    export_reference_checkpoint,
    save_reference_checkpoint,
)
from rangeclip_tpu.training.optim import make_optimizer as jax_optimizer
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
    predict_folded,
)
from rangeclip_tpu_torch.models.interop import (
    load_reference_pth,
    state_dict_from_jax,
    widths_from_state_dict,
)
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step
from rangeclip_tpu_torch.utils.math import l2_normalize

D, C, K = 32, 20, 4
CONFIGS = {
    # the last four filters are the MiT's stage widths
    "mit": dict(unet_type="mit", encoder_filters=(0, 16, 32, 64, 96),
                embedding_dim=D, use_batch_norm=False),
    "resnet50": dict(unet_type="resnet", n_layer=50,
                     encoder_filters=(8, 8, 16, 16, 32), embedding_dim=D,
                     use_batch_norm=True),
}
t = torch.from_numpy


def _random_leaves(tree, rng, path=()):
    """Random numpy values in the shapes of a JAX variable tree: kernels
    N(0, 1/fan_in), norm scales U(0.5, 1.5) and biases N(0, 0.2) (not the
    1 / 0 of a fresh init, which would hide a mixed-up mapping), BatchNorm
    means N(0, 0.2) and variances U(0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_leaves(v, rng, path + (k,))
            continue
        shape = tuple(v.shape)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k in ("bias", "mean", "upsample_bias"):
            a = rng.normal(0.0, 0.2, shape)
        elif k.startswith("log_temperature"):
            a = np.log(np.full(shape, 0.07 if "text" in k else 0.1))
        else:
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(
                max(1, int(np.prod(shape[:-1]))))
        out[k] = a.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX model, numpy variables, the port model in eval mode) with the
    same random weights, drawn in the shapes of the JAX init (traced, not
    run)."""
    cfg = CONFIGS[kind]
    model = JaxDepthUNet(JaxConfig(**cfg))
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 1)))
    v = _random_leaves(jax.tree.map(lambda a: a, dict(shapes)),
                       np.random.default_rng(1))
    v.setdefault("batch_stats", {})
    port = DepthUNet(DepthUNetConfig(**cfg))
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    return model, v, port.eval()


def _inputs(seed=0, B=2, H=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, 1)).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    seg = rng.integers(0, 6, (B, H, H)).astype(np.int32)
    return x, text, seg


def _check_near_ties(port, x, text, got, want):
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if agree.all():
        return
    with torch.no_grad():
        field = port(t(x))[0]
    logits = torch.einsum("bhwd,cd->bhwc", field,
                          l2_normalize(t(text), dim=-1)).numpy()
    g = np.take_along_axis(logits, np.maximum(got, 0), -1)
    w = np.take_along_axis(logits, np.maximum(want, 0), -1)
    np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_unet_forward_matches_jax(kind):
    """fp32, eval mode: the field and the native field within 1e-4; the
    MiT's native field is at H/4, the ResNet's at H/2."""
    model, v, port = _models(kind)
    x, _, _ = _inputs(2)
    want, want_native = (np.asarray(a) for a in jax.jit(
        lambda v, x: (model.apply(v, x)[0],
                      model.apply(v, x, method=JaxDepthUNet.forward_native)[0])
    )(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(t(x))[0].numpy()
        got_native = port.forward_native(t(x))[0].numpy()
    assert got.shape == (2, 32, 32, D)
    assert got_native.shape[1] == {"mit": 8, "resnet50": 16}[kind]
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got_native, want_native, atol=1e-4)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_predict_matches_jax(kind):
    """DepthUNet.predict and predict_folded under a candidate mask against
    JAX's predict (the XLA scoring): labels equal up to near-ties."""
    model, v, port = _models(kind)
    x, text, seg = _inputs(3)
    mask = build_candidate_mask(t(seg), C, 5,
                                generator=torch.Generator().manual_seed(2))
    want = np.asarray(jax.jit(lambda v, x, t, m: model.apply(
        v, x, t, m, K, method=JaxDepthUNet.predict, scoring="xla",
        return_embeddings=False)[0])(v, jnp.asarray(x), jnp.asarray(text),
                                      jnp.asarray(mask.numpy())))
    got = port.predict(t(x), t(text), mask, K,
                       return_embeddings=False)[0].numpy()
    assert got.shape == (2, 32, 32, K)
    _check_near_ties(port, x, text, got, want)
    folded = predict_folded(port, t(x), t(text), mask, top_k=K).numpy()
    _check_near_ties(port, x, text, folded, want)


def test_mit_predict_native_scoring_identity():
    """The MiT's native field is H/4, so native scoring nearest-upsamples
    the ids x4: exactly the full-resolution prediction
    (test_mit.py:39-61)."""
    _, _, port = _models("mit")
    x, text, seg = _inputs(4)
    mask = build_candidate_mask(t(seg), C, 4,
                                generator=torch.Generator().manual_seed(3))
    full = port.predict(t(x), t(text), mask, 5, score_native=False)[0]
    native = port.predict(t(x), t(text), mask, 5, score_native=True)[0]
    assert native.shape == (2, 32, 32, 5)
    assert torch.equal(native, full)


def _draws(key, A, B, H):
    out = []
    for i in range(A):
        key_pix, key_contrast = jax.random.split(jax.random.fold_in(key, i))
        pixels = jax.random.randint(key_pix, (B, n_draws(H, H)), 0, H * H)
        g = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                  for k in jax.random.split(key_contrast))
        out.append(Draws(t(np.array(pixels, np.int32)), g))
    return out


def test_mit_native_loss_step_matches_jax():
    """One accumulation window of the MiT UNet (native-resolution losses
    under its x4 upsample) against JAX's step with the same weights, batch
    and draws: the info within rtol 1e-4 (the train-step tests' bound),
    every parameter the losses reach moved, all finite
    (test_mit.py:64-104)."""
    model, v, _ = _models("mit")
    A, B, H = 2, 2, 32
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 6, (A, B, H, H)).astype(np.int32)
    batch = {"depth": rng.standard_normal((A, B, H, H, 1)).astype(np.float32),
             "segmentation": seg, "object_label": seg[:, :, 4, 4].copy(),
             "image_embeddings": rng.standard_normal((A, B, D)).astype(
                 np.float32),
             "sample_valid": np.ones((A, B), np.float32)}
    text = rng.standard_normal((C, D)).astype(np.float32)
    medium = rng.random((C, C)) < 0.15
    hard = rng.random((C, C)) < 0.15
    opt = jax_optimizer(1e-4)
    jstate = JaxTrainState(step=jnp.int32(0), params=v["params"],
                           batch_stats={}, opt_state=opt.init(v["params"]))
    key = jax.random.key(7)
    jstate, jinfo = jax_step(model, opt, JaxLossConfig(), accum_steps=A,
                             donate=False)(
        jstate, {k: jnp.asarray(a) for k, a in batch.items()}, key,
        jnp.float32(1e-3), jnp.float32(0.3), jnp.float32(0.5),
        jnp.asarray(text), jnp.asarray(medium), jnp.asarray(hard))

    cfg = DepthUNetConfig(**CONFIGS["mit"])
    mine = DepthUNet(cfg)
    mine.load_state_dict(state_dict_from_jax(v["params"], {}))
    before = {k: p.detach().clone() for k, p in mine.named_parameters()}
    state = create_train_state(cfg, torch.device("cpu"), 1e-4, model=mine)
    state, info = make_train_step(HybridLossConfig(), A)(
        state, {k: t(a) for k, a in batch.items()}, (0, 0), 1e-3, 0.3, 0.5,
        t(text), t(medium), t(hard), draws=_draws(key, A, B, H))
    assert sorted(info) == sorted(jinfo)
    for k, want in jinfo.items():
        np.testing.assert_allclose(float(info[k]), float(want), rtol=1e-4,
                                   err_msg=k)
    for k, p in state.model.named_parameters():
        assert torch.isfinite(p).all(), k
        # the global embedding's head is no loss's input: no gradient
        assert torch.equal(p, before[k]) == (p.grad is None), k


def test_resnet50_state_dict_matches_export_reference_checkpoint(tmp_path):
    """ResNet-50's keys and values against the JAX package's reference
    export (conv3 in every bottleneck, the unused projections at conv2's
    width), the JAX-written .pth loading strictly into the port, the
    port's weights carried back by the JAX package's own converter, and
    the widths read from the checkpoint."""
    model, v, port = _models("resnet50")
    ref = export_reference_checkpoint(v["params"], v["batch_stats"])
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    want = {f"{side}.{k}": a for side in ("encoder", "decoder")
            for k, a in ref[side].items()}
    assert sorted(sd) == sorted(
        list(want) + ["log_temperature_image", "log_temperature_text"])
    assert any(".conv3." in k for k in want)
    for k, a in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(a), err_msg=k)
    path = str(tmp_path / "rn50.pth")
    save_reference_checkpoint(v["params"], v["batch_stats"], path)
    loaded = load_reference_pth(path)
    fresh = DepthUNet(DepthUNetConfig(**CONFIGS["resnet50"]))
    fresh.load_state_dict(loaded, strict=True)
    widths = widths_from_state_dict(loaded)
    assert widths == {"unet_type": "resnet", "n_layer": 50,
                      "encoder_filters": (8, 8, 16, 16, 32),
                      "embedding_dim": D, "use_batch_norm": True}
    params, stats = convert_reference_checkpoint(
        *({k: a.detach().numpy() for k, a in m.state_dict().items()}
          for m in (port.encoder, port.decoder)))
    for tree, back in ((v["params"], params), (v["batch_stats"], stats)):
        for side in ("depth_encoder", "depth_decoder"):
            jax.tree.map(np.testing.assert_array_equal, back[side],
                         tree[side])


def test_widths_from_state_dict_reads_each_architecture():
    """unet_type, n_layer, widths, embedding dim and BatchNorm come back
    from the port's state dicts of each encoder."""
    for kw in (CONFIGS["mit"], dict(n_layer=34, encoder_filters=(8, 8, 8, 8,
                                                                 16),
                                    embedding_dim=D),
               dict(encoder_filters=(8, 16, 16, 16, 32), embedding_dim=D,
                    use_batch_norm=False)):
        cfg = DepthUNetConfig(**kw)
        widths = widths_from_state_dict(DepthUNet(cfg).state_dict())
        assert DepthUNetConfig(**widths) == dataclasses.replace(
            cfg, encoder_filters=tuple(cfg.encoder_filters[
                -4 if cfg.unet_type == "mit" else 0:]))
