"""One train-step window of the port against JAX's ``make_train_step``, on
the CPU: the same weights (carried by the JAX package's reference-checkpoint
converter), the same batch and the same draws (rebuilt from JAX's key
derivation per microbatch: ``fold_in(rng, i)``, then the loss's splits).
Held against JAX's default path and its kernel path under
``RANGECLIP_PLATFORM=interpret``: the info dict, the updated parameters,
the BatchNorm running statistics (the flax-style update of ``ops/blocks``),
Adam's moments and ``grad_norm``; plus a bf16 check of loss and grad_norm,
and the BatchNorm repair against ``flax.linen.BatchNorm`` directly.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.training.optim import make_optimizer as jax_optimizer
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from rangeclip_tpu_torch.ops.blocks import BatchNorm2d
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step

FILTERS = (8, 16, 16, 16, 32)
A, B, C = 2, 2, 24
LR, WD = 1e-3, 1e-4
t = torch.from_numpy


def _draws(key, H):
    """Per microbatch, the draws of compute_hybrid_loss(fold_in(key, i))."""
    out = []
    for i in range(A):
        key_pix, key_contrast = jax.random.split(jax.random.fold_in(key, i))
        pixels = jax.random.randint(key_pix, (B, n_draws(H, H)), 0, H * H)
        g = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                  for k in jax.random.split(key_contrast))
        out.append(Draws(t(np.array(pixels, np.int32)), g))
    return out


def _inputs(dim, H, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 8, (A, B, H, H)).astype(np.int32)
    batch = {
        "depth": rng.standard_normal((A, B, H, H, 1)).astype(np.float32),
        "segmentation": seg,
        "object_label": seg[:, :, 5, 5].copy(),
        "image_embeddings": rng.standard_normal((A, B, dim)).astype(
            np.float32),
        "sample_valid": np.array([[1, 1], [1, 0]], np.float32),
    }
    text = rng.standard_normal((C, dim)).astype(np.float32)
    medium = rng.random((C, C)) < 0.15
    hard = rng.random((C, C)) < 0.15
    return batch, text, medium, hard


@functools.lru_cache(maxsize=None)
def _port_model(dim):
    return DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=dim),
                     generator=torch.Generator().manual_seed(3))


def _run_both(dim, bf16, H=32):
    """(port state, port info, JAX state, JAX info) after one window."""
    batch, text, medium, hard = _inputs(dim, H)
    port = _port_model(dim)
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())
    opt = jax_optimizer(WD)
    model = JaxDepthUNet(JaxConfig(
        encoder_filters=FILTERS, embedding_dim=dim, use_batch_norm=True,
        dtype=jnp.bfloat16 if bf16 else None))
    jstate = JaxTrainState(step=jnp.int32(0), params=params,
                           batch_stats=stats, opt_state=opt.init(params))
    key = jax.random.key(7)
    step = jax_step(model, opt, JaxLossConfig(), accum_steps=A, donate=False)
    jstate, jinfo = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                         key, jnp.float32(LR), jnp.float32(0.3),
                         jnp.float32(0.5), jnp.asarray(text),
                         jnp.asarray(medium), jnp.asarray(hard))

    cfg = DepthUNetConfig(encoder_filters=FILTERS, embedding_dim=dim,
                          dtype=torch.bfloat16 if bf16 else None)
    mine = DepthUNet(cfg)
    mine.load_state_dict(port.state_dict())
    state = create_train_state(cfg, torch.device("cpu"), WD, model=mine)
    state, info = make_train_step(HybridLossConfig(), A)(
        state, {k: t(v) for k, v in batch.items()}, (0, 0), LR, 0.3, 0.5,
        t(text), t(medium), t(hard), draws=_draws(key, H))
    return state, info, jstate, jinfo


@pytest.fixture(params=["default", "interpret"])
def jax_path(request, monkeypatch):
    if request.param == "interpret":
        monkeypatch.setenv("RANGECLIP_PLATFORM", "interpret")
    return request.param


def test_train_step_fp32_matches_jax(jax_path):
    """fp32, D = 32.  Info (losses, temperatures, grad_norm, lr) within
    rtol 1e-4; BN running statistics within rtol 1e-5 (atol 1e-6); Adam's
    first and second moments within rtol 2e-3 (atol 1e-3 of each tensor's
    largest entry: gradients through the UNet summed in another order).
    Parameters: Adam's first step moves each by about lr * sign(g), so an
    entry whose gradient is within rounding noise of 0 may step the other
    way; all entries within 2 lr, and 99.9% within 1e-3 lr."""
    state, info, jstate, jinfo = _run_both(32, bf16=False)
    assert sorted(info) == sorted(jinfo)
    for k, v in jinfo.items():
        np.testing.assert_allclose(float(info[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    sd = state.model.state_dict()
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    grads = {n: p for n, p in state.model.named_parameters()}
    close = total = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(sd[name]) == A
            continue
        if name in grads and not state.optimizer.state.get(grads[name]):
            continue  # an identity block's projection: absent in JAX
        got, w = sd[name].numpy(), w.numpy()
        if "running_" in name:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            continue
        diff = np.abs(got - w)
        assert (diff <= 2 * LR).all(), name
        close += int((diff <= 1e-3 * LR).sum())
        total += diff.size
    assert close >= 0.999 * total, (close, total)

    adam = jstate.opt_state[1]  # (decay, scale_by_adam, scale)
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        want_m = state_dict_from_jax(moment, {})
        for name, p in grads.items():
            if not state.optimizer.state.get(p):
                continue
            got = state.optimizer.state[p][key].numpy()
            w = want_m[name].numpy().reshape(got.shape)
            np.testing.assert_allclose(got, w, rtol=2e-3,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=f"{key} {name}")


def test_train_step_bf16_loss_and_grad_norm():
    """bf16 compute, D = 128, 64x64 maps (at 32x32 the deepest BatchNorms
    normalise two values per channel, and bf16 rounding of near-equal pairs
    swings their gradients on either side): total loss and grad_norm
    against JAX's default path within rtol 2e-2 (bf16 activations through
    the UNet)."""
    _, info, _, jinfo = _run_both(128, bf16=True, H=64)
    for k in ("total_loss", "text_contrastive_loss", "smoothness_loss",
              "grad_norm"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]),
                                   rtol=2e-2, err_msg=k)


def test_batch_norm_train_update_matches_flax():
    """The repair: train-mode running statistics as flax updates them (0.9 *
    old + 0.1 * batch, biased variance), where nn.BatchNorm2d takes the
    unbiased variance; outputs and statistics within rtol 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.normal(0, 0.2, 3).astype(np.float32)
    mean0 = rng.normal(0, 0.2, 3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}},
                      jnp.asarray(x), mutable=["batch_stats"])
    mine = BatchNorm2d(3, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        mine.weight.copy_(t(scale))
        mine.bias.copy_(t(bias))
        mine.running_mean.copy_(t(mean0))
        mine.running_var.copy_(t(var0))
    out = mine.train()(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5)
    np.testing.assert_allclose(mine.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    assert int(mine.num_batches_tracked) == 1
    plain = torch.nn.BatchNorm2d(3, momentum=0.1)
    plain.running_var.copy_(t(var0))
    plain.train()(t(x).permute(0, 3, 1, 2))
    assert not np.allclose(plain.running_var.numpy(),
                           np.asarray(upd["batch_stats"]["var"]), rtol=1e-5)
    mine.eval()
    np.testing.assert_allclose(
        mine(t(x).permute(0, 3, 1, 2)).detach().numpy(),
        torch.nn.functional.batch_norm(
            t(x).permute(0, 3, 1, 2), mine.running_mean, mine.running_var,
            mine.weight, mine.bias, False, 0.0, 1e-5).detach().numpy())
