"""The port's model against the JAX DepthUNet, on the CPU at fp32.

Both sides run the same weights: the port initialises the model from a
seeded generator (norm statistics and affine parameters randomised, so that
their mapping is exercised), and the JAX package's own reference-checkpoint
converter carries them into JAX trees.
Tolerance: atol = rtol = 1e-5 for fields (different summation orders of
the same f32 math).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import (
    convert_reference_checkpoint,
    export_reference_checkpoint,
    load_reference_checkpoint,
    save_reference_checkpoint,
)
from rangeclip_tpu.ops.aspp import ASPP as JaxASPP
from rangeclip_tpu.ops.blocks import DecoderBlock as JaxDecoderBlock
from rangeclip_tpu.ops.resize import (
    resize_bilinear_align_corners as jax_bilinear,
    resize_nearest as jax_nearest,
)
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import (
    load_reference_pth,
    save_reference_pth,
    state_dict_from_jax,
)
from rangeclip_tpu_torch.ops.aspp import ASPP
from rangeclip_tpu_torch.ops.blocks import DecoderBlock
from rangeclip_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    resize_nearest,
)

FILTERS = (8, 16, 16, 16, 32)
DIM = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def randomise_norms(module: torch.nn.Module, seed: int) -> None:
    """Norm scale/bias and BN running statistics drawn at random (a fresh
    init leaves them at 1/0, which would hide a mixed-up mapping)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def to_jax_trees(encoder_sd, decoder_sd, log_temperatures=(None, None)):
    """Port state dicts -> JAX (params, batch_stats) through the JAX
    package's own reference-checkpoint converter."""
    np_sd = lambda sd: {k: v.detach().numpy() for k, v in sd.items()}
    return convert_reference_checkpoint(np_sd(encoder_sd), np_sd(decoder_sd),
                                        *log_temperatures)


@functools.lru_cache(maxsize=None)
def jax_and_port(seed=0):
    """(JAX model, JAX variables as numpy trees, port model in eval mode)
    with the same random weights."""
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=DIM),
                     generator=torch.Generator().manual_seed(seed))
    randomise_norms(port, seed)
    port.eval()
    params, stats = to_jax_trees(
        port.encoder.state_dict(), port.decoder.state_dict(),
        (port.log_temperature_text.detach().numpy(),
         port.log_temperature_image.detach().numpy()))
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=DIM,
                                   use_batch_norm=True))
    return model, {"params": params, "batch_stats": stats}, port


def test_state_dict_from_jax_matches_export_reference_checkpoint():
    _, v, _ = jax_and_port()
    ref = export_reference_checkpoint(v["params"], v["batch_stats"])
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    want = {f"{side}.{k}": a for side in ("encoder", "decoder")
            for k, a in ref[side].items()}
    want["log_temperature_text"] = ref["log_temperature_text"]
    want["log_temperature_image"] = ref["log_temperature_image"]
    assert sorted(sd) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(a), err_msg=k)
    # the reference's own sub-module dicts load strictly
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=DIM))
    port.encoder.load_state_dict(
        {k: torch.from_numpy(np.array(a)) for k, a in ref["encoder"].items()},
        strict=True)
    port.decoder.load_state_dict(
        {k: torch.from_numpy(np.array(a)) for k, a in ref["decoder"].items()},
        strict=True)


def test_reference_pth_roundtrip_with_jax(tmp_path):
    """The port writes .pth files the JAX package reads, and reads the ones
    it writes."""
    _, v, port = jax_and_port()
    path = str(tmp_path / "port.pth")
    save_reference_pth(port, path, train_step=3)
    params, stats, step = load_reference_checkpoint(path)
    assert step == 3
    for want, got in ((v["params"], params), (v["batch_stats"], stats)):
        want, got = flatten_dict(want), flatten_dict(got)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    path2 = str(tmp_path / "jax.pth")
    save_reference_checkpoint(v["params"], v["batch_stats"], path2)
    loaded = load_reference_pth(path2)
    for k, t in port.state_dict().items():
        if "projection" not in k and "num_batches_tracked" not in k:
            assert torch.equal(loaded[k], t), k


def test_depth_unet_fp32_matches_jax():
    model, v, port = jax_and_port()
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    want = jax.jit(lambda v, x: model.apply(
        v, x, method=JaxDepthUNet.decode_features))(v, jnp.asarray(x))
    got = port.decode_features(torch.from_numpy(x))
    assert got.shape == (2, 16, 16, FILTERS[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    field, t_text, t_image = jax.jit(model.apply)(v, jnp.asarray(x[..., 0]))
    got_field, got_text, got_image = port(torch.from_numpy(x[..., 0]))
    assert got_field.shape == (2, 32, 32, DIM)
    np.testing.assert_allclose(got_field.detach().numpy(),
                               np.asarray(field), **TOL)
    np.testing.assert_allclose(float(got_text), float(t_text), rtol=1e-6)
    np.testing.assert_allclose(float(got_image), float(t_image), rtol=1e-6)


@pytest.mark.parametrize("shape,size", [((2, 4, 6, 3), (8, 12)),
                                        ((2, 5, 7, 3), (16, 9)),
                                        ((1, 8, 8, 2), (3, 5))])
def test_resizes_match_jax(shape, size):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(x), size).numpy(),
        np.asarray(jax_nearest(jnp.asarray(x), size)))
    ids = (x * 100).astype(np.int32)  # label ids take the same path
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(ids), size).numpy(),
        np.asarray(jax_nearest(jnp.asarray(ids), size)))
    np.testing.assert_allclose(
        resize_bilinear_align_corners(torch.from_numpy(x), size).numpy(),
        np.asarray(jax_bilinear(jnp.asarray(x), size)), **TOL)


def test_decoder_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    # the upsampled 6x10 map is resized (bilinear) to the 4x4 skip
    skip = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    port = DecoderBlock(16, 8, 8, activation="relu", use_batch_norm=True,
                        generator=torch.Generator().manual_seed(5))
    randomise_norms(port, 5)
    port.eval()
    params, stats = to_jax_trees(
        {}, {f"up_blocks.0.{k}": t for k, t in port.state_dict().items()})
    block = JaxDecoderBlock(8, activation="relu", use_batch_norm=True)
    want = jax.jit(block.apply)(
        {"params": params["depth_decoder"]["up_block0"],
         "batch_stats": stats["depth_decoder"]["up_block0"]},
        jnp.asarray(x), jnp.asarray(skip))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(skip).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), **TOL)


def test_aspp_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 5, 6, 16)).astype(
        np.float32)
    port = ASPP(16, 64, generator=torch.Generator().manual_seed(8))
    randomise_norms(port, 8)
    params, _ = to_jax_trees(
        {f"aspp.{k}": t for k, t in port.state_dict().items()}, {})
    want = jax.jit(JaxASPP(features=64).apply)(
        {"params": params["depth_encoder"]["aspp"]}, jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), **TOL)


def test_random_init_follows_the_reference_distribution():
    """Kaiming-uniform: every conv / linear weight lies in
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and fills it, as the JAX init
    does; one seed gives one model."""
    cfg = DepthUNetConfig(encoder_filters=FILTERS, embedding_dim=DIM)
    a = DepthUNet(cfg, generator=torch.Generator().manual_seed(0))
    b = DepthUNet(cfg, generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if p.dim() < 2 or p.numel() < 500:
            continue
        fan_in = p.shape[1] * p[0, 0].numel()  # torch's fan convention
        bound = 1.0 / np.sqrt(fan_in)
        assert p.abs().max() <= bound
        assert p.abs().max() > 0.9 * bound, name
