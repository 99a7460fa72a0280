"""The port's block library (``rangeclip_tpu_torch/ops/blocks.py``) against
the JAX blocks (``rangeclip_tpu/ops/blocks.py``): each block initialised by
flax from a seed, its weights converted with
``models/interop.block_state_dict_from_jax`` and loaded strictly, then both
run on the same numpy input: in eval mode against the JAX block in f32; in
train mode (batch statistics) against the JAX block run in float64, since
flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2, whose f32
cancellation leaves its own output 1.5e-5 of the largest magnitude off the
float64 result on the SPP case, where the port's f32 is within 4e-7; the
BatchNorm running statistics the two leave must agree too.  Tolerance:
1e-5 of the output's largest magnitude, elementwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.ops import blocks as jb
from rangeclip_tpu_torch.models.interop import block_state_dict_from_jax
from rangeclip_tpu_torch.ops import blocks as tb

RTOL = 1e-5

# (id, JAX module, port module factory (in_channels) -> module, input
# shape NHWC, an extra call argument: a target shape, or an NHWC skip map
# (NCHW for the port))
CASES = [
    ("depthwise_separable_bn",
     jb.DepthwiseSeparableConv2d(12, 3, 2, use_batch_norm=True),
     lambda c: tb.DepthwiseSeparableConv2d(c, 12, 3, 2, use_batch_norm=True),
     (2, 9, 11, 6), None),
    ("atrous_instance_norm",
     jb.AtrousConv2d(8, 3, 2, use_instance_norm=True, activation="elu"),
     lambda c: tb.AtrousConv2d(c, 8, 3, 2, use_instance_norm=True,
                               activation="elu"),
     (2, 10, 12, 5), None),
    ("transpose_conv_bn",
     jb.TransposeConv2d(6, 3, use_batch_norm=True),
     lambda c: tb.TransposeConv2d(c, 6, 3, use_batch_norm=True),
     (2, 7, 9, 4), None),
    ("transpose_conv_k5",
     jb.TransposeConv2d(3, 5, activation="relu"),
     lambda c: tb.TransposeConv2d(c, 3, 5, activation="relu"),
     (1, 6, 5, 4), None),
    ("up_conv",
     jb.UpConv2d(5, 3, use_batch_norm=True),
     lambda c: tb.UpConv2d(c, 5, 3, use_batch_norm=True),
     (2, 6, 7, 3), (13, 17)),
    ("fully_connected",
     jb.FullyConnected(7, activation="relu"),
     lambda c: tb.FullyConnected(c, 7, activation="relu"),
     (3, 10), None),
    ("atrous_resnet_projection",
     jb.AtrousResNetBlock(8, 2, use_batch_norm=True),
     lambda c: tb.AtrousResNetBlock(c, 8, 2, use_batch_norm=True),
     (2, 9, 9, 4), None),
    ("atrous_resnet_identity_depthwise",
     jb.AtrousResNetBlock(6, 3, use_depthwise_separable=True),
     lambda c: tb.AtrousResNetBlock(c, 6, 3, use_depthwise_separable=True),
     (2, 8, 10, 6), None),
    ("vgg",
     jb.VGGNetBlock(8, 3, 2, use_batch_norm=True),
     lambda c: tb.VGGNetBlock(c, 8, 3, 2, use_batch_norm=True),
     (2, 11, 10, 5), None),
    ("atrous_vgg_depthwise_instance_norm",
     jb.AtrousVGGNetBlock(6, 2, 3, use_instance_norm=True,
                          use_depthwise_separable=True),
     lambda c: tb.AtrousVGGNetBlock(c, 6, 2, 3, use_instance_norm=True,
                                    use_depthwise_separable=True),
     (2, 12, 12, 4), None),
    ("aspp_bn",
     jb.AtrousSpatialPyramidPooling(8, (1, 2), use_batch_norm=True),
     lambda c: tb.AtrousSpatialPyramidPooling(c, 8, (1, 2),
                                              use_batch_norm=True),
     (3, 9, 8, 5), None),
    ("spp_max",
     jb.SpatialPyramidPooling(6, (2, 4), "max", use_batch_norm=True),
     lambda c: tb.SpatialPyramidPooling(c, 6, (2, 4), "max",
                                        use_batch_norm=True),
     (2, 16, 12, 4), None),
    ("spp_average",
     jb.SpatialPyramidPooling(6, (2, 3), "average"),
     lambda c: tb.SpatialPyramidPooling(c, 6, (2, 3), "average"),
     (2, 12, 13, 3), None),
    ("resnet_projection_instance_norm",
     jb.ResNetBlock(8, 2, use_instance_norm=True),
     lambda c: tb.ResNetBlock(c, 8, 2, use_instance_norm=True),
     (2, 9, 10, 4), None),
    ("resnet_identity_depthwise_bn",
     jb.ResNetBlock(6, 1, use_batch_norm=True, use_depthwise_separable=True),
     lambda c: tb.ResNetBlock(c, 6, 1, use_batch_norm=True,
                              use_depthwise_separable=True),
     (2, 8, 9, 6), None),
    ("bottleneck_projection_depthwise_instance_norm",
     jb.ResNetBottleneckBlock(4, 2, use_instance_norm=True,
                              use_depthwise_separable=True),
     lambda c: tb.ResNetBottleneckBlock(c, 4, 2, use_instance_norm=True,
                                        use_depthwise_separable=True),
     (2, 10, 9, 6), None),
    ("bottleneck_identity_depthwise_bn",
     jb.ResNetBottleneckBlock(3, 1, use_batch_norm=True,
                              use_depthwise_separable=True),
     lambda c: tb.ResNetBottleneckBlock(c, 3, 1, use_batch_norm=True,
                                        use_depthwise_separable=True),
     (2, 8, 8, 12), None),
    ("decoder_instance_norm_resized_skip",
     jb.DecoderBlock(6, use_instance_norm=True, activation="relu"),
     lambda c: tb.DecoderBlock(c, 6, 5, use_instance_norm=True,
                               activation="relu"),
     (2, 5, 6, 4), np.random.default_rng(5).standard_normal(
         (2, 11, 12, 5)).astype(np.float32)),
]


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def _input(case):
    """(x, JAX call arguments, port call arguments) of a case."""
    _, _, _, shape, extra = case
    x = np.random.default_rng(len(shape) + shape[-1]).standard_normal(
        shape).astype(np.float32)
    args = () if extra is None else (extra,)
    if isinstance(extra, np.ndarray):  # a skip map
        return x, (jnp.asarray(extra),), (_nchw(extra),)
    return x, args, args


@functools.lru_cache(maxsize=None)
def _jax_init(i):
    """The JAX block of ``CASES[i]`` initialised from key 3 (one program,
    shared by the eval and train cases): numpy params and statistics."""
    jax_mod = CASES[i][1]
    x, args, _ = _input(CASES[i])
    variables = jax.jit(lambda k, x: jax_mod.init(k, x, *args))(
        jax.random.key(3), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   variables.get("batch_stats", {}))
    if stats:  # running statistics away from their initial 0 / 1
        rng = np.random.default_rng(7)
        stats = jax.tree_util.tree_map(
            lambda v: (v + rng.random(v.shape)).astype(np.float32), stats)
    return params, stats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_block_matches_jax(case, train):
    _, jax_mod, make, shape, _ = CASES[case]
    x, args, port_args = _input(CASES[case])
    params, stats = _jax_init(case)
    port = make(shape[-1])
    sd = block_state_dict_from_jax(params, stats)
    if not getattr(port, "use_projection", True):
        # the unused projection the port keeps and the JAX tree lacks
        sd["projection.conv.weight"] = port.projection.conv.weight.detach()
    port.load_state_dict(sd, strict=True)
    port.train(train)

    jax_vars = {"params": params, **({"batch_stats": stats} if stats
                                     else {})}
    updated = None
    if train:
        with jax.enable_x64(True):
            f64 = jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, jnp.float64), jax_vars)
            want, updated = jax.jit(lambda v, x: jax_mod.apply(
                v, x, *args, train=True, mutable=["batch_stats"]))(
                    f64, jnp.asarray(x, jnp.float64))
            want = np.asarray(want)
            updated = jax.tree_util.tree_map(
                lambda v: np.asarray(v, np.float32),
                updated.get("batch_stats", {}))
    else:
        want = np.asarray(jax.jit(lambda v, x: jax_mod.apply(v, x, *args))(
            jax_vars, jnp.asarray(x)))
    got = port(_nchw(x), *port_args)
    _close(_nhwc(got), want)
    if updated:
        new_sd = block_state_dict_from_jax(params, updated)
        port_sd = port.state_dict()
        for key, value in new_sd.items():
            if "running_" in key:
                np.testing.assert_allclose(port_sd[key].numpy(),
                                           value.numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_conv_transpose_2d_matches_torch_module():
    """``conv_transpose_2d`` is torch's ConvTranspose2d (stride 2, padding
    k//2, output padding 1: exact doubling) on the module's own weight."""
    gen = torch.Generator().manual_seed(0)
    module = torch.nn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                      output_padding=1, bias=False)
    x = torch.randn(2, 4, 9, 7, generator=gen)
    got = tb.conv_transpose_2d(x, module.weight, 2, 1, 1)
    assert got.shape == (2, 6, 18, 14)
    torch.testing.assert_close(got, module(x), rtol=0, atol=0)


def test_batch_and_instance_norm_exclusive():
    with pytest.raises(ValueError, match="both batch and instance"):
        tb.Conv2d(3, 4, use_batch_norm=True, use_instance_norm=True)
    for block in (tb.ResNetBlock, tb.ResNetBottleneckBlock,
                  tb.DecoderBlock):
        with pytest.raises(ValueError, match="both batch and instance"):
            block(3, 4, use_batch_norm=True, use_instance_norm=True)
    with pytest.raises(ValueError, match="pooling function"):
        tb.SpatialPyramidPooling(3, 4, pool_func="median")
