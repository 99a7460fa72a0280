"""The block library (``rangeclip_tpu/ops/blocks.py``): the blocks of the
ResNet UNet, and the rest of the reference op library that no model path
uses (depthwise-separable, atrous and transposed convolutions, UpConv2d,
FullyConnected, the atrous ResNet and the VGG blocks, ASPP and SPP).

NCHW modules, run in ``channels_last``.  Module and parameter names follow
the reference's state-dict keys (``conv``, ``batch_norm``, ``projection``,
``upsample``), so reference checkpoints load with ``strict=True``; the
blocks outside the model take the JAX modules' names
(``models/interop.block_state_dict_from_jax`` converts their weights).
Every conv block ends in BatchNorm or InstanceNorm (torch's defaults: eps
1e-5, biased variance, no affine) or neither, then its activation.

Parameters stay float32.  A block computes in the dtype of its input: conv
weights are cast to it, and BatchNorm normalises in float32 and casts back,
as the JAX blocks do with a bf16 compute dtype.  In train mode BatchNorm
updates its running statistics as flax does (:class:`BatchNorm2d`), and
inside :func:`sync_batch_norm` takes its statistics over the global batch
of a process group, as flax's ``BatchNorm`` does under a mesh.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.ops.activations import (
    DEFAULT_ACTIVATION,
    resolve_activation,
)
from rangeclip_tpu_torch.ops.initializers import init_bias_, init_weight_
from rangeclip_tpu_torch.ops.resize import (
    resize_bilinear_align_corners_nchw,
    resize_nearest,
)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype (bias-free)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


_SYNC_GROUP = None  # the process group of sync_batch_norm, while entered


@contextlib.contextmanager
def sync_batch_norm(group):
    """While entered, every :class:`BatchNorm2d` in train mode normalises
    with the statistics of the global batch over ``group``'s ranks (the
    global-batch train step enters it).  ``None`` changes nothing."""
    global _SYNC_GROUP
    saved, _SYNC_GROUP = _SYNC_GROUP, group
    try:
        yield
    finally:
        _SYNC_GROUP = saved


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of NCHW ``x`` over every rank's rows, in f32
    (f64 for an f64 ``x``).  The forward gathers each rank's per-channel
    [n, mean, centred sum of squares] in one all-reduce and combines them
    in rank order (Chan et al.'s pairwise update), so every rank holds the
    same biased variance.  flax takes ``E[x^2] - E[x]^2`` instead, which
    loses the variance of a channel whose mean is large against its
    spread: against ``F.batch_norm`` on one device (the CPU, ResNet-18 at
    full width on 32^2 maps) that form moved the step's gradients by up
    to 19% of a tensor's largest entry, the combination by 0.1%.  The backward all-reduces [sum dy,
    sum dy * xhat] for the input's gradient.  The weight and bias
    gradients are the local sums: the step adds the ranks' gradients up
    once a window.  Returns (y, mean, biased var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        from rangeclip_tpu_torch.parallel.mesh import gather_rows

        C = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var_r, mean_r = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        n_r = xf.new_full((1,), x.numel() // C)
        parts = gather_rows(torch.cat([n_r, mean_r, var_r * n_r])[None],
                            group)
        counts, means, m2s = parts[:, :1], parts[:, 1:C + 1], parts[:, C + 1:]
        n = counts.sum()
        mean = (counts * means).sum(dim=0) / n
        var = (m2s + counts * (means - mean).square()).sum(dim=0) / n
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        xhat = (xf - mean.reshape(shape)) * invstd.reshape(shape)
        y = xhat * weight.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group, ctx.dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from rangeclip_tpu_torch.parallel.mesh import all_reduce_sum

        xhat, invstd, weight, n = ctx.saved_tensors
        C = xhat.shape[1]
        dy = dy.to(xhat.dtype)
        local = torch.cat([dy.sum(dim=(0, 2, 3)),
                           (dy * xhat).sum(dim=(0, 2, 3))])
        sums = local.clone()
        all_reduce_sum([sums], ctx.group)
        shape = (1, -1, 1, 1)
        dx = (weight * invstd).reshape(shape) * (
            dy - (sums[:C] / n).reshape(shape)
            - xhat * (sums[C:] / n).reshape(shape))
        return dx.to(ctx.dtype), local[C:], local[:C], None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running statistics follow flax's
    ``BatchNorm(momentum=0.9)`` (blocks.py:89-96): 0.9 * old + 0.1 * batch,
    with the BIASED batch variance in f32, where torch's module takes the
    unbiased one.  Normalisation (batch statistics in train mode, running
    ones in eval mode) is torch's own; ``num_batches_tracked`` counts as
    before.  Inside :func:`sync_batch_norm` a train-mode forward takes the
    global batch's statistics (:class:`_SyncBatchNorm`), so every rank
    ends with the same running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        C = x.shape[1]
        n = x.numel() // C
        if _SYNC_GROUP is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, _SYNC_GROUP)
        elif n == 1:
            # one value per channel, which F.batch_norm refuses and flax
            # normalises to exactly the bias: x - mean is 0
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            shape = (1, -1, 1, 1)
            y = ((x - mean.reshape(shape))
                 * torch.rsqrt(var.reshape(shape) + self.eps)
                 * self.weight.reshape(shape) + self.bias.reshape(shape))
            var, mean = var.detach(), mean.detach()
        else:
            # momentum 1 into fresh buffers: the kernel hands back the
            # batch mean and the unbiased variance it normalised with, so
            # no second pass over x is needed for the statistics
            dtype = torch.promote_types(x.dtype, torch.float32)
            mean = torch.zeros(C, dtype=dtype, device=x.device)
            var = torch.zeros(C, dtype=dtype, device=x.device)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                             1.0, self.eps)
            var = var * ((n - 1) / n)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class NormAct(nn.Module):
    """The epilogue of every conv block (blocks.py:70-105): BatchNorm or
    InstanceNorm, then the activation.  Norms run in f32 and cast back.  A
    block calls :meth:`init_norm_act` after creating its convolutions, so
    its parameters keep the order conv, then norm."""

    def init_norm_act(self, features: int, activation=DEFAULT_ACTIVATION,
                      use_batch_norm: bool = False,
                      use_instance_norm: bool = False,
                      device: Optional[torch.device] = None) -> None:
        if use_batch_norm and use_instance_norm:
            raise ValueError("Unable to apply both batch and instance "
                             "normalization")
        # torch momentum 0.1 == flax momentum 0.9
        self.batch_norm = (BatchNorm2d(features, eps=1e-5, momentum=0.1,
                                       device=device)
                           if use_batch_norm else None)
        self.use_instance_norm = use_instance_norm
        self.act = resolve_activation(activation)

    def norm_act(self, x: torch.Tensor) -> torch.Tensor:
        if self.batch_norm is not None:
            x = self.batch_norm(x.float()).to(x.dtype)
        elif self.use_instance_norm:
            x = F.instance_norm(x.float(), eps=1e-5).to(x.dtype)
        return self.act(x) if self.act is not None else x


class Conv2d(NormAct):
    """conv(pad=k//2, no bias) -> optional BatchNorm/InstanceNorm ->
    activation (blocks.py:108-147)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride,
                              padding=kernel_size // 2, bias=False,
                              device=device)
        init_weight_(self.conv.weight, weight_initializer, generator)
        self.init_norm_act(features, activation, use_batch_norm,
                           use_instance_norm, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_act(conv2d(self.conv, x))


class DepthwiseSeparableConv2d(NormAct):
    """Depthwise k x k conv (stride, pad k//2) + pointwise 1x1 conv, then
    BatchNorm/InstanceNorm and the activation (blocks.py:150-198)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        self.conv_depthwise = nn.Conv2d(
            in_channels, in_channels, kernel_size, stride,
            padding=kernel_size // 2, groups=in_channels, bias=False,
            device=device)
        self.conv_pointwise = nn.Conv2d(in_channels, features, 1, bias=False,
                                        device=device)
        init_weight_(self.conv_depthwise.weight, weight_initializer,
                     generator)
        init_weight_(self.conv_pointwise.weight, weight_initializer,
                     generator)
        self.init_norm_act(features, activation, use_batch_norm,
                           use_instance_norm, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv_pointwise, conv2d(self.conv_depthwise, x))
        return self.norm_act(x)


class AtrousConv2d(NormAct):
    """Dilated conv (padding == dilation, stride 1) -> BatchNorm/
    InstanceNorm -> activation (blocks.py:201-241)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, 1,
                              padding=dilation, dilation=dilation,
                              bias=False, device=device)
        init_weight_(self.conv.weight, weight_initializer, generator)
        self.init_norm_act(features, activation, use_batch_norm,
                           use_instance_norm, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_act(conv2d(self.conv, x))


def conv_transpose_2d(x: torch.Tensor, weight: torch.Tensor, stride: int,
                      padding: int, output_padding: int,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's ConvTranspose2d of NCHW ``x`` with an IOHW ``weight``, in
    ``x``'s dtype (blocks.py:244-272, which reaches it as a convolution of
    the stride-dilated input with the flipped kernel)."""
    return F.conv_transpose2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride=stride, padding=padding, output_padding=output_padding)


class TransposeConv2d(NormAct):
    """Stride-2 transposed conv (padding k//2, output_padding 1, no bias:
    exactly doubles the spatial dims) -> BatchNorm/InstanceNorm ->
    activation (blocks.py:275-310).  The JAX block's (k, k, I, O) kernel,
    which it flips and convolves over the dilated input
    (``conv_transpose_2d``, blocks.py:244-272), is this module's IOHW
    ``conv_transpose.weight`` transposed."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(
            in_channels, features, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1, bias=False,
            device=device)
        init_weight_(self.conv_transpose.weight, weight_initializer,
                     generator)
        self.init_norm_act(features, activation, use_batch_norm,
                           use_instance_norm, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.conv_transpose
        return self.norm_act(conv_transpose_2d(x, t.weight, 2, t.padding[0],
                                               1))


class UpConv2d(nn.Module):
    """Nearest upsample to a target shape (torch's index rule,
    ``ops/resize.resize_nearest``), then :class:`Conv2d`
    (blocks.py:313-344)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 use_instance_norm: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, 1,
                           weight_initializer, activation, use_batch_norm,
                           device, generator, use_instance_norm)

    def forward(self, x: torch.Tensor, shape) -> torch.Tensor:
        x = resize_nearest(x.permute(0, 2, 3, 1), shape).permute(0, 3, 1, 2)
        return self.conv(x)


class FullyConnected(nn.Module):
    """Linear (torch's default bias) -> activation -> dropout when
    0 < rate <= 1, in train mode only (blocks.py:347-379)."""

    def __init__(self, in_features: int, features: int,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, dropout_rate: float = 0.0,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, device=device)
        init_weight_(self.linear.weight, weight_initializer, generator)
        init_bias_(self.linear.bias, in_features, generator)
        self.act = resolve_activation(activation)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x, self.linear.weight.to(x.dtype),
                     self.linear.bias.to(x.dtype))
        if self.act is not None:
            x = self.act(x)
        if 0.0 < self.dropout_rate <= 1.0:
            x = F.dropout(x, self.dropout_rate, self.training)
        return x


class ResNetBlock(nn.Module):
    """act(conv2(conv1(x)) + proj?(x)) (blocks.py:382-429).

    The reference instantiates the 1x1 ``projection`` in every block but
    applies it only when the stride or the channel count changes; the
    unused ones are kept so that its state dicts load strictly."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        self.conv1 = Conv2d(in_channels, features, 3, stride, **common)
        self.conv2 = Conv2d(features, features, 3, 1, **common)
        self.projection = Conv2d(in_channels, features, 1, stride,
                                 weight_initializer, activation=None,
                                 device=device, generator=generator)
        self.use_projection = stride != 1 or in_channels != features
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        out = out + (self.projection(x) if self.use_projection else x)
        return self.act(out) if self.act is not None else out


class ResNetBottleneckBlock(nn.Module):
    """act(conv3(conv2(conv1(x))) + proj?(x)), conv3 to 4 * features
    (blocks.py:432-478).  The projection applies when the stride or the
    channel count of the residual sum changes (the actual shapes, not
    conv2's).  An unused projection is kept, as in the basic block, at the
    [features, features] shape that the JAX package's reference export
    (``torch_interop.export_reference_checkpoint``) writes for it, so that
    its ``.pth`` files load strictly."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        out = self.expansion * features
        self.conv1 = Conv2d(in_channels, features, 1, 1, **common)
        self.conv2 = Conv2d(features, features, 3, stride, **common)
        self.conv3 = Conv2d(features, out, 1, 1, **common)
        self.use_projection = stride != 1 or in_channels != out
        proj = (in_channels, out) if self.use_projection else (features,
                                                               features)
        self.projection = Conv2d(*proj, 1, stride, weight_initializer,
                                 activation=None, device=device,
                                 generator=generator)
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        out = out + (self.projection(x) if self.use_projection else x)
        return self.act(out) if self.act is not None else out


def _conv_class(use_depthwise_separable: bool):
    return DepthwiseSeparableConv2d if use_depthwise_separable else Conv2d


class AtrousResNetBlock(nn.Module):
    """act(conv2(atrous conv1(x)) + proj?(x)), stride 1; the 1x1
    ``projection`` exists only where the channel count changes
    (blocks.py:483-528)."""

    def __init__(self, in_channels: int, features: int, dilation: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 use_instance_norm: bool = False,
                 use_depthwise_separable: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        self.conv1 = AtrousConv2d(in_channels, features, 3, dilation,
                                  **common)
        self.conv2 = _conv_class(use_depthwise_separable)(
            features, features, 3, 1, **common)
        self.projection = (Conv2d(in_channels, features, 1, 1,
                                  weight_initializer, activation=None,
                                  device=device, generator=generator)
                           if in_channels != features else None)
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        out = out + (self.projection(x) if self.projection is not None
                     else x)
        return self.act(out) if self.act is not None else out


class VGGNetBlock(nn.Module):
    """``n_convolution`` - 1 stride-1 3x3 convs, then one of ``stride``,
    named ``conv1`` .. ``conv{n}`` (blocks.py:531-563)."""

    def __init__(self, in_channels: int, features: int,
                 n_convolution: int = 1, stride: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 use_instance_norm: bool = False,
                 use_depthwise_separable: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        conv_cls = _conv_class(use_depthwise_separable)
        for n in range(1, n_convolution + 1):
            self.add_module(f"conv{n}", conv_cls(
                in_channels if n == 1 else features, features, 3,
                stride if n == n_convolution else 1, **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(x)
        return x


class AtrousVGGNetBlock(nn.Module):
    """``n_convolution`` - 1 stride-1 3x3 convs, then one atrous conv
    (blocks.py:566-598)."""

    def __init__(self, in_channels: int, features: int,
                 n_convolution: int = 1, dilation: int = 1,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 use_instance_norm: bool = False,
                 use_depthwise_separable: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        conv_cls = _conv_class(use_depthwise_separable)
        for n in range(1, n_convolution):
            self.add_module(f"conv{n}", conv_cls(
                in_channels if n == 1 else features, features, 3, 1,
                **common))
        self.add_module(f"conv{n_convolution}", AtrousConv2d(
            in_channels if n_convolution == 1 else features, features, 3,
            dilation, **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(x)
        return x


class AtrousSpatialPyramidPooling(nn.Module):
    """The library's ASPP (blocks.py:601-651; the model's GroupNorm variant
    is ``ops/aspp.py``): a 1x1 conv, one atrous conv per dilation and a
    global-pool branch (mean, 1x1 conv, bilinear align-corners resize back),
    concatenated and fused by a 1x1 conv with the activation only."""

    def __init__(self, in_channels: int, features: int,
                 dilations: Sequence[int] = (6, 12, 18),
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 use_instance_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        self.conv1 = Conv2d(in_channels, features, 1, 1, **common)
        self.atrous_convs = [f"atrous_conv{i + 1}"
                             for i in range(len(dilations))]
        for name, d in zip(self.atrous_convs, dilations):
            self.add_module(name, AtrousConv2d(in_channels, features, 3, d,
                                               **common))
        self.global_pool_conv = Conv2d(in_channels, features, 1, 1, **common)
        self.conv_fuse = Conv2d((len(dilations) + 2) * features, features, 1,
                                1, weight_initializer, activation,
                                device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[2:]
        branches = [self.conv1(x)]
        branches += [getattr(self, name)(x) for name in self.atrous_convs]
        pooled = self.global_pool_conv(x.mean(dim=(2, 3), keepdim=True))
        branches.append(resize_bilinear_align_corners_nchw(pooled, size))
        return self.conv_fuse(torch.cat(branches, dim=1))


class SpatialPyramidPooling(nn.Module):
    """SPP (blocks.py:654-704): per kernel size k a k x k stride-k max (or
    average) pool, a bilinear align-corners resize back and a 1x1 conv;
    the input and those branches concatenated, then two 3x3 convs, the last
    with the activation only."""

    def __init__(self, in_channels: int, features: int,
                 kernel_sizes: Sequence[int] = (2, 4, 8),
                 pool_func: str = "max",
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 use_instance_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool_func not in ("max", "average"):
            raise ValueError(f"Unsupported pooling function: {pool_func}")
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      use_instance_norm=use_instance_norm, device=device,
                      generator=generator)
        self.kernel_sizes = tuple(kernel_sizes)
        self.pool = F.max_pool2d if pool_func == "max" else F.avg_pool2d
        for i in range(len(self.kernel_sizes)):
            self.add_module(f"conv{i + 1}", Conv2d(in_channels, features, 1,
                                                   1, **common))
        self.conv_fuse1 = Conv2d(in_channels + len(self.kernel_sizes)
                                 * features, features, 3, 1, **common)
        self.conv_fuse2 = Conv2d(features, features, 3, 1,
                                 weight_initializer, activation,
                                 device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[2:]
        branches = [x]
        for i, k in enumerate(self.kernel_sizes):
            pooled = resize_bilinear_align_corners_nchw(self.pool(x, k, k),
                                                        size)
            branches.append(getattr(self, f"conv{i + 1}")(pooled))
        return self.conv_fuse2(self.conv_fuse1(torch.cat(branches, dim=1)))


class DecoderBlock(nn.Module):
    """ConvTranspose(k2, s2, bias) upsample -> bilinear resize to the skip
    if shapes differ -> concat -> two 3x3 convs (blocks.py:707-757)."""

    def __init__(self, in_channels: int, features: int,
                 skip_channels: int = 0,
                 weight_initializer: str = "kaiming_uniform",
                 activation=DEFAULT_ACTIVATION, use_batch_norm: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(in_channels, features, 2, stride=2,
                                           bias=True, device=device)
        init_weight_(self.upsample.weight, weight_initializer, generator)
        init_bias_(self.upsample.bias, features * 4, generator)
        common = dict(weight_initializer=weight_initializer,
                      activation=activation, use_batch_norm=use_batch_norm,
                      device=device, generator=generator)
        self.conv1 = Conv2d(features + skip_channels, features, 3, 1,
                            **common)
        self.conv2 = Conv2d(features, features, 3, 1, **common)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = conv_transpose_2d(x, self.upsample.weight, 2, 0, 0,
                              self.upsample.bias)
        if skip is not None:
            if x.shape[2:] != skip.shape[2:]:
                x = resize_bilinear_align_corners_nchw(x, skip.shape[2:])
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))
