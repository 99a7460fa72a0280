"""The plain reference of the ResNet DepthUNet: the network written out in
float32 PyTorch operations from a configuration file and a flat dict of
tensors keyed by the program's state-dict names.

It follows the published reference (jinryan/RangeCLIP ``utils/src``:
``encoder.py``, ``decoder.py``, ``aspp.py``, ``blocks.py``), including its
quirks:

* every conv block is conv (no bias, padding k // 2) -> norm ->
  activation, and the second conv of a basic block (the third of a
  bottleneck) keeps its activation before the residual sum, which is
  activated once more;
* the norm is BatchNorm, or with ``"norm": "instance"`` InstanceNorm
  without affine parameters (the program's ``use_instance_norm``);
* a block projects its input by a bias-free 1x1 conv only where the stride
  or the channel count changes;
* the second decoder block upsamples the ASPP map to H/8, then resizes it
  bilinearly (align_corners) back to its skip's H/16 before the concat;
* ASPP: a 1x1 branch and 3x3 branches of dilation 6, 12 and 18, each with
  GroupNorm(32) and ReLU, a pooled branch broadcast back, a 1x1 projection
  with GroupNorm and ReLU, then L2 normalisation over the channels;
* the field is the bias-free 3x3 output conv at H/2, L2-normalised per
  pixel.  The encoder's global embedding head feeds no loss and is left
  out.

``q`` rounds a tensor where the configuration computes in a lower
precision (the control); ``None`` keeps float32 throughout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Round = Optional[Callable[[torch.Tensor], torch.Tensor]]

BN_EPS = 1e-5
IN_EPS = 1e-5
GN_EPS = 1e-5


def _blocks(cfg: dict) -> Tuple[List[int], str, int]:
    if cfg["unet_type"] != "resnet":
        raise ValueError(f"unet_type {cfg['unet_type']!r} is not in the "
                         "reference")
    return list(cfg["n_blocks"]), cfg["block"], int(cfg["expansion"])


def _norm(cfg: dict) -> str:
    """'batch' (BatchNorm, with parameters and running statistics) or
    'instance' (InstanceNorm without affine: no state-dict entry)."""
    if cfg["norm"] not in ("batch", "instance"):
        raise ValueError(f"norm {cfg['norm']!r} is not in the reference")
    return cfg["norm"]


def encoder_channels(cfg: dict) -> List[int]:
    """Channels of the skip list: conv1, then each group's output."""
    filters = cfg["encoder_filters"]
    n_blocks, _, expansion = _blocks(cfg)
    return [filters[0]] + [f * expansion for f in filters[1:]]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, fan_in) of every state-dict entry, in order.
    Kinds: 'uniform' (U(-1/sqrt(fan_in), 1/sqrt(fan_in))), 'ones',
    'zeros', 'count' (an int64 zero), 'log_text', 'log_image'."""
    filters = list(cfg["encoder_filters"])
    D = int(cfg["embedding_dim"])
    n_blocks, block, expansion = _blocks(cfg)
    batch_norm = _norm(cfg) == "batch"
    spec = [("log_temperature_text", (), "log_text", 0.0),
            ("log_temperature_image", (), "log_image", 0.0)]

    def conv(name, out_c, in_c, k, norm=True):
        spec.append((f"{name}.conv.weight", (out_c, in_c, k, k), "uniform",
                     in_c * k * k))
        if norm and batch_norm:
            spec.extend([(f"{name}.batch_norm.weight", (out_c,), "ones", 0),
                         (f"{name}.batch_norm.bias", (out_c,), "zeros", 0),
                         (f"{name}.batch_norm.running_mean", (out_c,),
                          "zeros", 0),
                         (f"{name}.batch_norm.running_var", (out_c,),
                          "ones", 0),
                         (f"{name}.batch_norm.num_batches_tracked", (),
                          "count", 0)])

    conv("encoder.conv1", filters[0], int(cfg["input_channels"]), 7)
    in_c = filters[0]
    for g, (nf, nb) in enumerate(zip(filters[1:], n_blocks)):
        for b in range(nb):
            stride = 2 if (b == 0 and g > 0) else 1
            pre = f"encoder.blocks.{g}.{b}"
            out_c = nf * expansion
            if block == "basic":
                conv(f"{pre}.conv1", nf, in_c, 3)
                conv(f"{pre}.conv2", nf, nf, 3)
                proj = (nf, in_c)
            else:
                conv(f"{pre}.conv1", nf, in_c, 1)
                conv(f"{pre}.conv2", nf, nf, 3)
                conv(f"{pre}.conv3", out_c, nf, 1)
                used = stride != 1 or in_c != out_c
                proj = (out_c, in_c) if used else (nf, nf)
            conv(f"{pre}.projection", proj[0], proj[1], 1, norm=False)
            in_c = out_c
    final = in_c
    for i in (0, 2):
        spec.append((f"encoder.projection_head.{i}.weight",
                     (final if i == 0 else D, final), "uniform", final))
        spec.append((f"encoder.projection_head.{i}.bias",
                     (final if i == 0 else D,), "uniform", final))

    def gn_conv(name, conv_idx, out_c, in_c, k):
        spec.append((f"{name}.{conv_idx}.weight", (out_c, in_c, k, k),
                     "uniform", in_c * k * k))
        spec.append((f"{name}.{conv_idx + 1}.weight", (out_c,), "ones", 0))
        spec.append((f"{name}.{conv_idx + 1}.bias", (out_c,), "zeros", 0))

    rates = cfg["aspp_rates"]
    for k, rate in enumerate(rates):
        gn_conv(f"encoder.aspp.branches.{k}", 0, D, final,
                3 if rate > 1 else 1)
    gn_conv("encoder.aspp.global_pool", 1, D, final, 1)
    gn_conv("encoder.aspp.project", 0, D, (len(rates) + 1) * D, 1)

    dec = list(reversed(filters))
    skips = list(reversed(encoder_channels(cfg)[:-1]))
    in_c = D
    for i, nf in enumerate(dec):
        pre = f"decoder.up_blocks.{i}"
        spec.append((f"{pre}.upsample.weight", (in_c, nf, 2, 2), "uniform",
                     nf * 4))
        spec.append((f"{pre}.upsample.bias", (nf,), "uniform", nf * 4))
        skip = skips[i - 1] if i > 0 else 0
        conv(f"{pre}.conv1", nf, nf + skip, 3)
        conv(f"{pre}.conv2", nf, nf, 3)
        in_c = nf
    conv("decoder.output_conv", D, dec[-1], 3, norm=False)
    return spec


def make_params(cfg: dict, generator: torch.Generator,
                device: torch.device) -> Params:
    """Every state-dict entry of :func:`param_spec` from one uniform draw
    on ``device``: float32 parameters and statistics, int64 counters."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, kind, _ in spec
             if kind == "uniform"]
    draw = torch.rand(sum(sizes), generator=generator, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        if kind == "uniform":
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape).mul(
                1.0 / math.sqrt(fan_in))
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            value = cfg["temperature_text" if kind == "log_text"
                        else "temperature_image"]
            out[name] = torch.full(shape, math.log(value), device=device)
    return out


def trainable(params: Params) -> List[str]:
    """The names of the parameters (not the running statistics)."""
    return [k for k in params if not (k.endswith("running_mean")
                                      or k.endswith("running_var")
                                      or k.endswith("num_batches_tracked"))]


def _act(cfg: dict):
    name = cfg["activation"]
    if name == "relu":
        return F.relu
    raise ValueError(f"activation {name!r} is not in the reference")


class Net:
    """The network over ``params``: ``train=True`` normalises with the
    batch's statistics (and records them in ``stats``), ``False`` with the
    running ones."""

    def __init__(self, cfg: dict, params: Params, train: bool,
                 q: Round = None):
        self.cfg, self.p, self.train, self.q = cfg, params, train, q
        self.act = _act(cfg)
        self.batch_norm = _norm(cfg) == "batch"
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _r(self, x):
        return x if self.q is None else self.q(x)

    def conv(self, x, weight, stride=1, padding=0, dilation=1):
        return self._r(F.conv2d(self._r(x), self._r(self.p[weight]), None,
                                stride, padding, dilation))

    def bn(self, x, name):
        p = self.p
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        shape = (1, -1, 1, 1)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + BN_EPS)
        return self._r(y * p[f"{name}.weight"].reshape(shape)
                       + p[f"{name}.bias"].reshape(shape))

    def instance_norm(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False,
                                   keepdim=True)
        return self._r((x - mean) * torch.rsqrt(var + IN_EPS))

    def cba(self, x, name, k, stride=1):
        y = self.conv(x, f"{name}.conv.weight", stride, k // 2)
        if self.batch_norm:
            return self.act(self.bn(y, f"{name}.batch_norm"))
        return self.act(self.instance_norm(y))

    def gn(self, x, name, groups):
        N, C, H, W = x.shape
        g = x.reshape(N, groups, C // groups, H, W)
        var, mean = torch.var_mean(g, dim=(2, 3, 4), unbiased=False,
                                   keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(N, C, H, W)
        return self._r(y * self.p[f"{name}.weight"].reshape(1, -1, 1, 1)
                       + self.p[f"{name}.bias"].reshape(1, -1, 1, 1))

    def encoder(self, x):
        cfg = self.cfg
        filters = cfg["encoder_filters"]
        n_blocks, block, expansion = _blocks(cfg)
        x = self.cba(x, "encoder.conv1", 7, 2)
        features = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        in_c = filters[0]
        for g, (nf, nb) in enumerate(zip(filters[1:], n_blocks)):
            for b in range(nb):
                stride = 2 if (b == 0 and g > 0) else 1
                pre = f"encoder.blocks.{g}.{b}"
                if block == "basic":
                    out = self.cba(x, f"{pre}.conv1", 3, stride)
                    out = self.cba(out, f"{pre}.conv2", 3)
                else:
                    out = self.cba(x, f"{pre}.conv1", 1)
                    out = self.cba(out, f"{pre}.conv2", 3, stride)
                    out = self.cba(out, f"{pre}.conv3", 1)
                out_c = nf * expansion
                res = (self.conv(x, f"{pre}.projection.conv.weight", stride)
                       if stride != 1 or in_c != out_c else x)
                x = self._r(self.act(out + res))
                in_c = out_c
            features.append(x)
        return features, self.aspp(x)

    def aspp(self, x):
        groups = int(self.cfg["aspp_groups"])
        outs = []
        for k, rate in enumerate(self.cfg["aspp_rates"]):
            name = f"encoder.aspp.branches.{k}"
            pad = rate if rate > 1 else 0
            y = self.conv(x, f"{name}.0.weight", 1, pad, rate)
            outs.append(F.relu(self.gn(y, f"{name}.1", groups)))
        pooled = x.mean(dim=(2, 3), keepdim=True)
        y = self.conv(pooled, "encoder.aspp.global_pool.1.weight")
        y = F.relu(self.gn(y, "encoder.aspp.global_pool.2", groups))
        outs.append(y.expand(-1, -1, *x.shape[2:]))
        y = self.conv(torch.cat(outs, 1), "encoder.aspp.project.0.weight")
        y = F.relu(self.gn(y, "encoder.aspp.project.1", groups))
        return self._r(F.normalize(y, dim=1, eps=1e-12))

    def decoder(self, x, features, head: bool = True):
        skips = features[:-1][::-1]
        dec = list(reversed(self.cfg["encoder_filters"]))
        for i in range(len(dec)):
            pre = f"decoder.up_blocks.{i}"
            x = self._r(F.conv_transpose2d(
                self._r(x), self._r(self.p[f"{pre}.upsample.weight"]),
                self.p[f"{pre}.upsample.bias"], stride=2))
            if i > 0:
                skip = skips[i - 1]
                if x.shape[2:] != skip.shape[2:]:
                    x = self._r(F.interpolate(x, size=skip.shape[2:],
                                              mode="bilinear",
                                              align_corners=True))
                x = torch.cat([x, skip], 1)
            x = self.cba(x, f"{pre}.conv1", 3)
            x = self.cba(x, f"{pre}.conv2", 3)
        if not head:
            return x
        return self.conv(x, "decoder.output_conv.conv.weight", 1, 1)

    def field(self, depth: torch.Tensor) -> torch.Tensor:
        """depth [B, H, W, 1] -> the L2-normalised native field
        [B, H/2, W/2, D]."""
        x = depth.permute(0, 3, 1, 2).float()
        features, aspp = self.encoder(x)
        raw = self.decoder(aspp, features).permute(0, 2, 3, 1)
        return self._r(F.normalize(raw, dim=-1, eps=1e-12))

    def features(self, depth: torch.Tensor) -> torch.Tensor:
        """The output conv's input [B, n_filters[0], H/2, W/2]."""
        features, aspp = self.encoder(depth.permute(0, 3, 1, 2).float())
        return self.decoder(aspp, features, head=False)


E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class _Fp8(torch.autograd.Function):
    """float8 as fp8 training computes: the forward value in e4m3
    (saturated at its largest finite value), the gradient in e5m2 scaled
    per tensor to its largest magnitude."""

    @staticmethod
    def forward(ctx, x):
        return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(
            x.dtype)

    @staticmethod
    def backward(ctx, g):
        amax = g.abs().amax()
        scale = torch.where(amax > 0, E5M2_MAX / amax, torch.ones_like(amax))
        return (g * scale).to(torch.float8_e5m2).to(g.dtype) / scale


class _Bf16(torch.autograd.Function):
    """bfloat16 forward value and gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def control_round(dtype: str) -> Round:
    """The rounding of the control: one precision below the configuration's
    compute type (float8 below bfloat16, bfloat16 below float32), of the
    values forward and of their gradients backward."""
    if dtype == "bfloat16":
        return _Fp8.apply
    if dtype == "float32":
        return _Bf16.apply
    raise ValueError(f"no control precision below {dtype!r}")
