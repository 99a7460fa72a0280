"""Weights between the JAX package, reference ``.pth`` files and the port.

The port's modules carry the reference's state-dict names, so a reference
checkpoint (``{"encoder": sd, "decoder": sd, "log_temperature_text",
"log_temperature_image", "train_step"}``, written by the reference or by
``rangeclip_tpu.cli.convert --to_pth``) loads into ``DepthUNet`` with
``strict=True`` after prefixing the keys.  :func:`state_dict_from_jax`
re-implements, with numpy only, the layout mapping of
``rangeclip_tpu/models/torch_interop.py:export_reference_checkpoint``:
conv HWIO -> OIHW, conv-transpose (k, k, I, O) -> IOHW, dense [in, out] ->
[out, in], plus what torch state dicts carry and the JAX trees do not (BN
``num_batches_tracked`` and the unused identity-block projections).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]
_SIDES = (("encoder", "depth_encoder"), ("decoder", "depth_decoder"))
_ASPP = {
    "global_pool_conv": "global_pool.1",
    "global_pool_gn": "global_pool.2",
    "project_conv": "project.0",
    "project_gn": "project.1",
}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_prefix(name: str) -> str:
    if name.startswith("group"):  # group{g}_block{b} -> blocks.{g-1}.{b}
        g, b = name.split("_")
        return f"blocks.{int(g[5:]) - 1}.{int(b[5:])}"
    if name.startswith("up_block"):
        return f"up_blocks.{int(name[8:])}"
    if name.startswith("projection_head_fc"):
        return "projection_head.0" if name.endswith("1") else "projection_head.2"
    return name


def _reference_key(path: Path) -> str:
    """JAX tree path (below depth_encoder / depth_decoder) -> reference key."""
    name, leaf = path[0], path[-1]
    if name == "aspp":
        sub = path[1]
        if sub.startswith("branch"):
            k = sub.split("_")[0][6:]
            prefix = f"branches.{k}.{0 if sub.endswith('_conv') else 1}"
        else:
            prefix = _ASPP[sub]
        leaf = "weight" if leaf in ("kernel", "scale") else leaf
        return f"aspp.{prefix}.{leaf}"
    if leaf in ("upsample_kernel", "upsample_bias"):
        kind = "weight" if leaf == "upsample_kernel" else "bias"
        return f"{_module_prefix(name)}.upsample.{kind}"
    if name.startswith("projection_head"):
        return f"{_module_prefix(name)}.{'weight' if leaf == 'kernel' else 'bias'}"
    if name.startswith(("patch_embed", "stage")):
        return _mit_key(path)
    inner = path[1:]
    if inner[-2:] == ("conv", "kernel"):
        suffix = ".".join(inner[:-2] + ("conv", "weight"))
    elif inner[-3:-1] == ("norm_act", "batch_norm"):
        suffix = ".".join(inner[:-3] + ("batch_norm", _BN_LEAF[leaf]))
    else:
        raise KeyError(f"unmapped JAX parameter: {path}")
    return f"{_module_prefix(name)}.{suffix}"


def _mit_key(path: Path) -> str:
    """JAX MiT encoder path -> the port's MiT module tree:
    ``patch_embed{s}`` -> ``patch_embed.{s}``, ``stage{s}_block{i}`` ->
    ``blocks.{s}.{i}``, ``stage{s}_norm`` -> ``norm.{s}``."""
    name, *inner, leaf = path
    if name.startswith("patch_embed"):
        prefix = f"patch_embed.{name[11:]}"
    else:
        stage, sub = name[5:].split("_", 1)
        prefix = (f"norm.{stage}" if sub == "norm"
                  else f"blocks.{stage}.{sub[5:]}")
    leaf = "weight" if leaf in ("kernel", "scale") else leaf
    return ".".join([prefix, *inner, leaf])


def _to_torch_layout(key: str, v: np.ndarray) -> np.ndarray:
    if key.endswith("upsample.weight"):
        return np.transpose(v, (2, 3, 0, 1))  # (k, k, I, O) -> IOHW
    if v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
    if v.ndim == 2:
        return v.T  # [in, out] -> [out, in]
    return v


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        train_step: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX DepthUNet's (params, batch_stats) trees of numpy arrays ->
    the port's ``DepthUNet.state_dict()``: ResNet-18, 34 and 50 encoders
    under the reference's keys, the MiT encoder under the port's own."""
    out: Dict[str, torch.Tensor] = {}
    for side, target in _SIDES:
        flat = _flatten(params.get(target, {}))
        flat.update(_flatten(batch_stats.get(target, {})))
        sd = {}
        for path, v in flat.items():
            key = _reference_key(path)
            sd[key] = _to_torch_layout(key, v)
        for key in [k for k in sd if k.endswith("batch_norm.running_mean")]:
            sd[key.replace("running_mean", "num_batches_tracked")] = (
                np.asarray(train_step, np.int64))
        if side == "encoder":
            # the reference keeps a 1x1 projection in every ResNet block;
            # the JAX tree has only the ones that are applied (an unused
            # bottleneck one is written at conv2's width, as the JAX
            # package's export_reference_checkpoint writes it)
            for key in [k for k in sd if k.startswith("blocks.")
                        and ".conv2.conv.weight" in k]:
                proj = key.replace("conv2.conv.weight",
                                   "projection.conv.weight")
                ch = sd[key].shape[0]
                sd.setdefault(proj, np.zeros((ch, ch, 1, 1), np.float32))
        for key, v in sd.items():
            out[f"{side}.{key}"] = torch.tensor(v)
    for name in ("log_temperature_text", "log_temperature_image"):
        out[name] = torch.tensor(np.asarray(params[name], np.float32))
    return out


def _clip_key(path: Path) -> str:
    """JAX CLIP tower tree path -> the port tower's state-dict key."""
    *mods, leaf = path
    if not mods:  # the bare parameters: class token, position table
        return f"embeddings.{leaf}" + (
            "" if leaf == "class_embedding" else ".weight")
    if mods[0].startswith("layer") and mods[0][5:].isdigit():
        sub = {"attn": "self_attn", "fc1": "mlp.fc1",
               "fc2": "mlp.fc2"}.get(mods[1], mods[1])
        mods = [f"encoder.layers.{mods[0][5:]}", sub] + mods[2:]
    elif mods[0] in ("token_embedding", "patch_embedding"):
        mods = ["embeddings"] + mods
    elif mods[0] == "pre_layernorm":
        mods = ["pre_layrnorm"]  # HF's spelling
    return ".".join(mods + [_CLIP_LEAF.get(leaf, leaf)])


_CLIP_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def clip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``CLIPTextTower`` or ``CLIPVisionTower`` param tree of numpy
    arrays -> the port tower's ``state_dict()``: dense [in, out] ->
    [out, in], the patch conv HWIO -> OIHW, layers ``layer{i}`` ->
    ``encoder.layers.{i}`` with HF's submodule names."""
    out = {}
    for path, v in _flatten(params).items():
        key = _clip_key(path)
        if v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif v.ndim == 2 and path[-1] == "kernel":
            v = v.T
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


def block_state_dict_from_jax(params: Mapping,
                              batch_stats: Optional[Mapping] = None
                              ) -> Dict[str, torch.Tensor]:
    """A JAX block's (``rangeclip_tpu/ops/blocks.py``) (params,
    batch_stats) trees of numpy arrays -> the port block's
    ``state_dict()`` (``ops/blocks.py``, the JAX modules' names): the
    ``norm_act`` level dropped, conv kernels HWIO -> OIHW (a depthwise
    (k, k, 1, C) kernel becomes [C, 1, k, k]), TransposeConv2d's own
    (k, k, I, O) kernel -> ``conv_transpose.weight`` IOHW, dense [in, out]
    -> [out, in], BatchNorm scale/bias/mean/var under torch's names with
    ``num_batches_tracked`` 0."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        *mods, leaf = path
        mods = [m for m in mods if m != "norm_act"]
        if leaf == "kernel" and not mods:  # TransposeConv2d's own kernel
            key, v = "conv_transpose.weight", np.transpose(v, (2, 3, 0, 1))
        elif leaf == "kernel":
            key = ".".join(mods + ["weight"])
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        elif mods and mods[-1] == "batch_norm":
            key = ".".join(mods + [_BN_LEAF[leaf]])
            if leaf == "mean":
                out[".".join(mods + ["num_batches_tracked"])] = torch.tensor(
                    0, dtype=torch.int64)
        else:
            key = ".".join(mods + [leaf])
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` checkpoint -> the port's state dict.  Missing
    temperatures take the reference defaults log(0.07) / log(0.1); stored
    ones may be scalars or shape [1] (the JAX package writes the latter)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"{side}.{k}": v for side, _ in _SIDES
           for k, v in ckpt[side].items()}
    for name, default in (("log_temperature_text", 0.07),
                          ("log_temperature_image", 0.1)):
        value = ckpt.get(name)
        out[name] = torch.as_tensor(
            value if value is not None else math.log(default),
            dtype=torch.float32).reshape(())
    return out


def widths_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The ``DepthUNetConfig`` fields a checkpoint fixes: ``unet_type``;
    ``encoder_filters`` (a ResNet's stem and stage widths, read from their
    first convs, or a MiT's four stage widths); a ResNet's ``n_layer``
    (its blocks per stage and whether they are bottlenecks);
    ``embedding_dim`` (the output conv's channels) and ``use_batch_norm``."""
    out = {"embedding_dim": int(sd["decoder.output_conv.conv.weight"]
                                .shape[0]),
           "use_batch_norm": any(".batch_norm." in k for k in sd)}
    if "encoder.patch_embed.0.proj.weight" in sd:
        stages = sorted({int(k.split(".")[2]) for k in sd
                         if k.startswith("encoder.patch_embed.")})
        return {**out, "unet_type": "mit", "encoder_filters": tuple(
            int(sd[f"encoder.patch_embed.{s}.proj.weight"].shape[0])
            for s in stages)}
    blocks = {}
    for k in sd:
        if k.startswith("encoder.blocks."):
            g, b = map(int, k.split(".")[2:4])
            blocks[g] = max(blocks.get(g, 0), b + 1)
    stages = sorted(blocks)
    filters = [sd["encoder.conv1.conv.weight"].shape[0]] + [
        sd[f"encoder.blocks.{i}.0.conv1.conv.weight"].shape[0]
        for i in stages]
    counts = tuple(blocks[g] for g in stages)
    n_layer = (50 if "encoder.blocks.0.0.conv3.conv.weight" in sd
               else 18 if counts == (2, 2, 2, 2) else 34)
    return {**out, "unet_type": "resnet", "n_layer": n_layer,
            "encoder_filters": tuple(int(f) for f in filters)}


def save_reference_pth(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                       path: str, train_step: int = 0) -> str:
    """Write the port's weights (a DepthUNet or its state dict) as a
    reference ``.pth`` checkpoint, readable by the reference and by
    ``rangeclip_tpu.models.torch_interop.load_reference_checkpoint``."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    ckpt = {"train_step": int(train_step)}
    for side, _ in _SIDES:
        prefix = f"{side}."
        ckpt[side] = {k[len(prefix):]: v.detach().cpu().contiguous()
                      for k, v in sd.items() if k.startswith(prefix)}
    for name in ("log_temperature_text", "log_temperature_image"):
        ckpt[name] = sd[name].detach().cpu().float()
    torch.save(ckpt, path)
    return path
