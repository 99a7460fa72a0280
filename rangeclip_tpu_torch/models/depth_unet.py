"""DepthUNet with its unfolded ``predict``, the folded labels-only predict
and the opt-in fused-head predict (``rangeclip_tpu/models/depth_unet.py``).

Public functions keep the JAX package's layouts: depth [B, H, W] or
[B, H, W, 1], fields NHWC, top-k ids [B, H, W, k] int32.  Inside, the
network runs NCHW in ``channels_last``, so an NHWC view of any activation
is free.

Kernel dispatch follows the JAX package, with "kernels available" meaning
"the tensors are on a CUDA device": the hand-written kernels for CUDA
tensors, their plain PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rangeclip_tpu_torch.models.decoder import DepthDecoder
from rangeclip_tpu_torch.models.encoder import DepthEncoder
from rangeclip_tpu_torch.models.mit_encoder import MiTConfig, MiTDepthEncoder
from rangeclip_tpu_torch.ops.kernels.class_presence import class_presence
from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
    conv_kernel_fits,
    conv_score_topk,
    fold_to_rows,
    fused_conv_topk_applicable,
)
from rangeclip_tpu_torch.ops.kernels.head_topk import (
    fused_head_score_topk,
    weight_rows,
)
from rangeclip_tpu_torch.ops.kernels.l2_normalize import (
    field_kernel_applicable,
    l2_normalize_rows,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
    pixel_text_topk,
    select_topk,
)
from rangeclip_tpu_torch.ops.kernels.score_topk import score_topk
from rangeclip_tpu_torch.ops.resize import resize_nearest
from rangeclip_tpu_torch.utils.math import l2_normalize

SLOT_MULTIPLE = 128  # slot padding of the kernel paths (the JAX lane width)


@dataclasses.dataclass(frozen=True)
class DepthUNetConfig:
    """The JAX config's model fields.  ``dtype`` is the compute dtype
    (None: float32); parameters stay float32 either way."""

    unet_type: str = "resnet"
    n_layer: int = 18
    input_channels: int = 1
    encoder_filters: Tuple[int, ...] = (32, 64, 128, 256, 512)
    embedding_dim: int = 512
    weight_initializer: str = "kaiming_uniform"
    activation: str = "relu"
    use_batch_norm: bool = True
    temperature_text: float = 0.07
    temperature_image: float = 0.1
    dtype: Optional[torch.dtype] = None
    # Frozen-encoder finetune (model.py:397): the encoder stays in eval
    # mode while the model trains, so its BatchNorm normalises with, and
    # keeps, its running statistics; the optimizer side of the freeze
    # leaves the encoder's parameters out (training/optim.py).
    freeze_encoder: bool = False


class DepthUNet(nn.Module):
    """Depth map -> per-pixel CLIP-space embedding field.

    ``unet_type`` "resnet" takes the ResNet encoder of ``n_layer`` 18, 34 or
    50 over ``encoder_filters``; "mit" the MiT encoder with the last four
    ``encoder_filters`` as its stage widths.  The decoder has one block per
    encoder width (reversed) and takes the encoder's skip channels."""

    def __init__(self, config: DepthUNetConfig = DepthUNetConfig(),
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        common = dict(weight_initializer=config.weight_initializer,
                      activation=config.activation,
                      use_batch_norm=config.use_batch_norm, device=device,
                      generator=generator)
        filters = tuple(config.encoder_filters)
        if config.unet_type == "resnet":
            self.encoder = DepthEncoder(config.n_layer, filters,
                                        config.embedding_dim,
                                        config.input_channels, **common)
        elif config.unet_type == "mit":
            filters = filters[-4:]
            self.encoder = MiTDepthEncoder(
                MiTConfig(embed_dims=filters), config.embedding_dim,
                config.input_channels, device=device, generator=generator)
        else:
            raise ValueError(
                f"Unsupported depth encoder type: {config.unet_type}")
        skips = self.encoder.feature_channels[:-1]
        self.decoder = DepthDecoder(tuple(reversed(filters)),
                                    tuple(reversed(skips)),
                                    config.embedding_dim,
                                    config.embedding_dim, **common)
        self.log_temperature_text = nn.Parameter(torch.log(torch.tensor(
            config.temperature_text, dtype=torch.float32, device=device)))
        self.log_temperature_image = nn.Parameter(torch.log(torch.tensor(
            config.temperature_image, dtype=torch.float32, device=device)))
        self.to(memory_format=torch.channels_last)

    def train(self, mode: bool = True) -> "DepthUNet":
        """``nn.Module.train``, but a frozen encoder stays in eval mode."""
        super().train(mode)
        if self.config.freeze_encoder:
            self.encoder.eval()
        return self

    @property
    def field_scale(self) -> int:
        """Input rows to one row of the native field: 2 for the ResNet's
        H/2 field, 4 for the MiT's H/4."""
        return 4 if self.config.unet_type == "mit" else 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.config.dtype or torch.float32

    def _encode(self, depth: torch.Tensor):
        if depth.dim() == 3:
            depth = depth[..., None]
        x = depth.permute(0, 3, 1, 2).to(dtype=self.compute_dtype,
                                         memory_format=torch.channels_last)
        _, features, aspp = self.encoder(x)
        return aspp, features

    def forward(self, depth: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """depth [B, H, W(, 1)] -> (L2-normalised pixel embeddings
        [B, H, W, D], temperature_text, temperature_image).  BatchNorm runs
        in the module's mode: call ``eval()`` for inference."""
        target_shape = tuple(depth.shape[1:3])
        field = self.decoder(*self._encode(depth))
        # normalize and nearest-upsample are per-pixel, so their order is
        # free; normalizing at H/2 touches 4x fewer pixels
        field = l2_normalize(field.permute(0, 2, 3, 1), dim=-1)
        return (resize_nearest(field, target_shape),
                self.log_temperature_text.exp(),
                self.log_temperature_image.exp())

    def decode_features(self, depth: torch.Tensor) -> torch.Tensor:
        """Pre-head decoder features [B, H/2, W/2, n_filters[-1]] (NHWC
        view of a channels_last tensor): the input of the output conv."""
        return self.decoder(*self._encode(depth),
                            apply_head=False).permute(0, 2, 3, 1)

    def _raw_native_field(self, depth: torch.Tensor) -> torch.Tensor:
        """The output conv's field [B, H/2, W/2, D], un-normalised: the NHWC
        view of a channels_last tensor, so its pixel rows are contiguous."""
        return self.decoder(*self._encode(depth)).permute(0, 2, 3, 1)

    def embed(self, depth: torch.Tensor) -> torch.Tensor:
        """Pixel embeddings only (inference helper)."""
        return self(depth)[0]

    def forward_native(self, depth: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``forward`` without the final nearest upsample: (the normalised
        field at native resolution [B, H/2, W/2, D], temperature_text,
        temperature_image).  The full-resolution field is exactly its
        nearest x2 upsample.  BatchNorm runs in the module's mode."""
        field = normalize_native_field(self._raw_native_field(depth))
        return (field, self.log_temperature_text.exp(),
                self.log_temperature_image.exp())

    def native_field(self, depth: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
        """Native-resolution field [B, H/2, W/2, D], normalised or, with
        ``normalize=False``, as the output conv left it (for consumers that
        fuse the normalisation, as the ``pixel_text_topk`` kernel does)."""
        _require_eval(self, "native_field")
        field = self._raw_native_field(depth)
        return normalize_native_field(field) if normalize else field

    @torch.no_grad()
    def predict(
        self,
        depth: torch.Tensor,
        candidate_text_embeddings: torch.Tensor,
        candidate_mask: Optional[torch.Tensor],
        top_k: int = 5,
        scoring: str = "auto",
        score_native: bool = True,
        return_embeddings: Union[bool, str] = True,
        candidate_indices: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reduced-candidate top-k prediction (the JAX ``DepthUNet.predict``).

        Args, as in JAX:
          depth: [B, H, W(, 1)] depth maps.
          candidate_text_embeddings: the full text table [C, D]
            (un-normalised).
          candidate_mask: [C] bool, True for classes in the candidate set
            (None: every class); ignored when ``candidate_indices`` is
            given.
          top_k: labels per pixel.
          scoring: JAX's value names, so that calls translate one to one:
            'pallas' is the hand-written ``pixel_text_topk`` kernel (CUDA
            tensors only; normalisation fused into it), 'xla' the plain
            formulation (the decoder normalises, then an f32 product and a
            knockout top-k), 'auto' the kernel on CUDA and plain on the CPU.
          score_native: score at the decoder's native resolution (H/2) and
            nearest-upsample the ids: the same prediction as scoring at
            full resolution (``False``), with 4x fewer pixels scored.
          return_embeddings: ``True`` returns the full-resolution normalised
            field; ``False`` the field at the scoring resolution as the
            scoring used it (un-normalised on the kernel branch);
            ``"native"`` the normalised field at the scoring resolution.
          candidate_indices: [S] int32 ascending class ids, -1 padded: the
            table rows are gathered first and the ids come out global.

        Returns (top-k ids [B, H, W, k] int32 in the global label space, -1
        where the candidate set is exhausted; the pixel embeddings; the text
        temperature).
        """
        _require_eval(self, "predict")
        if depth.dim() == 3:
            depth = depth[..., None]
        target_shape = tuple(depth.shape[1:3])
        kernels = depth.device.type == "cuda"
        if scoring == "auto":
            scoring = "pallas" if kernels else "xla"
        if scoring not in ("pallas", "xla"):
            raise ValueError(f"unknown scoring {scoring!r}")
        if scoring == "pallas" and not kernels:
            raise ValueError("scoring='pallas' is the hand-written CUDA "
                             "kernel: it needs CUDA tensors")
        field = self._raw_native_field(depth)
        if not score_native:
            field = resize_nearest(field, target_shape).contiguous()
        if scoring == "xla":
            # the decoder's normalisation (decoder.py:100-133): the field
            # kernel applies at native resolution only
            field = (normalize_native_field(field) if score_native
                     else l2_normalize(field, dim=-1))
        temp_text = self.log_temperature_text.exp()

        table = candidate_text_embeddings.to(field.device)
        if candidate_indices is not None:
            ids = candidate_indices.to(field.device, torch.int32)
            table = table[ids.clamp_min(0).long()]
            candidate_mask = ids >= 0
        else:
            ids = torch.arange(table.shape[0], dtype=torch.int32,
                               device=field.device)
            candidate_mask = (torch.ones_like(ids, dtype=torch.bool)
                              if candidate_mask is None
                              else candidate_mask.to(field.device))
        text = l2_normalize(table.float(), dim=-1)

        B, H, W, D = field.shape
        if scoring == "pallas":
            idx, _ = pixel_text_topk(field, text, candidate_mask,
                                     top_k=top_k, want_values=False,
                                     candidate_ids=ids)
            if return_embeddings:  # True or "native"
                field = l2_normalize(field, dim=-1)
        else:
            logits = field.reshape(-1, D).float() @ text.T
            idx, _ = select_topk(logits, torch.where(candidate_mask, ids, -1),
                                 top_k)
        topk = idx.reshape(B, H, W, top_k)
        if (H, W) != target_shape:
            topk = resize_nearest(topk, target_shape)
            if return_embeddings is True:
                field = resize_nearest(field, target_shape)
        return topk, field, temp_text


def normalize_native_field(field: torch.Tensor) -> torch.Tensor:
    """The decoder's native-resolution normalisation (the JAX
    ``decoder.py:113-133``): a bf16 field on CUDA that passes
    ``field_kernel_applicable`` runs the ``l2_normalize`` kernels (forward
    and backward); everything else the plain ``l2_normalize``."""
    if (field.device.type == "cuda" and field.dtype == torch.bfloat16
            and field_kernel_applicable(tuple(field.shape))):
        return l2_normalize_rows(field)
    return l2_normalize(field, dim=-1)


def _require_eval(model: nn.Module, name: str) -> None:
    if model.training:
        raise ValueError(f"{name} needs the model in eval mode (BatchNorm "
                         "running statistics): call model.eval()")


@torch.no_grad()
def predict_topk_fused(model: DepthUNet, depth: torch.Tensor,
                       candidate_text_embeddings: torch.Tensor,
                       candidate_mask: torch.Tensor,
                       top_k: int = 5) -> torch.Tensor:
    """Labels-only predict with the whole segmentation head (output conv,
    L2 normalisation, scoring, masked top-k) in the ``head_topk`` kernels:
    on the tensor-core route (bf16) the [B, h, w, D] field never reaches
    device memory; the CUDA-core route (f32) keeps it in a workspace
    between its conv and its scoring launch.  Opt-in, as in the JAX
    package; CPU tensors run the kernel's plain version.

    The output conv's OIHW weight is reordered into the kernel's
    [9 * C_in, D] rows.  Unlike ``predict``, an exhausted candidate set
    gives id 0 (at -1e30) past the live classes, not -1: the TPU kernel's
    knockout answer, kept.

    Returns top-k ids [B, H, W, k] int32, nearest-upsampled to the input
    size."""
    _require_eval(model, "predict_topk_fused")
    if depth.dim() == 3:
        depth = depth[..., None]
    target_shape = tuple(depth.shape[1:3])
    features = model.decode_features(depth)
    B, h, w, _ = features.shape
    rows = weight_rows(model.decoder.output_conv.conv.weight)
    text = l2_normalize(candidate_text_embeddings.to(features.device).float(),
                        dim=-1)
    idx, _ = fused_head_score_topk(features, rows, text,
                                   candidate_mask.to(features.device), top_k)
    topk = idx.reshape(B, h, w, top_k)
    if (h, w) != target_shape:
        topk = resize_nearest(topk, target_shape)
    return topk


@torch.no_grad()
def predict_folded(
    model: DepthUNet,
    depth: torch.Tensor,
    candidate_text_embeddings: torch.Tensor,
    candidate_mask: Optional[torch.Tensor] = None,
    top_k: int = 5,
    candidate_indices: Optional[torch.Tensor] = None,
    candidate_ids: Optional[torch.Tensor] = None,
    want_values: bool = False,
    upsample: bool = True,
    max_candidate_id: Optional[int] = None,
):
    """Labels-only predict with the output conv folded into the scoring.

    The head is top-k_c(normalize(conv3x3(x, W)) . t_c).  The conv is
    bias-free and linear, so conv(x, W) . t_c == conv(x, W . t_c): one
    contraction of W with the normalised candidate table gives a conv
    straight to the S candidate scores, and the per-pixel normalisation,
    which scales every score of a pixel alike, is skipped.

    Candidate forms, as in the JAX function: ``candidate_indices`` ([S]
    ascending class ids, -1 padded) gathers the table rows;
    ``candidate_ids`` says the table rows already are the candidates, with
    ``max_candidate_id`` their static bound; otherwise the full table, with
    ``candidate_mask`` marking dead classes.  ``want_values`` also returns
    the winning (un-normalised) scores; ``upsample=False`` keeps the native
    H/2 resolution.

    Dispatch: on CUDA the slot count is padded to a multiple of 128 with
    dead (-1) slots, folded 128 slots at a time; bf16 features that pass ``fused_conv_topk_applicable``
    and whose width the kernel takes (``conv_kernel_fits``: C_in <= 136)
    take the fused conv+select kernel, everything else a plain conv to
    scores and the ``score_topk`` kernel.  On the CPU the same steps run
    with the kernels' plain versions.

    Returns ids [B, H, W, k] int32 in the global label space (or
    [B, h, w, k] without upsample), with ``want_values`` an (ids, values)
    tuple.
    """
    _require_eval(model, "predict_folded")
    if depth.dim() == 3:
        depth = depth[..., None]
    target_shape = tuple(depth.shape[1:3])
    features = model.decode_features(depth)
    B, h, w, _ = features.shape
    device = features.device
    W = model.decoder.output_conv.conv.weight  # [D, C_in, 3, 3]

    table = candidate_text_embeddings.to(device)
    if candidate_ids is not None:
        ids = candidate_ids.to(device, torch.int32)
        id_bound = max_candidate_id
    elif candidate_indices is not None:
        ids = candidate_indices.to(device, torch.int32)
        table = table[ids.clamp_min(0).long()]
        id_bound = candidate_text_embeddings.shape[0] - 1
    else:
        C = table.shape[0]
        ids = torch.arange(C, dtype=torch.int32, device=device)
        if candidate_mask is not None:
            ids = torch.where(candidate_mask.to(device), ids, -1)
        id_bound = C - 1
    kernels = device.type == "cuda"
    if kernels and table.shape[0] % SLOT_MULTIPLE:
        pad = SLOT_MULTIPLE - table.shape[0] % SLOT_MULTIPLE
        table = F.pad(table, (0, 0, 0, pad))
        ids = F.pad(ids, (0, pad), value=-1)
    text = l2_normalize(table.float(), dim=-1)
    # on CUDA the slots fold in blocks of SLOT_MULTIPLE, each one product of
    # the same shape, so that a slot's weights round alike at any slot count
    # (cuBLAS picks its algorithm by shape; a class-sharded predict folds
    # slices of the table)
    folded = torch.cat([
        torch.einsum("diyx,sd->siyx", W.float(), block)
        for block in (text.split(SLOT_MULTIPLE) if kernels else (text,))
    ]).to(features.dtype)
    S = folded.shape[0]

    if (kernels and features.dtype == torch.bfloat16
            and fused_conv_topk_applicable(features.shape, S, id_bound)
            and conv_kernel_fits(features.shape[-1])):
        idx, val = conv_score_topk(features.contiguous(), fold_to_rows(folded),
                                   ids, top_k=top_k, want_values=want_values)
    else:
        scores = F.conv2d(features.permute(0, 3, 1, 2),
                          folded.contiguous(memory_format=torch.channels_last),
                          padding=1)
        idx, val = score_topk(scores.permute(0, 2, 3, 1).contiguous(), ids,
                              top_k=top_k, want_values=want_values,
                              max_id=id_bound)
    topk = idx.reshape(B, h, w, top_k)
    values = val.reshape(B, h, w, top_k) if want_values else None
    if upsample and (h, w) != target_shape:
        topk = resize_nearest(topk, target_shape)
        if want_values:
            values = resize_nearest(values, target_shape)
    return (topk, values) if want_values else topk


def folded_is_profitable(num_slots: int, embedding_dim: int = 512,
                         fused_ok: bool = False) -> bool:
    """The JAX package's rule for ``--predict_path auto``: fold while the
    padded slot count stays within 1.5x the embedding dim, or always when
    the fused conv+select kernel applies.  The crossover was measured on a
    TPU and is kept only so that dispatch matches; it is to be re-derived
    on the H100."""
    if fused_ok:
        return True
    padded = -(-num_slots // SLOT_MULTIPLE) * SLOT_MULTIPLE
    return padded <= (3 * embedding_dim) // 2


def fused_head_ok(batch: int, num_classes: int, dtype: torch.dtype,
                  device: torch.device) -> bool:
    """Will ``predict_folded`` over a full table of ``num_classes`` rows take
    the fused kernel?  Unlike the JAX helper, this checks the compute dtype
    and the global id bound (ids 0..C-1 < 2**16), not only the batch."""
    return (device.type == "cuda" and dtype == torch.bfloat16
            and batch % 128 == 0 and num_classes - 1 < 2 ** 16)


def sample_gumbel(num_classes: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[C] standard Gumbel noise, drawn on the CPU from ``generator``."""
    u = torch.rand(num_classes, generator=generator).clamp_min(
        torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def build_candidate_mask(segmentation: torch.Tensor, num_classes: int,
                         num_negatives: int,
                         gumbel: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         group=None) -> torch.Tensor:
    """[C] bool mask: the classes present in ``segmentation`` plus
    ``num_negatives`` others drawn without replacement (Gumbel top-k over
    the complement).  ``gumbel`` ([C]) is the noise; without it, noise is
    drawn from ``generator``.  JAX draws its noise inside the function from
    a key; passing the same draw here gives the same mask.  Under a process
    ``group`` presence is taken over every rank's rows
    (``parallel/kernel_shard.sharded_class_presence``), and the noise must
    be the same on every rank."""
    device = segmentation.device
    # every label counts: JAX's all-ones validity vector
    if group is None:
        gt_mask = class_presence(
            segmentation.reshape(-1).to(torch.int32).contiguous(), None,
            num_classes)
    else:  # imported here: the parallel package imports this module
        from rangeclip_tpu_torch.parallel.kernel_shard import (
            sharded_class_presence,
        )

        gt_mask = sharded_class_presence(segmentation, None, num_classes,
                                         group)
    if gumbel is None:
        gumbel = sample_gumbel(num_classes, generator)
    scores = torch.where(gt_mask, -math.inf,
                         gumbel.to(device, torch.float32))
    picked, neg_idx = torch.topk(scores, min(num_negatives, num_classes))
    neg_mask = torch.zeros(num_classes, dtype=torch.bool, device=device)
    neg_mask.scatter_(0, neg_idx, torch.isfinite(picked))
    return gt_mask | neg_mask


def candidate_indices_from_mask(candidate_mask: torch.Tensor,
                                capacity: int) -> torch.Tensor:
    """[C] bool mask -> [capacity] int32 class ids, ascending, -1 padded
    (classes beyond the capacity are dropped, largest ids first)."""
    C = candidate_mask.shape[0]
    device = candidate_mask.device
    score = torch.where(
        candidate_mask,
        C - torch.arange(C, dtype=torch.int32, device=device), 0)
    val, idx = torch.topk(score, min(capacity, C))
    idx = torch.where(val > 0, idx.to(torch.int32), -1)
    if capacity > C:
        idx = F.pad(idx, (0, capacity - C), value=-1)
    return idx


def build_candidate_indices(segmentation: torch.Tensor, num_classes: int,
                            num_negatives: int, capacity: int,
                            gumbel: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """:func:`build_candidate_mask` as a fixed-capacity ascending index
    list, the form ``predict_folded(candidate_indices=...)`` takes."""
    mask = build_candidate_mask(segmentation, num_classes, num_negatives,
                                gumbel, generator)
    return candidate_indices_from_mask(mask, capacity)
