"""Set-up shared by the inference CLIs (serve, infer, export): the label
table, the model from a reference ``.pth``, the choice of predict path and
the predict function itself."""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch

from rangeclip_tpu_torch.models.clip.provider import get_text_provider
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    folded_is_profitable,
    fused_head_ok,
    predict_folded,
)
from rangeclip_tpu_torch.models.interop import load_reference_pth

PREDICT_PATHS = ("auto", "folded", "default")
PREDICT_PATH_HELP = (
    "'folded' contracts the output conv with the text table (same ranking, "
    "faster for small candidate counts); 'default' is the unfolded "
    "reference scoring order (DepthUNet.predict with the pixel_text_topk "
    "kernel); 'auto' folds while the class count stays under the "
    "~1.5x-embedding-dim crossover or the fused conv+select kernel applies")


def set_precision(bf16: bool) -> None:
    """fp32 is the parity mode: keep cuDNN's convolutions and matrix
    products off TF32.  bf16 leaves PyTorch's defaults."""
    if not bf16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def label_table(args, labels: Sequence[str], device: torch.device,
                dim: Optional[int] = None) -> torch.Tensor:
    """The labels' [C, D] f32 text table on ``device``: the CLIP text tower
    when ``--clip_checkpoint_path``, ``--clip_vocab_path`` and
    ``--clip_merges_path`` are all given (the tower runs on ``device``),
    the hash stub of width ``dim`` (default ``--embedding_dim``)
    otherwise."""
    provider = get_text_provider(
        args.clip_checkpoint_path, args.clip_vocab_path,
        args.clip_merges_path, dim=dim or args.embedding_dim, device=device)
    return torch.from_numpy(provider(labels)).to(device)


def load_model(args, device: torch.device,
               config_overrides: Optional[Mapping] = None,
               init_random: bool = False) -> DepthUNet:
    """DepthUNet in eval mode from ``args.checkpoint_path`` (reference
    ``.pth``), or with random weights from seed 0.  ``config_overrides``
    adjusts DepthUNetConfig fields beyond the flags (encoder widths)."""
    cfg = DepthUNetConfig(
        unet_type=args.unet_architecture, embedding_dim=args.embedding_dim,
        use_batch_norm=True, dtype=torch.bfloat16 if args.bf16 else None,
        **(config_overrides or {}))
    if init_random:
        model = DepthUNet(cfg, device=device,
                          generator=torch.Generator().manual_seed(0))
    else:
        model = DepthUNet(cfg, device=device)
        model.load_state_dict(load_reference_pth(args.checkpoint_path),
                              strict=True)
    return model.eval()


def use_folded(predict_path: str, num_classes: int, embedding_dim: int,
               batch: int, dtype: torch.dtype, device: torch.device) -> bool:
    """The JAX CLIs' rule: 'folded' and 'default' as asked; 'auto' folds
    when ``folded_is_profitable`` says so."""
    if predict_path not in PREDICT_PATHS:
        raise ValueError(f"unknown predict path {predict_path!r}")
    if predict_path != "auto":
        return predict_path == "folded"
    return folded_is_profitable(
        num_classes, embedding_dim,
        fused_ok=fused_head_ok(batch, num_classes, dtype, device))


def make_predict(model: DepthUNet, top_k: int, folded: bool
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``predict(depth [B, H, W, 1], text [C, D]) -> ids [B, H, W, k]``
    over the full table (open-set: every class is a candidate)."""

    def predict(depth: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        if folded:
            return predict_folded(model, depth, text, top_k=top_k)
        return model.predict(depth, text, None, top_k,
                             return_embeddings=False)[0]

    return predict
