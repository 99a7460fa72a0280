"""Validation and baseline CLI: the JAX package's flag surface
(``rangeclip_tpu/cli/validate.py``) plus ``--device`` (default cuda; cpu
runs the kernels' plain versions).  The model's architecture and widths
are read from the checkpoint; ``--unet_architecture`` and
``--embedding_dim``, where given, must match it.

Runs the equivalence-aware validation harness over the held-out split from
the newest ``depth_segmentation_model-<step>.pth`` in ``--checkpoint_dir``
(a reference ``.pth``, as ``cli/train`` writes), and with ``--baselines``
the majority and random baselines.

Usage:
  python -m rangeclip_tpu_torch.cli.validate \
    --labeled_metadata_path data/metadata.csv \
    --labels_path data/candidate_labels.csv \
    --equivalence_dict_path data/label_similarity_sets.csv \
    --checkpoint_dir checkpoints/checkpoints --baselines

The label table comes from the CLIP text tower when the three ``--clip_*``
flags are given, and the image embeddings from the CLIP vision tower when
``--clip_checkpoint_path`` is (``random``: seeded random weights); the hash
stubs stand in otherwise.
"""

from __future__ import annotations

import argparse
import os
import re
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--labeled_metadata_path", required=True)
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--equivalence_dict_path", required=True)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--n_height", type=int, default=224)
    parser.add_argument("--n_width", type=int, default=224)
    parser.add_argument("--split", choices=["val", "test"], default="val")
    parser.add_argument("--embedding_dim", type=int, default=None,
                        help="the checkpoint's embedding dim (default: read "
                             "from the checkpoint)")
    parser.add_argument("--unet_architecture", default=None,
                        help="resnet or mit (SegFormer-style encoder); "
                             "default: the checkpoint's")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--num_negatives", type=int, default=50)
    parser.add_argument("--baselines", action="store_true",
                        help="also run the majority and random baselines")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    return parser


def latest_model_path(checkpoint_dir: str):
    """(path, step) of the newest ``depth_segmentation_model-<step>.pth``."""
    pattern = re.compile(r"^depth_segmentation_model-(\d+)\.pth$")
    steps = [int(m.group(1)) for m in map(pattern.match,
                                           os.listdir(checkpoint_dir)) if m]
    if not steps:
        raise FileNotFoundError(
            f"no depth_segmentation_model-<step>.pth in {checkpoint_dir}")
    step = max(steps)
    return os.path.join(checkpoint_dir,
                        f"depth_segmentation_model-{step}.pth"), step


def load_validation(args):
    """(device, step, model, loader, inputs) of a parsed command line: the
    newest checkpoint's model in eval mode, the split's loader, and
    ``validate_model``'s remaining tensors and providers by name."""
    import torch

    from rangeclip_tpu_torch.cli.common import label_table, set_precision
    from rangeclip_tpu_torch.data.labels import (
        build_equivalence_class_map,
        build_equivalence_tensor,
        build_similarity_matrices,
        load_equivalence_dict,
        load_label_similarity_sets,
    )
    from rangeclip_tpu_torch.data.loader import setup_dataloaders
    from rangeclip_tpu_torch.models.clip.provider import get_image_provider
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )
    from rangeclip_tpu_torch.models.interop import (
        load_reference_pth,
        widths_from_state_dict,
    )
    from rangeclip_tpu_torch.training.curriculum import (
        get_curriculum_schedule,
    )
    from rangeclip_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    set_precision(False)  # validation runs the fp32 parity mode, as in JAX
    path, step = latest_model_path(args.checkpoint_dir)
    state_dict = load_reference_pth(path)
    widths = widths_from_state_dict(state_dict)
    dim = widths["embedding_dim"]
    for flag, key in (("--embedding_dim", "embedding_dim"),
                      ("--unet_architecture", "unet_type")):
        value = getattr(args, flag[2:])
        if value not in (None, widths[key]):
            raise ValueError(f"{flag} {value} does not match the "
                             f"checkpoint's {widths[key]} ({path})")
    model = DepthUNet(DepthUNetConfig(**widths), device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()

    _, val_loader, test_loader, _, labels = setup_dataloaders(
        args.labeled_metadata_path, args.labels_path,
        (args.n_height, args.n_width), args.batch_size, n_epoch=1)
    loader = val_loader if args.split == "val" else test_loader
    num_classes = len(labels)

    eq_tensor = build_equivalence_tensor(
        load_equivalence_dict(args.equivalence_dict_path), num_classes)
    medium, hard = build_similarity_matrices(load_label_similarity_sets(
        args.equivalence_dict_path, num_classes), num_classes)
    inputs = dict(
        text_table=label_table(args, labels, device, dim),
        medium_matrix=torch.from_numpy(medium).to(device),
        hard_matrix=torch.from_numpy(hard).to(device),
        equivalence_tensor=torch.from_numpy(eq_tensor),
        equiv_class_map=torch.from_numpy(
            build_equivalence_class_map(eq_tensor)),
        curriculum=get_curriculum_schedule(1, 1),
        image_provider=get_image_provider(args.clip_checkpoint_path,
                                          dim=dim, device=device))
    return device, step, model, loader, inputs


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from rangeclip_tpu_torch.evals.baselines import (
        evaluate_majority_model,
        evaluate_random_model,
    )
    from rangeclip_tpu_torch.evals.validate import validate_model
    from rangeclip_tpu_torch.utils.logging import log

    device, step, model, loader, inputs = load_validation(args)
    t0 = time.perf_counter()
    best = validate_model(
        model, loader, step=step,
        best_results={"step": -1, "loss": float("inf")}, seed=args.seed,
        top_k=args.top_k, num_negatives=args.num_negatives, **inputs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_maps = len(loader.indices)
    log(f"Validated {n_maps} maps in {seconds:.2f} s on {device} (one "
        f"pass by the host clock, warm-up and loading included)")
    print(f"Validation results @ step {step}: {best}")
    out = {"step": step, "best": best}

    if args.baselines:
        num_classes = inputs["text_table"].shape[0]
        eq_tensor = inputs["equivalence_tensor"].numpy()
        eq_map = inputs["equiv_class_map"].numpy()
        seg_counts = np.zeros(num_classes, np.int64)
        for batch in loader:
            # exclude pad duplicates (sample_valid = 0) from the count
            valid = np.asarray(batch["sample_valid"]) > 0
            vals, counts = np.unique(
                np.asarray(batch["segmentation"])[valid], return_counts=True)
            seg_counts[vals] += counts
        majority = int(seg_counts.argmax())
        out["majority"] = evaluate_majority_model(
            loader, majority, eq_tensor, eq_map, num_classes, device=device)
        out["random"] = evaluate_random_model(
            loader, num_classes, eq_tensor, eq_map, device=device)
    return out


if __name__ == "__main__":
    main()
