"""Training CLI: the JAX package's flag surface (``rangeclip_tpu/cli/train.py``)
plus ``--device`` (default cuda; cpu runs the kernels' plain versions).

Usage:
  python -m rangeclip_tpu_torch.cli.train \
    --labeled_metadata_path data/metadata.csv \
    --labels_path data/candidate_labels.csv \
    --equivalence_dict_path data/label_similarity_sets.csv \
    --checkpoint_path checkpoints --unet_architecture resnet --bf16

Checkpoints are reference ``.pth`` files (``checkpoints/checkpoints/
depth_segmentation_model-{step}.pth``) that ``cli/serve`` and ``cli/infer``
load as they are; validation runs from ``--validation_start_step`` on.
``--profile_dir`` writes a Chrome trace (``torch.profiler``) of optimizer
steps 2-4 of the run.  Multi-GPU (``--ddp_parity``, ``--distributed``)
raises NotImplementedError.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)

    # Training and validation input filepaths (train.py:27-33)
    parser.add_argument("--labeled_metadata_path", type=str, required=True,
                        help="Path to labeled dataset metadata.csv")
    parser.add_argument("--labels_path", type=str, required=True,
                        help="Path to dataset labels CSV")
    parser.add_argument("--equivalence_dict_path", type=str, required=True,
                        help="Path to equivalence/similarity-sets CSV")

    # Batch parameters (train.py:36-41)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--n_height", type=int, default=128)
    parser.add_argument("--n_width", type=int, default=128)

    # Network settings (train.py:44-48)
    parser.add_argument("--unet_architecture", type=str, required=True,
                        help="UNet encoder architecture, e.g. resnet")
    parser.add_argument("--clip_checkpoint_path", type=str, default=None,
                        help="HF CLIP checkpoint (.bin/.safetensors) for the "
                             "frozen towers; omit to use deterministic stubs")
    parser.add_argument("--clip_vocab_path", type=str, default=None)
    parser.add_argument("--clip_merges_path", type=str, default=None)

    # Training settings (train.py:51-57)
    parser.add_argument("--learning_rates", nargs="+", type=float,
                        default=[2e-4, 1e-4, 5e-5, 1e-5])
    parser.add_argument("--scheduler_type", type=str, default="multi_step",
                        help="multi_step, cosine_annealing, reduce_on_plateau")
    parser.add_argument("--learning_schedule", nargs="+", type=int,
                        default=[10, 20, 30, 35])

    # Loss settings (train.py:60-61 + train_util.py:88-91 defaults)
    parser.add_argument("--w_weight_decay", type=float, default=0.0)
    parser.add_argument("--w_text", type=float, default=1.0)
    parser.add_argument("--w_image", type=float, default=0.5)
    parser.add_argument("--w_smooth", type=float, default=2e2)
    parser.add_argument(
        "--contrast_capacity", type=int, default=128,
        help="Packed-contrast CE capacity on TPU bf16 runs (0 disables): "
        "the fused CE scores a gathered member table of this many class "
        "slots instead of the full label table when the live contrast set "
        "fits, falling back to full-table scoring on overflow.")
    parser.add_argument(
        "--class_balanced", action="store_true",
        help="Rescale pixel-text CE weights so every present class "
        "contributes equal total weight per window (opt-in divergence "
        "from the reference's uniform pixel sampling; counters dominant-"
        "class gradient dilution — see HybridLossConfig.class_balanced).")
    parser.add_argument("--accumulation_steps", type=int, default=8)

    # Checkpointing and logging (train.py:64-77)
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--n_step_per_checkpoint", type=int, default=5000)
    parser.add_argument("--n_step_per_summary", type=int, default=1000)
    parser.add_argument("--n_step_per_validation", type=int, default=None,
                        help="Validation cadence; default: every "
                             "--n_step_per_summary (reference behavior)")
    parser.add_argument("--n_sample_per_summary", type=int, default=4)
    parser.add_argument("--validation_start_step", type=int, default=5000)
    parser.add_argument("--restore_path_model", type=str, default=None)
    parser.add_argument("--auto_resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "checkpoint_path if one exists (preemption "
                             "recovery)")
    parser.add_argument("--restore_path_encoder", type=str, default=None)
    parser.add_argument("--freeze_encoder", action="store_true", default=None,
                        help="freeze the depth encoder (eval-mode BN, zero "
                             "updates); defaults to ON when "
                             "--restore_path_encoder is given "
                             "(train_util.py:158 semantics)")
    parser.add_argument("--no_freeze_encoder", dest="freeze_encoder",
                        action="store_false",
                        help="finetune the restored encoder instead")

    parser.add_argument("--embedding_dim", type=int, default=512,
                        help="joint embedding dim; must match the CLIP "
                             "projection_dim when real CLIP weights are used")

    # Hardware settings
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute policy (fp32 params)")
    parser.add_argument("--ddp_parity", action="store_true",
                        help="reference-exact multi-device semantics: "
                             "per-replica BN statistics and per-rank losses "
                             "over local batch shards, gradients pmean'd "
                             "(torch DDP, train_util.py:338) instead of the "
                             "default global-batch sync-BN formulation")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of train "
                             "steps 2-4 into this directory")
    parser.add_argument("--distributed", action="store_true",
                        help="call jax.distributed.initialize() (multi-host)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0's coordinator for "
                             "--distributed outside a managed cluster "
                             "(where initialize() auto-detects)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--encoder_filters", nargs="+", type=int, default=None,
                        help="encoder channel widths (default: the "
                             "reference's ResNet-18 widths); small values "
                             "for smoke drives")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if len(args.learning_rates) != len(args.learning_schedule):
        raise SystemExit("Mismatch in learning rates and schedule lengths")
    from rangeclip_tpu_torch.training.trainer import (
        TrainerConfig,
        train_depth_clip_model,
    )

    fields = {f for f in TrainerConfig.__dataclass_fields__}
    cfg = TrainerConfig(**{k: v for k, v in vars(args).items()
                           if k in fields})
    best = train_depth_clip_model(cfg)
    print(f"Best results: {best}")
    return best


if __name__ == "__main__":
    main()
