"""Checkpoint migration CLI (``rangeclip_tpu/cli/convert.py``) in the port's
checkpoint form (``training/checkpoint.py``: a reference ``.pth`` beside
``optimizer-{step}.pt``).

  # reference .pth -> checkpoint directory (resumable by cli.train)
  python -m rangeclip_tpu_torch.cli.convert \\
      --from_pth depth_segmentation_model-4000.pth --checkpoint_path ckpt

  # checkpoint directory -> lone reference .pth
  python -m rangeclip_tpu_torch.cli.convert \\
      --checkpoint_dir ckpt/checkpoints --to_pth exported.pth [--step N]

The import writes ``<checkpoint_path>/checkpoints/`` at the ``.pth``'s
``train_step`` with fresh Adam state, as the JAX import starts fresh
(the reference's optimizer moments are not migrated either way); a resume
runs under its own optimizer flags.  The model flags
(``--unet_architecture``, ``--embedding_dim``, ``--encoder_filters``) are
checked against the widths the weights fix
(``models/interop.widths_from_state_dict``, as ``cli/validate`` reads
them) on import; a mismatch exits with a message.  The export, as in
JAX, takes no model flags.  Only single-element leaves (the
``[1]`` log-temperatures) are reshaped.  JAX's ``--n_height`` and
``--n_width`` sized its template state; the port's model needs no input
shape, so they are not taken.  The export writes the newest (or
``--step``) weights of the directory as one ``.pth``, which the reference
and the JAX package's ``load_reference_checkpoint`` load.

Both directions load the weights strictly into the model they fix, on
``--device`` (default cuda, as every entry point of the port; cpu where
asked), and write what that model holds.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--from_pth",
                        help="reference .pth to import (with "
                             "--checkpoint_path)")
    parser.add_argument("--checkpoint_path",
                        help="destination root for the imported checkpoint "
                             "(a 'checkpoints/' dir is created inside, "
                             "matching cli.train)")
    parser.add_argument("--checkpoint_dir",
                        help="checkpoint dir to export (with --to_pth)")
    parser.add_argument("--to_pth", help="destination .pth file")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step to export (default: latest)")
    parser.add_argument("--unet_architecture", default="resnet")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--encoder_filters", type=int, nargs=5, default=None,
                        help="override encoder widths (default: reference "
                             "32 64 128 256 512)")
    parser.add_argument("--device", default="cuda",
                        help="where the weights are loaded: cuda or cpu")
    return parser


def check_widths(args, widths) -> None:
    """Exit with a message where a model flag disagrees with the weights."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig

    filters = tuple(args.encoder_filters
                    or DepthUNetConfig().encoder_filters)
    given = {"--unet_architecture": (args.unet_architecture,
                                     widths["unet_type"]),
             "--embedding_dim": (args.embedding_dim,
                                 widths["embedding_dim"]),
             "--encoder_filters": (filters[-len(widths["encoder_filters"]):],
                                   widths["encoder_filters"])}
    for flag, (value, found) in given.items():
        if value != found:
            raise SystemExit(
                f"the weights do not match the model the flags build: "
                f"{flag} {value} against the weights' {found} — check "
                "--unet_architecture/--embedding_dim/--encoder_filters")


def load_weights(path: str, args, check: bool):
    """(the model the ``.pth`` at ``path`` fixes, loaded strictly on
    ``--device``; its train_step); ``check`` holds the model flags to the
    weights first."""
    import torch

    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )
    from rangeclip_tpu_torch.models.interop import (
        load_reference_pth,
        widths_from_state_dict,
    )
    from rangeclip_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    step = int(torch.load(path, map_location="cpu",
                          weights_only=True).get("train_step", 0))
    state_dict = load_reference_pth(path)
    widths = widths_from_state_dict(state_dict)
    if check:
        check_widths(args, widths)
    model = DepthUNet(DepthUNetConfig(**widths), device=device)
    try:
        model.load_state_dict(state_dict, strict=True)
    except RuntimeError as e:
        raise SystemExit(f"parameter mismatch against the model the flags "
                         f"build — check the model flags\n{e}") from e
    return model, step


def import_pth(args) -> str:
    from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
    from rangeclip_tpu_torch.training.state import create_train_state

    model, step = load_weights(args.from_pth, args, check=True)
    state = create_train_state(model.config,
                               model.log_temperature_text.device, model=model)
    state.step = step
    out_dir = os.path.join(args.checkpoint_path, "checkpoints")
    CheckpointManager(out_dir).save(state)
    print(f"Imported {args.from_pth} (train_step={step}) -> {out_dir}")
    return out_dir


def export_pth(args) -> str:
    from rangeclip_tpu_torch.models.interop import save_reference_pth
    from rangeclip_tpu_torch.training.checkpoint import CheckpointManager

    manager = CheckpointManager(args.checkpoint_dir)
    step = args.step if args.step is not None else manager.latest_step()
    if step is None or not os.path.exists(manager.model_path(step)):
        raise SystemExit(f"no checkpoint at step {step} in "
                         f"{args.checkpoint_dir}")
    model, saved = load_weights(manager.model_path(step), args, check=False)
    save_reference_pth(model, args.to_pth, train_step=saved)
    print(f"Exported step {saved} -> {args.to_pth} "
          "(loadable by the reference's DepthUNet.restore_model)")
    return args.to_pth


def main(argv=None) -> str:
    parser = build_parser()
    args = parser.parse_args(argv)
    importing = bool(args.from_pth)
    exporting = bool(args.to_pth)
    if importing == exporting:
        parser.error("exactly one of --from_pth / --to_pth is required")
    if importing and not args.checkpoint_path:
        parser.error("--from_pth requires --checkpoint_path")
    if exporting and not args.checkpoint_dir:
        parser.error("--to_pth requires --checkpoint_dir")
    return import_pth(args) if importing else export_pth(args)


if __name__ == "__main__":
    main()
