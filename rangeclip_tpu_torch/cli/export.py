"""Serialise the inference program with ``torch.export`` (port of
``rangeclip_tpu/cli/export.py``).

``torch.export.export`` freezes predict (model weights, the label table
unless ``--text_as_input``, and the whole forward + score + top-k program)
into an ``ExportedProgram`` that ``torch.export.save`` writes as a ``.pt2``
file; ``torch.export.load(path).module()`` runs it later without the model
code or the checkpoint.  A ``<output>.json`` sidecar records the signature
and provenance.

Signature of the exported function (static shapes, NHWC):

    depth [B, H, W, 1] f32  ->  top-k labels [B, H, W, k] int32

With ``--text_as_input`` the label table is a runtime argument
``(depth, text [C, D] f32)``, so one artifact serves any label set of that
size.

Portability: by default the program is traced on the GPU, so it
holds the hand-written kernels as ``rangeclip::*`` operators: loading it
needs ``rangeclip_tpu_torch`` imported, which registers them.
``--portable`` traces on the CPU, where every kernel runs as its plain
version, so the program is plain ATen with no custom operator.  The JAX
CLI's ``--platforms`` has no counterpart: ``torch.export`` traces for the
device of the example inputs.  ``--verify`` loads the ``.pt2`` and
requires labels bit-identical to the live function on the same device.

Usage:
  python -m rangeclip_tpu_torch.cli.export --checkpoint_path model.pth \\
    --labels_path labels.csv --output model.pt2 \\
    [--batch_size 8 --height 256 --width 256 --top_k 5] \\
    [--predict_path auto|folded|default] [--text_as_input] \\
    [--portable] [--verify]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from rangeclip_tpu_torch.cli import common
from rangeclip_tpu_torch.data.labels import load_candidate_labels
from rangeclip_tpu_torch.utils.device import resolve_device


class PredictProgram(torch.nn.Module):
    """predict as a module for ``torch.export``: ``forward(depth)`` with a
    baked table, or ``forward(depth, text)``."""

    def __init__(self, model: torch.nn.Module, top_k: int, folded: bool,
                 text: Optional[torch.Tensor] = None):
        super().__init__()
        self.model = model
        self.predict = common.make_predict(model, top_k, folded)
        if text is not None:
            self.register_buffer("text", text)
        else:
            self.text = None

    def forward(self, depth: torch.Tensor,
                text: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.predict(depth, self.text if text is None else text)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", default=None,
                        help="reference-format .pth weights; omit with "
                        "--init_random")
    parser.add_argument("--init_random", action="store_true",
                        help="export a randomly initialised model (seed 0; "
                        "smoke tests, no checkpoint needed)")
    parser.add_argument("--labels_path", default=None,
                        help="candidate labels CSV, embedded in the "
                        "artifact with the hash stub")
    parser.add_argument("--num_classes", type=int, default=None,
                        help="class count when --labels_path is omitted "
                        "(requires --text_as_input)")
    parser.add_argument("--output", required=True,
                        help="artifact path (.pt2); a <output>.json "
                        "sidecar records the signature and provenance")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--predict_path", choices=common.PREDICT_PATHS,
                        default="auto", help=common.PREDICT_PATH_HELP)
    parser.add_argument("--text_as_input", action="store_true",
                        help="take the [C, D] text table as a runtime "
                        "argument instead of baking it in")
    parser.add_argument("--portable", action="store_true",
                        help="trace on the CPU: plain ATen, no custom "
                        "operators")
    parser.add_argument("--verify", action="store_true",
                        help="load the artifact and check its labels are "
                        "bit-identical to the live function's")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--encoder_filters", nargs="*", type=int,
                        default=None,
                        help="override the encoder filter widths (must "
                        "match the checkpoint's model)")
    parser.add_argument("--unet_architecture", default="resnet")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    args = parser.parse_args(argv)
    if args.checkpoint_path is None and not args.init_random:
        parser.error("either --checkpoint_path or --init_random is required")
    if args.labels_path is None and args.num_classes is None:
        parser.error("either --labels_path or --num_classes is required")
    if args.labels_path is None and not args.text_as_input:
        parser.error("--num_classes without --labels_path requires "
                     "--text_as_input (there is no table to bake in)")
    return args


def main(argv=None) -> dict:
    """Export (and optionally verify); returns the sidecar."""
    args = parse_args(argv)
    common.set_precision(args.bf16)
    device = resolve_device("cpu" if args.portable else "cuda")
    if args.labels_path is not None:
        labels = load_candidate_labels(args.labels_path)
        num_classes = len(labels)
        text = common.label_table(args, labels, device)
    else:
        num_classes, text = args.num_classes, None

    overrides = ({"encoder_filters": tuple(args.encoder_filters)}
                 if args.encoder_filters else None)
    model = common.load_model(args, device, overrides, args.init_random)
    folded = common.use_folded(args.predict_path, num_classes,
                               args.embedding_dim, args.batch_size,
                               model.compute_dtype, device)
    program = PredictProgram(model, args.top_k, folded,
                             None if args.text_as_input else text).eval()

    depth_shape = (args.batch_size, args.height, args.width, 1)
    example = [torch.zeros(depth_shape, device=device)]
    if args.text_as_input:
        example.append(torch.zeros(num_classes, args.embedding_dim,
                                   device=device))
    with torch.no_grad():
        exported = torch.export.export(program, tuple(example))
    torch.export.save(exported, args.output)
    size = os.path.getsize(args.output)

    sidecar = {
        "format": "torch.export ExportedProgram (.pt2)",
        "torch_version": torch.__version__,
        "device": device.type,
        "inputs": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in example],
        "output": {"shape": [args.batch_size, args.height, args.width,
                             args.top_k], "dtype": "torch.int32"},
        "num_classes": num_classes,
        "embedding_dim": args.embedding_dim,
        "top_k": args.top_k,
        "predict_path": "folded" if folded else "default",
        "text_as_input": bool(args.text_as_input),
        "portable": bool(args.portable),
        "unet_architecture": args.unet_architecture,
        "bf16": bool(args.bf16),
        "bytes": size,
    }
    with open(args.output + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    print(f"Exported {size / 1e6:.2f} MB to {args.output} ({device.type}, "
          f"{sidecar['predict_path']} path"
          f"{', text as input' if args.text_as_input else ''})")

    if args.verify:
        gen = torch.Generator().manual_seed(7)
        call_args = [torch.randn(depth_shape, generator=gen).to(device)]
        if args.text_as_input:
            call_args.append(torch.randn(num_classes, args.embedding_dim,
                                         generator=gen).to(device))
        restored = torch.export.load(args.output).module()
        with torch.no_grad():
            got = restored(*call_args)
            want = program(*call_args)
        if got.shape != want.shape or not torch.equal(got, want):
            raise SystemExit("verify FAILED: the loaded artifact disagrees "
                             "with the live function")
        print(f"verify OK: {got.numel()} labels bit-identical to the live "
              "function")
    return sidecar


if __name__ == "__main__":
    main()
