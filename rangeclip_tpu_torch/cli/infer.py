"""Streaming segmentation inference CLI (port of ``rangeclip_tpu/cli/infer.py``).

Depth PNGs stream through a host prefetch thread (decode + median-normalise
resize), the device runs predict on fixed-shape batches (the tail is padded
with copies of its first map), and a writer thread saves, per map,
``{name}_topk.npy`` ([H, W, k] int32), ``{name}_labels.png`` (top-1 ids)
and with ``--save_preview`` a colourised ``{name}_preview.png``.  One batch
is in flight: batch N+1 is queued on the device before batch N's result is
copied back.

Weights come from a reference ``.pth`` (``--checkpoint_path``, the file
``python -m rangeclip_tpu.cli.convert --to_pth`` writes) instead of the
JAX CLI's orbax ``--checkpoint_dir``; the device is ``--device`` (default
cuda).  Labels are embedded by the CLIP text tower when the three
``--clip_*`` flags are given, by the deterministic hash stub otherwise.

Usage:
  python -m rangeclip_tpu_torch.cli.infer --checkpoint_path model.pth \\
    --depth_glob 'data/*_depth.png' --labels_path labels.csv \\
    --output_dir out [--batch_size 8 --height 256 --width 256]
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import threading
import time

import numpy as np
import torch

from rangeclip_tpu_torch.cli import common
from rangeclip_tpu_torch.data.dataset import open_gray
from rangeclip_tpu_torch.data.labels import load_candidate_labels
from rangeclip_tpu_torch.data.transforms import depth_transform
from rangeclip_tpu_torch.utils.device import describe_device, resolve_device
from rangeclip_tpu_torch.utils.visualization import (
    colorize_segmentation,
    label_colors,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True,
                        help="reference-format .pth weights")
    parser.add_argument("--depth_glob", required=True)
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--predict_path", choices=common.PREDICT_PATHS,
                        default="auto", help=common.PREDICT_PATH_HELP)
    parser.add_argument("--num_negatives", type=int, default=300,
                        help="unused: open-set inference scores every "
                        "class (kept for the JAX CLI's flag set)")
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
    parser.add_argument("--save_preview", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; nothing falls back")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Segment every map matched by ``--depth_glob``; returns the count."""
    args = parse_args(argv)
    from PIL import Image

    common.set_precision(args.bf16)
    device = resolve_device(args.device)
    labels = load_candidate_labels(args.labels_path)
    num_classes = len(labels)
    text = common.label_table(args, labels, device)
    overrides = ({"encoder_filters": tuple(args.encoder_filters)}
                 if args.encoder_filters else None)
    model = common.load_model(args, device, overrides)
    folded = common.use_folded(args.predict_path, num_classes,
                               args.embedding_dim, args.batch_size,
                               model.compute_dtype, device)
    predict = common.make_predict(model, args.top_k, folded)

    paths = sorted(glob.glob(args.depth_glob))
    os.makedirs(args.output_dir, exist_ok=True)
    colors = label_colors(num_classes)
    size = (args.height, args.width)

    q: "queue.Queue" = queue.Queue(maxsize=4)
    sentinel = object()
    producer_error = []

    def producer():
        try:
            batch, names = [], []
            for p in paths:
                depth = open_gray(p).astype(np.float32)
                batch.append(depth_transform(depth, size)[..., None])
                names.append(os.path.splitext(os.path.basename(p))[0])
                if len(batch) == args.batch_size:
                    q.put((np.stack(batch), names))
                    batch, names = [], []
            if batch:  # pad the tail to the fixed shape
                batch += [batch[0]] * (args.batch_size - len(batch))
                q.put((np.stack(batch), names))
        except Exception as e:  # surfaced below; the sentinel always lands
            producer_error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    # Writer thread: PNG/npy encoding overlaps the next batch's device work.
    out_q: "queue.Queue" = queue.Queue(maxsize=4)
    n_done = 0
    writer_error = []

    def writer():
        nonlocal n_done
        while True:
            item = out_q.get()
            if item is sentinel:
                return
            if writer_error:  # drain after a failure so the main loop
                continue      # never blocks on a full queue
            topk, names = item
            try:
                for i, name in enumerate(names):
                    top1 = topk[i, :, :, 0]
                    np.save(os.path.join(args.output_dir, f"{name}_topk.npy"),
                            topk[i])
                    Image.fromarray(top1.astype(np.int32)).save(
                        os.path.join(args.output_dir, f"{name}_labels.png"))
                    if args.save_preview:
                        rgb = (colorize_segmentation(top1, colors)
                               * 255).astype(np.uint8)
                        Image.fromarray(rgb).save(os.path.join(
                            args.output_dir, f"{name}_preview.png"))
                n_done += len(names)
            except Exception as e:  # surfaced after the join; keep draining
                writer_error.append(e)

    # Daemon: a crash in the main loop must not leave the process hung on a
    # writer blocked in out_q.get().
    writer_thread = threading.Thread(target=writer, daemon=True)
    writer_thread.start()

    # One batch in flight: queue batch N+1 on the device (asynchronous on
    # CUDA) before copying batch N back, so compute overlaps the copy.
    t0 = time.perf_counter()
    pending = None
    try:
        with torch.inference_mode():
            while True:
                item = q.get()
                if item is sentinel:
                    break
                depth_batch, names = item
                dev_topk = predict(torch.from_numpy(depth_batch).to(device),
                                   text)
                if pending is not None:
                    out_q.put((pending[0].cpu().numpy(), pending[1]))
                pending = (dev_topk, names)
            if pending is not None:
                out_q.put((pending[0].cpu().numpy(), pending[1]))
    finally:
        out_q.put(sentinel)
        writer_thread.join()
    if producer_error:
        raise producer_error[0]
    if writer_error:
        raise writer_error[0]
    dt = time.perf_counter() - t0
    print(f"Segmented {n_done} depth maps in {dt:.2f}s "
          f"({n_done / max(dt, 1e-9):.1f} maps/s, "
          f"{'folded' if folded else 'default'} path, "
          f"{describe_device(device)})")
    return n_done


if __name__ == "__main__":
    main()
