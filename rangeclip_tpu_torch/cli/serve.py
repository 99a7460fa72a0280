"""Segmentation inference server (port of ``rangeclip_tpu/cli/serve.py``).

Same HTTP API as the JAX server:

  POST /segment     body: 16-bit depth PNG (or float32 .npy)
                    -> JSON {shape, top1: [[ids]], classes_present: {...}}
  POST /segment?raw=1  -> raw int32 top-1 label map bytes
  GET  /healthz     -> {"status": "ok", "device": ..., "resolution": ...}
  GET  /stats       -> request count + latency percentiles

One worker thread owns the model and drains a bounded queue, batching up
to --batch_size requests per device call (the batch is padded to a fixed
shape); HTTP threads only decode and encode.  Weights come from a reference
``.pth`` checkpoint (``--checkpoint_path``), the format that
``python -m rangeclip_tpu.cli.convert --to_pth`` writes.  The device is
``--device`` (default cuda); the CPU is used only when asked for.

``--predict_path``: 'folded' runs ``predict_folded``; 'default' runs the
unfolded ``DepthUNet.predict`` (the ``pixel_text_topk`` kernel on CUDA);
'auto' folds while ``folded_is_profitable`` allows it and otherwise takes
the unfolded path, as the JAX server does.

Labels are embedded by the CLIP text tower when the three ``--clip_*``
flags are given, as in the JAX server, by the deterministic hash stub
otherwise.  Not ported yet: multi-device serving (``--data_parallel``).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rangeclip_tpu_torch.cli import common
from rangeclip_tpu_torch.data.labels import load_candidate_labels
from rangeclip_tpu_torch.data.transforms import depth_transform
from rangeclip_tpu_torch.utils.device import describe_device, resolve_device


def build_engine(args, config_overrides=None):
    """-> (predict, model, labels, device): ``predict(batch)`` maps a
    [B, H, W, 1] float32 numpy batch to [B, H, W, k] int32 ids on the
    device.  ``config_overrides`` adjusts DepthUNetConfig fields beyond
    the flags (a test's narrow widths)."""
    device = resolve_device(args.device)
    labels = load_candidate_labels(args.labels_path)
    model = common.load_model(args, device, config_overrides)
    text_table = common.label_table(args, labels, device)
    folded = common.use_folded(args.predict_path, len(labels),
                               args.embedding_dim, args.batch_size,
                               model.compute_dtype, device)
    predict_ids = common.make_predict(model, args.top_k, folded)

    def predict(batch: np.ndarray) -> torch.Tensor:
        # grad mode is per thread: the worker thread sets its own
        with torch.inference_mode():
            depth = torch.from_numpy(batch).to(device)
            return predict_ids(depth, text_table)

    # warm up once so the first request pays no one-time cost
    # (kernel build, cuDNN algorithm choice)
    predict(np.zeros((args.batch_size, args.height, args.width, 1),
                     np.float32))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return predict, model, labels, device


class Engine:
    """Device worker: drains the queue, micro-batches up to batch_size."""

    def __init__(self, predict, batch_size, size):
        self.predict = predict
        self.batch_size = batch_size
        self.size = size
        self.queue: "queue.Queue" = queue.Queue(maxsize=64)
        self.latencies = []
        self.count = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, depth_hw: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot = {}
        self.queue.put((depth_hw, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["topk"]

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker after the requests already queued."""
        self.queue.put(None)
        self._thread.join(timeout)

    def _complete(self, dev_topk, items, t0):
        try:
            topk = dev_topk.cpu().numpy()  # waits for the device
            for i, (_, slot, done) in enumerate(items):
                slot["topk"] = topk[i]
                done.set()
        except Exception as e:  # surface device errors to the client
            for _, slot, done in items:
                slot["error"] = str(e)
                done.set()
        self.count += len(items)
        self.latencies.append(time.perf_counter() - t0)
        if len(self.latencies) > 1000:
            del self.latencies[:500]

    def _worker(self):
        # One batch in flight: batch N's device-to-host copy happens after
        # batch N+1 is queued on the device, so under load the copy
        # overlaps the next batch's compute.  When the queue is idle (2 ms
        # poll) the pending batch completes at once.
        pending = None  # (device topk, items, t0)
        while True:
            first = None
            if pending is None:
                first = self.queue.get()
            else:
                try:
                    first = self.queue.get(timeout=0.002)
                except queue.Empty:
                    self._complete(*pending)
                    pending = None
                    continue
            if first is None:  # close()
                if pending is not None:
                    self._complete(*pending)
                return
            items = [first]
            while len(items) < self.batch_size:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self.queue.put(None)  # stop after this batch
                    break
                items.append(item)
            t0 = time.perf_counter()
            try:
                batch = np.zeros((self.batch_size, *self.size, 1), np.float32)
                for i, (d, _, _) in enumerate(items):
                    batch[i, :, :, 0] = d
                dev_topk = self.predict(batch)  # asynchronous on CUDA
            except Exception as e:
                for _, slot, done in items:
                    slot["error"] = str(e)
                    done.set()
                continue  # the pending batch is unaffected
            if pending is not None:
                self._complete(*pending)
            pending = (dev_topk, items, t0)


def make_handler(engine: Engine, labels, size, device: torch.device):
    device_name = describe_device(device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, json.dumps({
                    "status": "ok",
                    "device": device_name,
                    "resolution": list(size),
                    "num_classes": len(labels),
                }).encode())
            elif self.path.startswith("/stats"):
                lat = sorted(engine.latencies) or [0.0]
                self._send(200, json.dumps({
                    "requests": engine.count,
                    "p50_ms": round(1e3 * lat[len(lat) // 2], 2),
                    "p95_ms": round(1e3 * lat[int(len(lat) * 0.95)], 2),
                }).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith("/segment"):
                self._send(404, b'{"error": "not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if raw[:6] == b"\x93NUMPY":
                    depth = np.load(io.BytesIO(raw)).astype(np.float32)
                else:
                    from PIL import Image  # only PNG bodies need it

                    depth = np.asarray(
                        Image.open(io.BytesIO(raw)).convert("I"), np.float32)
                depth = depth_transform(depth, size)
                topk = engine.submit(depth)
                top1 = topk[:, :, 0].astype(np.int32)
                if "raw=1" in (self.path.split("?", 1) + [""])[1]:
                    self._send(200, top1.tobytes(),
                               "application/octet-stream")
                    return
                present = [int(c) for c in np.unique(top1)]
                self._send(200, json.dumps({
                    "shape": list(top1.shape),
                    "top1": top1.tolist(),
                    "classes_present": {
                        str(c): labels[c] for c in present
                        if 0 <= c < len(labels)
                    },
                }).encode())
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True,
                        help="reference-format .pth weights")
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8477)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    # /segment exposes only the top-1 map, and top-1 of a top-k is the
    # argmax, so k=1 by default.
    parser.add_argument("--top_k", type=int, default=1)
    parser.add_argument("--predict_path", choices=common.PREDICT_PATHS,
                        default="auto", help=common.PREDICT_PATH_HELP)
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--unet_architecture", default="resnet")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; nothing falls back")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    common.set_precision(args.bf16)
    predict, _, labels, device = build_engine(args)
    size = (args.height, args.width)
    engine = Engine(predict, args.batch_size, size)

    class Server(ThreadingHTTPServer):
        # The default backlog (5) drops bursty clients; the bounded engine
        # queue is the real admission control.
        request_queue_size = 128

    server = Server((args.host, args.port),
                    make_handler(engine, labels, size, device))
    print(f"Serving on http://{args.host}:{args.port} "
          f"(batch {args.batch_size} @ {args.height}x{args.width}, "
          f"{describe_device(device)})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
