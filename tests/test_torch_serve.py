"""The port's inference server on the CPU, against JAX ``predict_folded``
and ``DepthUNet.predict``, and its host helpers against the JAX
package's."""

import argparse
import csv
import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.data.labels import (
    load_candidate_labels as jax_load_candidate_labels,
)
from rangeclip_tpu.data.transforms import depth_transform as jax_depth_transform
from rangeclip_tpu.models.clip.provider import (
    HashTextEmbedder as JaxHashTextEmbedder,
)
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import predict_folded as jax_predict_folded
from rangeclip_tpu_torch.cli import common, serve
from rangeclip_tpu_torch.data.labels import load_candidate_labels
from rangeclip_tpu_torch.data.transforms import depth_transform
from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder
from rangeclip_tpu_torch.models.interop import save_reference_pth
from test_torch_model import DIM, FILTERS, jax_and_port

SIZE = (32, 32)
K = 3


def _write_labels(path, n):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["label", "index"])
        for i in range(n, 0, -1):  # unsorted on disk
            writer.writerow([f"class, number {i}", i])
    return str(path)


def _args(tmp_path, **kw):
    base = dict(checkpoint_path=str(tmp_path / "m.pth"),
                labels_path=str(tmp_path / "labels.csv"), batch_size=2,
                height=SIZE[0], width=SIZE[1], top_k=K, embedding_dim=DIM,
                unet_architecture="resnet", bf16=False,
                predict_path="folded", device="cpu",
                clip_checkpoint_path=None, clip_vocab_path=None,
                clip_merges_path=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_serve_end_to_end_matches_jax(tmp_path, monkeypatch):
    # the JAX package's numpy transform (its C++ one multiplies by 1/median,
    # one ulp from the division the reference and the port do)
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    model, v, port = jax_and_port()
    save_reference_pth(port, str(tmp_path / "m.pth"))
    _write_labels(tmp_path / "labels.csv", 12)
    predict, _, labels, device = serve.build_engine(
        _args(tmp_path), config_overrides={"encoder_filters": FILTERS})
    assert len(labels) == 13 and device.type == "cpu"
    engine = serve.Engine(predict, 2, SIZE)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve.make_handler(engine, labels, SIZE, device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port_num = server.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port_num, timeout=60)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()

    try:
        status, body = request("GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["device"] == "cpu"
        assert health["num_classes"] == 13

        rng = np.random.default_rng(0)
        depths = [rng.random((48, 64)).astype(np.float32) * 5,
                  rng.random((32, 32)).astype(np.float32) + 1]
        top1 = []
        for depth in depths:
            buf = io.BytesIO()
            np.save(buf, depth)
            status, body = request("POST", "/segment", buf.getvalue())
            out = json.loads(body)
            assert status == 200 and out["shape"] == list(SIZE)
            ids = np.asarray(out["top1"])
            assert ((ids >= 0) & (ids < 13)).all()
            assert all(out["classes_present"].values())
            top1.append(ids)
        status, body = request("POST", "/segment", b"garbage")
        assert status == 400 and "error" in json.loads(body)
        assert request("GET", "/stats")[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(5)
    assert not thread.is_alive() and not engine._thread.is_alive()

    # JAX on the same transformed depth, weights and label table
    batch = np.stack([jax_depth_transform(d, SIZE) for d in depths])
    table = JaxHashTextEmbedder(dim=DIM)(jax_load_candidate_labels(
        str(tmp_path / "labels.csv")))
    want = np.asarray(jax.jit(lambda v, x, t: jax_predict_folded(
        model, v, x, t, top_k=K))(v, jnp.asarray(batch[..., None]),
                                   jnp.asarray(table)))[..., 0]
    got = np.stack(top1)
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if not agree.all():  # near-ties only
        field = port(torch.from_numpy(batch))[0].detach()
        text = torch.nn.functional.normalize(torch.from_numpy(table), dim=-1)
        logits = torch.einsum("bhwd,cd->bhwc", field, text).numpy()
        g = np.take_along_axis(logits, got[..., None], -1)[..., 0]
        w = np.take_along_axis(logits, want[..., None], -1)[..., 0]
        np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


@pytest.mark.parametrize("predict_path", ["default", "auto"])
def test_serve_unfolded_paths_match_jax(tmp_path, monkeypatch,
                                        predict_path):
    """'default', and 'auto' where the class count exceeds the folding
    crossover (13 classes pad to 128 slots > 1.5 * 32), answer through the
    engine with the unfolded DepthUNet.predict; labels against JAX predict
    on the same weights: >= 99.9% agreement, mismatches near-ties."""
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")  # the numpy transform
    model, v, port = jax_and_port()
    save_reference_pth(port, str(tmp_path / "m.pth"))
    _write_labels(tmp_path / "labels.csv", 12)
    args = _args(tmp_path, predict_path=predict_path)
    assert not common.use_folded(predict_path, 13, DIM, args.batch_size,
                                 torch.float32, torch.device("cpu"))
    predict, _, labels, _ = serve.build_engine(
        args, config_overrides={"encoder_filters": FILTERS})
    engine = serve.Engine(predict, 2, SIZE)
    rng = np.random.default_rng(5)
    depths = [rng.random((48, 64)).astype(np.float32) * 5 for _ in range(3)]
    try:
        got = np.stack([engine.submit(depth_transform(d, SIZE))
                        for d in depths])
    finally:
        engine.close()
    assert got.shape == (3, *SIZE, K) and got.dtype == np.int32

    batch = np.stack([jax_depth_transform(d, SIZE) for d in depths])
    table = JaxHashTextEmbedder(dim=DIM)(jax_load_candidate_labels(
        str(tmp_path / "labels.csv")))
    want = np.asarray(jax.jit(lambda v, x, t: model.apply(
        v, x, t, jnp.ones(len(t), bool), K, method=JaxDepthUNet.predict,
        return_embeddings=False)[0])(v, jnp.asarray(batch[..., None]),
                                      jnp.asarray(table)))
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if not agree.all():  # near-ties only
        field = port(torch.from_numpy(batch))[0].detach()
        text = torch.nn.functional.normalize(torch.from_numpy(table), dim=-1)
        logits = torch.einsum("bhwd,cd->bhwc", field, text).numpy()
        g = np.take_along_axis(logits, got, -1)
        w = np.take_along_axis(logits, want, -1)
        np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


def test_host_helpers_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")  # the numpy transform
    path = _write_labels(tmp_path / "labels.csv", 7)
    assert load_candidate_labels(path) == jax_load_candidate_labels(path)
    bad = tmp_path / "bad.csv"
    bad.write_text("label,index\na,1\nb,3\n")
    with pytest.raises(ValueError, match="1-based"):
        load_candidate_labels(str(bad))

    rng = np.random.default_rng(1)
    for shape, size in [((48, 64), (32, 32)), ((30, 17), (32, 32)),
                        ((32, 32), (32, 32)), ((7, 9), (16, 12))]:
        depth = rng.random(shape).astype(np.float32) * 10
        np.testing.assert_array_equal(depth_transform(depth, size),
                                      jax_depth_transform(depth, size))
    zeros = np.zeros((10, 10), np.float32)
    np.testing.assert_array_equal(depth_transform(zeros, (4, 4)),
                                  jax_depth_transform(zeros, (4, 4)))

    labels = ["unavailable", "chair", "table", "a, b"]
    np.testing.assert_array_equal(HashTextEmbedder(dim=DIM)(labels),
                                  JaxHashTextEmbedder(dim=DIM)(labels))
