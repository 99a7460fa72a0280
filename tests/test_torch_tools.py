"""The port's small tools against the JAX package's on the CPU: checkpoint
migration (``cli/convert``) in both directions, ``utils/depth_io``,
``utils/eval_utils``, ``losses/weighted``, ``utils/monitoring`` and
``utils/roofline`` (its JAX functions on the same records, conv FLOPs of a
traced model forward, and the FLOP formulas of the port's operators).

Tolerances: the numpy copies are held exactly; the weighted losses' values
at rtol 1e-6 and their gradients against ``jax.grad`` at rtol 1e-5; labels
of the imported model against JAX's ``predict(scoring="xla")`` exactly.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rangeclip_tpu.losses import weighted as jax_weighted
from rangeclip_tpu.models.torch_interop import (
    load_reference_checkpoint,
    save_reference_checkpoint,
)
from rangeclip_tpu.utils import depth_io as jax_depth_io
from rangeclip_tpu.utils import eval_utils as jax_eval_utils
from rangeclip_tpu.utils import monitoring as jax_monitoring
from rangeclip_tpu.utils import roofline as jax_roofline
from rangeclip_tpu_torch.cli import convert, train
from rangeclip_tpu_torch.data import synthetic
from rangeclip_tpu_torch.losses import weighted
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.utils import depth_io, eval_utils, monitoring
from rangeclip_tpu_torch.utils import roofline
from rangeclip_tpu_torch.utils.profiling import WINDOW
from test_torch_model import DIM, FILTERS, jax_and_port

STEP = 3
FILTER_ARGS = [str(f) for f in FILTERS]


@pytest.fixture(scope="module")
def jax_pth(tmp_path_factory):
    """A tiny JAX model's reference .pth at train step 3, its JAX model and
    variables."""
    model, v, _ = jax_and_port()
    path = str(tmp_path_factory.mktemp("jax") / "model.pth")
    save_reference_checkpoint(v["params"], v["batch_stats"], path,
                              train_step=STEP)
    return model, v, path


def test_convert_from_jax_pth_resumes_and_predicts_as_jax(jax_pth, tmp_path):
    """--from_pth writes a resumable checkpoint at the .pth's step with
    fresh Adam state; cli/train resumes from it at that step under its own
    weight decay; the restored model's fp32 labels equal JAX's
    predict(scoring="xla") exactly."""
    model, v, path = jax_pth
    out = convert.main(["--from_pth", path, "--checkpoint_path",
                        str(tmp_path / "imported"), "--device", "cpu",
                        "--embedding_dim", str(DIM), "--encoder_filters",
                        *FILTER_ARGS])
    assert sorted(os.listdir(out)) == [
        f"depth_segmentation_model-{STEP}.pth", f"optimizer-{STEP}.pt"]
    saved = torch.load(os.path.join(out, f"optimizer-{STEP}.pt"),
                       weights_only=True)
    assert saved["step"] == STEP and not saved["optimizer"]["state"]

    state = create_train_state(
        DepthUNetConfig(encoder_filters=FILTERS, embedding_dim=DIM),
        torch.device("cpu"))
    CheckpointManager(out).restore(state)
    assert state.step == STEP
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    text = rng.standard_normal((20, DIM)).astype(np.float32)
    mask = np.ones(20, bool)
    mask[[3, 11]] = False
    got, _, _ = state.model.eval().predict(
        torch.from_numpy(x), torch.from_numpy(text), torch.from_numpy(mask),
        5, scoring="xla")
    want = jax.jit(lambda v, x, t, m: model.apply(
        v, x, t, m, 5, method=type(model).predict, scoring="xla")[0])(
            v, jnp.asarray(x), jnp.asarray(text), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    data = synthetic.write_synthetic_dataset(
        str(tmp_path / "data"), n_samples=16, shape=(32, 32), num_classes=8)
    ckpt = tmp_path / "resumed"
    train.main(["--labeled_metadata_path", data["metadata"],
                "--labels_path", data["labels"],
                "--equivalence_dict_path", data["similarity"],
                "--checkpoint_path", str(ckpt),
                "--unet_architecture", "resnet", "--batch_size", "2",
                "--n_height", "32", "--n_width", "32",
                "--learning_rates", "1e-3", "--learning_schedule", "2",
                "--accumulation_steps", "2", "--embedding_dim", str(DIM),
                "--encoder_filters", *FILTER_ARGS, "--device", "cpu",
                "--restore_path_model", out, "--max_steps", str(STEP + 1),
                "--w_weight_decay", "1e-4"])
    log = open(ckpt / "results.txt").read()
    assert f"Restored checkpoint at step {STEP}." in log
    assert os.path.exists(ckpt / "checkpoints"
                          / f"depth_segmentation_model-{STEP + 1}.pth")
    # the resumed run's optimizer flags, not the imported fresh state's
    resumed = torch.load(ckpt / "checkpoints" / f"optimizer-{STEP + 1}.pt",
                         weights_only=True)["optimizer"]
    assert resumed["param_groups"][0]["weight_decay"] == 1e-4
    assert resumed["state"]


def test_convert_to_pth_loads_in_jax_bit_equal(jax_pth, tmp_path):
    """A port checkpoint directory -> --to_pth -> the JAX package's
    load_reference_checkpoint: every parameter and statistic bit-equal."""
    _, v, _ = jax_pth
    state = create_train_state(
        DepthUNetConfig(encoder_filters=FILTERS, embedding_dim=DIM),
        torch.device("cpu"))
    state.model.load_state_dict(state_dict_from_jax(
        v["params"], v["batch_stats"]), strict=True)
    state.step = 7
    CheckpointManager(str(tmp_path / "ckpt")).save(state)
    path = str(tmp_path / "exported.pth")
    convert.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--to_pth",
                  path, "--device", "cpu"])
    params, stats, step = load_reference_checkpoint(path)
    assert step == 7
    for want, got in ((v["params"], params), (v["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for key, leaf in flat_w:
            np.testing.assert_array_equal(
                np.asarray(flat_g[key]).reshape(np.shape(leaf)),
                np.asarray(leaf), err_msg=str(key))


@pytest.mark.parametrize("flag,value", [("--embedding_dim", "64"),
                                        ("--unet_architecture", "mit")])
def test_convert_refuses_a_mismatch(jax_pth, tmp_path, flag, value):
    _, _, path = jax_pth
    argv = ["--from_pth", path, "--checkpoint_path", str(tmp_path),
            "--device", "cpu", "--embedding_dim", str(DIM),
            "--encoder_filters", *FILTER_ARGS, flag, value]
    with pytest.raises(SystemExit, match=f"{flag} {value} against the "
                                         "weights'"):
        convert.main(argv)
    assert not os.path.exists(tmp_path / "checkpoints")


def test_depth_io_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    z = rng.uniform(0, 80, (12, 17)).astype(np.float32)
    z[2:4, 5:9] = 0.0
    for writer, reader in ((depth_io.save_depth, jax_depth_io.load_depth),
                           (jax_depth_io.save_depth, depth_io.load_depth)):
        path = str(tmp_path / f"{writer.__module__}.png")
        writer(z, path, multiplier=256.0)
        np.testing.assert_array_equal(reader(path), jax_depth_io.load_depth(
            path))
        np.testing.assert_array_equal(depth_io.load_validity_map(path),
                                      jax_depth_io.load_validity_map(path))
    np.testing.assert_array_equal(depth_io.validity_map_from_depth(z),
                                  jax_depth_io.validity_map_from_depth(z))
    paths = ["a/b.png", "", "c.png  "]
    depth_io.write_paths(str(tmp_path / "p.txt"), paths)
    assert depth_io.read_paths(str(tmp_path / "p.txt")) == \
        jax_depth_io.read_paths(str(tmp_path / "p.txt")) == ["a/b.png",
                                                             "c.png"]
    (tmp_path / "vild.json").write_text(json.dumps(
        {"categories": [{"name": "chair", "id": 1},
                        {"name": "table", "id": 2}]}))
    assert depth_io.load_vild_categories(str(tmp_path / "vild.json")) == \
        jax_depth_io.load_vild_categories(str(tmp_path / "vild.json"))


def test_eval_utils_match_jax():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((7, 16)).astype(np.float32)
    tgt = rng.standard_normal((7, 16)).astype(np.float32)
    src, ref = rng.uniform(0.5, 9, (2, 4, 9)).astype(np.float32)
    assert eval_utils.info_nce_np(emb, tgt) == \
        jax_eval_utils.info_nce_np(emb, tgt)
    assert eval_utils.info_nce_np(emb, tgt, 0.5) == \
        jax_eval_utils.info_nce_np(emb, tgt, 0.5)
    for name in ("root_mean_sq_err", "mean_abs_err", "inv_root_mean_sq_err",
                 "inv_mean_abs_err"):
        assert getattr(eval_utils, name)(src, ref) == \
            getattr(jax_eval_utils, name)(src, ref), name


@pytest.mark.parametrize("name,normalize", [
    ("weighted_l1_loss", False), ("weighted_l1_loss", True),
    ("weighted_l2_loss", False), ("weighted_l2_loss", True),
    ("smoothness_loss_weighted", False)])
def test_weighted_losses_match_jax(name, normalize):
    """Values at rtol 1e-6, gradients against jax.grad at rtol 1e-5; the
    L1/L2 weight [N, H, W, 1] against a [N, H, W, 3] loss, summed
    unbroadcast in the denominator as the reference does."""
    rng = np.random.default_rng(2)
    src = rng.standard_normal((3, 6, 5, 3)).astype(np.float32)
    tgt = rng.standard_normal((3, 6, 5, 3)).astype(np.float32)
    w = (rng.random((3, 6, 5, 1)) > 0.3).astype(np.float32)
    if name == "smoothness_loss_weighted":
        ours = lambda s: weighted.smoothness_loss_weighted(  # noqa: E731
            s, torch.from_numpy(tgt))
        theirs = lambda s: jax_weighted.smoothness_loss_weighted(  # noqa
            s, jnp.asarray(tgt))
    else:
        ours = lambda s: getattr(weighted, name)(  # noqa: E731
            s, torch.from_numpy(tgt), torch.from_numpy(w), normalize)
        theirs = lambda s: getattr(jax_weighted, name)(  # noqa: E731
            s, jnp.asarray(tgt), jnp.asarray(w), normalize)
    x = torch.from_numpy(src).requires_grad_()
    value = ours(x)
    value.backward()
    want, grad = jax.value_and_grad(theirs)(jnp.asarray(src))
    np.testing.assert_allclose(value.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-7)
    if name != "smoothness_loss_weighted":  # the default all-ones weight
        np.testing.assert_allclose(
            getattr(weighted, name)(torch.from_numpy(src),
                                    torch.from_numpy(tgt)).item(),
            float(getattr(jax_weighted, name)(jnp.asarray(src),
                                              jnp.asarray(tgt))), rtol=1e-6)


def _quiet(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def test_monitoring_matches_jax():
    """validate_tensor's stats dict and message, contains_nan, StepTimer,
    a trace of no directory, and no device memory on the CPU."""
    x = np.array([[1.0, np.nan, 3e9], [np.inf, -2.0, 0.5]], np.float32)
    for arr in (x, np.arange(6, dtype=np.float32), np.zeros(0, np.float32)):
        got = _quiet(lambda: monitoring.validate_tensor(
            torch.from_numpy(arr), "t"))
        want = _quiet(lambda: jax_monitoring.validate_tensor(
            jnp.asarray(arr), "t"))
        assert got == want
    with pytest.raises(FloatingPointError) as ours:
        monitoring.validate_tensor(torch.from_numpy(x), "t",
                                   raise_on_error=True)
    with pytest.raises(FloatingPointError) as theirs:
        jax_monitoring.validate_tensor(jnp.asarray(x), "t",
                                       raise_on_error=True)
    assert str(ours.value) == str(theirs.value)
    assert monitoring.contains_nan(torch.from_numpy(x)) is True
    assert monitoring.contains_nan(torch.ones(3)) is False
    timer = monitoring.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop()
    assert len(timer.times) == 2 and timer.mean >= 0 and timer.p50 >= 0
    with monitoring.device_trace(None) as written:
        assert written == []
    assert monitoring.log_device_usage(log_fn=lambda _: None) == {}


def _records(seed):
    rng = np.random.default_rng(seed)
    names = [f"k{i}" for i in range(9)]
    ops = ["encoder/aten::convolution", "decoder/aten::mm",
           "rangeclip::pixel_text_ce", "rangeclip::tv_rowtile", "x/y",
           "head/rangeclip::score_topk", "encoder/aten::add", "", "z"]
    trace = [(n, float(rng.uniform(0.01, 3)), op)
             for n, op in zip(names, ops)]
    instrs = {n: {"bytes": float(rng.uniform(1e6, 1e9)),
                  "flops": float(rng.uniform(0, 1e12)), "op": op}
              for n, (_, _, op) in zip(names, trace)}
    return trace, instrs


@pytest.mark.parametrize("seed", [0, 1])
def test_roofline_tables_match_jax(seed):
    trace, instrs = _records(seed)
    kernel = {"k2": 5e11}
    for kf in (None, kernel):
        ours = roofline.roofline_rows(trace, instrs, 989e12, 3.35e12, kf)
        theirs = jax_roofline.roofline_rows(trace, instrs, 989e12, 3.35e12,
                                            kf)
        assert ours == theirs
        got = roofline.bucket_rows(ours, roofline.BUCKETS)
        assert got == jax_roofline.bucket_rows(theirs, roofline.BUCKETS)
        assert [b["interval"] for b in got] == [
            "CE", "TV", "head/selection", "encoder", "decoder", "other"]
        total = sum(ms for _, ms, _ in trace)
        assert roofline.format_interval_table(got, total) == \
            jax_roofline.format_interval_table(got, total)


def test_records_from_profile_conv_flops():
    """records_from_profile's FLOPs of a tiny DepthUNet forward (CPU
    operator events, shapes recorded) are the convolutions' 2·MAC, counted
    in the test from each conv's input, weight and output shapes, plus the
    ASPP pooling branch's linear, with the events' input dtypes or without
    them; the encoder's and decoder's operators fall in their buckets."""
    model = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=DIM),
                      generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    want = []
    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def counting_conv(inp, w, *args, **kwargs):
        out = conv2d(inp, w, *args, **kwargs)
        want.append(2 * out.shape[0] * out.shape[2] * out.shape[3]
                    * w.numel())
        return out

    def counting_conv_t(inp, w, *args, **kwargs):
        want.append(2 * inp.shape[0] * inp.shape[2] * inp.shape[3]
                    * w.numel())
        return conv_t(inp, w, *args, **kwargs)

    with torch.no_grad():
        F.conv2d, F.conv_transpose2d = counting_conv, counting_conv_t
        try:
            model(x)
        finally:
            F.conv2d, F.conv_transpose2d = conv2d, conv_t
        with roofline.label_modules({"encoder": model.encoder,
                                     "decoder": model.decoder}):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU],
                    record_shapes=True) as prof:
                with torch.profiler.record_function(WINDOW):
                    model(x)
    trace, instrs = roofline.records_from_profile(prof, device="cpu")
    # a torch whose FunctionEvent keeps no input dtypes (2.11): the same
    # records from the kineto events'
    for e in prof.events():
        e.input_dtypes = None
    assert roofline.records_from_profile(prof, device="cpu") == (trace,
                                                                 instrs)
    conv = sum(r["flops"] for r in instrs.values()
               if r["op"].endswith("aten::convolution"))
    assert len(want) > 20 and conv == sum(want)
    linear = sum(r["flops"] for r in instrs.values()
                 if r["op"].endswith("aten::linear"))
    assert conv + linear == sum(r["flops"] for r in instrs.values())
    rows = roofline.roofline_rows(trace, instrs, 67e12, 3.35e12)
    buckets = {b["interval"]: b for b in roofline.bucket_rows(
        rows, roofline.BUCKETS)}
    assert buckets["encoder"]["gflop"] > 0 and \
        buckets["decoder"]["gflop"] > 0
    np.testing.assert_allclose(sum(b["ms"] for b in buckets.values()),
                               sum(ms for _, ms, _ in trace), rtol=1e-9)


def _operator_args():
    """Arguments of each port operator at small shapes (live classes and
    members masked out where the cost counts only the live ones)."""
    gen = torch.Generator().manual_seed(3)
    ids = torch.arange(16, dtype=torch.int32)
    ids[[2, 5, 9]] = -1
    mask = (ids >= 0).to(torch.int32)
    feats = torch.randn(2, 4, 4, 8, generator=gen)
    field = torch.randn(12, 16, generator=gen)
    labels = torch.randint(0, 16, (4, 12), generator=gen, dtype=torch.int32)
    valid = torch.ones(4, 12)
    ce = (field, torch.tensor(0.07), labels, valid, field[:16].clone(),
          mask, None, None, None, None)
    # past 4 slots: 16 label slots
    ce16 = (field, torch.tensor(0.07), labels.repeat(4, 1), valid.repeat(4, 1),
            field[:16].clone(), mask, None, None, None, None)
    return {
        "rangeclip::score_topk": (torch.randn(12, 16, generator=gen), ids,
                                  3, False, False),
        "rangeclip::conv_score_topk": (feats.bfloat16(),
                                       torch.randn(16, 72).bfloat16(), ids,
                                       3, False),
        "rangeclip::class_presence": (labels.reshape(-1), None, 16),
        "rangeclip::pixel_text_topk": (field, torch.randn(16, 16), ids, 3,
                                       True),
        "rangeclip::l2_normalize": (field,),
        "rangeclip::l2_normalize_backward": (field, field),
        "rangeclip::histogram": (labels, 16),
        "rangeclip::pixel_text_ce": ce,
        "rangeclip::pixel_text_ce_backward": (torch.tensor(1.0),
                                              torch.zeros(2, 12)) + ce,
        "rangeclip::pixel_text_ce_slots": ce16,
        "rangeclip::pixel_text_ce_slots_backward": (torch.tensor(1.0),
                                                    torch.zeros(2, 12))
        + ce16,
        "rangeclip::tv_rowtile": (feats, None, 2),
        "rangeclip::tv_rowtile_backward": (feats, None, torch.tensor(1.0),
                                           2),
        "rangeclip::masked_pooling": (field, labels[0], ids[:6]),
        "rangeclip::head_topk": (feats, torch.randn(72, 16),
                                 torch.randn(16, 16), mask, 3),
        "rangeclip::tv_loss": (feats, 8),
        "rangeclip::tv_loss_backward": (feats, torch.tensor(1.0), 8),
    }


@pytest.mark.parametrize("name", sorted(roofline.OP_COSTS))
def test_flop_formula_is_the_cost_tables(name):
    """The FLOP formula registered for each port operator gives the cost
    table's FLOPs, which count only the live classes and CE members; its
    bytes are the Bound column's."""
    from torch.utils import flop_counter

    roofline.register_flop_formulas()
    args = _operator_args()[name]
    packet = getattr(torch.ops.rangeclip, name.split("::")[1])
    flops = flop_counter.flop_registry[packet](*args, out_val=None)
    assert flops == roofline.OP_COSTS[name](*args)[1]
    live = 13  # of the 16 classes
    expected = {"rangeclip::conv_score_topk": 2 * 32 * 9 * 8 * live,
                "rangeclip::pixel_text_topk": 2 * 12 * 16 * live,
                "rangeclip::pixel_text_ce": 2 * 12 * live * 16,
                "rangeclip::pixel_text_ce_backward": 4 * 12 * live * 16,
                "rangeclip::pixel_text_ce_slots": 2 * 12 * live * 16,
                "rangeclip::pixel_text_ce_slots_backward": (
                    4 * 12 * live * 16),
                "rangeclip::masked_pooling": 12 * 16,
                "rangeclip::head_topk": 2 * 32 * (72 * 16 + 16 * live)}
    assert flops == expected.get(name, 0)
    # bytes as chip_smoke.py's Bound column counts them: each input read
    # once (the live table rows only), each output written once
    nbytes = {"rangeclip::score_topk": 768 + 12 * 3 * 4,
              "rangeclip::conv_score_topk": 512 + live * 72 * 2 + 32 * 3 * 4,
              "rangeclip::class_presence": 48 * 4 + 16,
              "rangeclip::pixel_text_topk": 768 + live * 16 * 4 + 12 * 3 * 8,
              "rangeclip::l2_normalize": 2 * 768,
              "rangeclip::l2_normalize_backward": 3 * 768,
              "rangeclip::histogram": 48 * 4 + 4 * 16 * 4,
              "rangeclip::pixel_text_ce": 768 + 48 * 8 + live * 16 * 4,
              "rangeclip::pixel_text_ce_backward": (2 * 768 + 48 * 8
                                                    + live * 16 * 4),
              "rangeclip::pixel_text_ce_slots": (768 + 192 * 8
                                                 + live * 16 * 4),
              "rangeclip::pixel_text_ce_slots_backward": (
                  2 * 768 + 192 * 8 + live * 16 * 4),
              "rangeclip::tv_rowtile": 1024,
              "rangeclip::tv_rowtile_backward": 2048,
              "rangeclip::masked_pooling": 768 + 12 * 4 + 6 * 4 + 6 * 17 * 4,
              "rangeclip::head_topk": 1024 + 72 * 16 * 4 + 16 * 16 * 4
              + 32 * 3 * 8,
              "rangeclip::tv_loss": 1024,
              "rangeclip::tv_loss_backward": 2048}
    assert roofline.OP_COSTS[name](*args)[0] == nbytes[name]


def test_flop_counter_counts_operators_that_run_on_the_cpu():
    """The operators with a CPU implementation run under flop_counter(): the
    count is the cost table's, and CostRecorder records each call."""
    args = _operator_args()
    names = ("rangeclip::conv_score_topk", "rangeclip::pixel_text_topk",
             "rangeclip::score_topk")
    with roofline.flop_counter() as counter, \
            roofline.CostRecorder() as recorder:
        for name in names:
            getattr(torch.ops.rangeclip, name.split("::")[1])(*args[name])
    want = sum(roofline.OP_COSTS[n](*args[n])[1] for n in names)
    assert counter.get_total_flops() == want > 0
    assert {n: recorder.costs[n] for n in names} == {
        n: [roofline.OP_COSTS[n](*args[n])] for n in names}
