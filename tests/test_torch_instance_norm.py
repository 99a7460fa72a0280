"""The instance-norm DepthUNet (``DepthUNetConfig(use_batch_norm=False,
use_instance_norm=True)``) against the JAX package's on the CPU, for the
ResNet-18, ResNet-50 and MiT encoders at narrow widths on 64^2 maps (the
deepest ResNet level 2 x 2).  JAX's weights, drawn at random in the shapes
of its init, reach the port through JAX's own reference export
(``save_reference_checkpoint``, loaded with ``strict=True``; the MiT,
which that export does not map, through ``models/interop.
state_dict_from_jax``).  Held: the f32 field within 1e-5 of its largest
magnitude; fp32 predict labels equal but for near-ties (top-k cosines
within 1e-5); one f32 ResNet-18 train step on JAX's draws, the info within
rtol 2e-5 and Adam's moments at ``test_torch_train_step.py``'s tolerance
(rtol 2e-3, atol 1e-3 of each tensor's largest entry); and the bf16
forward, whose InstanceNorm the port normalises in f32 and rounds once
where JAX rounds the statistics and normalises in bf16 (``ops/blocks.
NormAct``): field within ``BF16_FIELD_ATOL`` and top-1 agreement at least
``BF16_MIN_AGREEMENT``, the floor the bf16 grid checks use."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import save_reference_checkpoint
from rangeclip_tpu.training.optim import make_optimizer as jax_optimizer
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import (
    load_reference_pth,
    state_dict_from_jax,
    widths_from_state_dict,
)
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step
from rangeclip_tpu_torch.utils.math import l2_normalize
from test_torch_mit import _random_leaves

D, C, K, H = 32, 20, 4, 64
NORM = dict(use_batch_norm=False, use_instance_norm=True, embedding_dim=D)
CONFIGS = {
    "resnet18": dict(unet_type="resnet", encoder_filters=(8, 16, 16, 32, 32),
                     **NORM),
    "resnet50": dict(unet_type="resnet", n_layer=50,
                     encoder_filters=(8, 8, 16, 16, 32), **NORM),
    # the last four filters are the MiT's stage widths
    "mit": dict(unet_type="mit", encoder_filters=(0, 16, 32, 64, 96),
                **NORM),
}
FIELD_RTOL = 1e-5
TIE_TOL = 1e-5
# bf16: the port's f32 normalisation against JAX's bf16 one
BF16_FIELD_ATOL = 0.05
BF16_MIN_AGREEMENT = 0.95
t = torch.from_numpy


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX model, numpy variables, the port model in eval mode) with the
    same random weights."""
    cfg = CONFIGS[kind]
    model = JaxDepthUNet(JaxConfig(**cfg))
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, H, H, 1)))
    v = _random_leaves(jax.tree.map(lambda a: a, dict(shapes)),
                       np.random.default_rng(len(kind)))
    assert "batch_stats" not in v  # InstanceNorm keeps no statistic
    v["batch_stats"] = {}
    return model, v


def _port(kind, v, tmp_path):
    """The port's model, its weights from JAX's reference export (the
    MiT's from the port's converter), loaded strictly."""
    if kind == "mit":
        sd = state_dict_from_jax(v["params"], {})
    else:
        path = str(tmp_path / f"{kind}.pth")
        save_reference_checkpoint(v["params"], {}, path)
        sd = load_reference_pth(path)
        assert not any("batch_norm" in k for k in sd)
        widths = widths_from_state_dict(sd)
        assert widths["use_batch_norm"] is False
    port = DepthUNet(DepthUNetConfig(**CONFIGS[kind]))
    port.load_state_dict(sd, strict=True)
    return port.eval()


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, 1)).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    return x, text


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's port runs on one intra-op thread: at these sizes a
    single thread is the fastest, and a test worker beside others loses
    most of its time to thread contention otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, tmp_path_factory):
    """(kind, JAX variables, the port model, JAX's fp32 predict on
    ``_inputs(2)``: its top-k labels and its field, in one program)."""
    kind = request.param
    model, v = _models(kind)
    x, text = _inputs(2)
    labels, field, _ = jax.jit(lambda v, x, t: model.apply(
        v, x, t, jnp.ones((C,), bool), K, method=JaxDepthUNet.predict))(
        v, jnp.asarray(x), jnp.asarray(text))
    return (kind, v, _port(kind, v, tmp_path_factory.mktemp(kind)),
            np.asarray(labels), np.asarray(field))


def test_instance_norm_field_matches_jax(pair):
    """fp32, eval mode: the field within 1e-5 of its largest magnitude;
    the ResNets' weights through JAX's own reference export."""
    kind, v, port, _, want = pair
    x, _ = _inputs(2)
    with torch.no_grad():
        got = port(t(x))[0].numpy()
    assert got.shape == want.shape == (2, H, H, D)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIELD_RTOL * np.abs(want).max())


def test_instance_norm_predict_labels_match_jax(pair):
    """fp32 ``predict`` top-k labels against JAX's: equal but for
    near-ties, whose cosines are within 1e-5."""
    kind, v, port, want, _ = pair
    x, text = _inputs(2)
    with torch.no_grad():
        got = port.predict(t(x), t(text), None, K,
                           return_embeddings=False)[0].numpy()
        field = port(t(x))[0]
    assert got.shape == want.shape == (2, H, H, K)
    agree = got == want
    assert agree.mean() >= 0.999, (kind, agree.mean())
    cos = torch.einsum("bhwd,cd->bhwc", field,
                       l2_normalize(t(text), dim=-1)).numpy()
    g = np.take_along_axis(cos, np.maximum(got, 0), -1)
    w = np.take_along_axis(cos, np.maximum(want, 0), -1)
    np.testing.assert_allclose(g[~agree], w[~agree], atol=TIE_TOL)


def test_instance_norm_bf16_forward_within_tolerance(pair):
    """bf16 compute: the field within ``BF16_FIELD_ATOL`` of JAX's bf16
    field and top-1 labels agreeing on at least ``BF16_MIN_AGREEMENT`` of
    the pixels (JAX normalises in bf16 after rounding its statistics; the
    port normalises in f32 and rounds once)."""
    kind, v, port, _, _ = pair
    x, text = _inputs(4)
    model = JaxDepthUNet(JaxConfig(**CONFIGS[kind], dtype=jnp.bfloat16))
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x)[0])(
        v, jnp.asarray(x)).astype(jnp.float32))
    mine = DepthUNet(DepthUNetConfig(**CONFIGS[kind], dtype=torch.bfloat16))
    mine.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = mine.eval()(t(x))[0].float().numpy()
    err = float(np.abs(got - want).max())
    table = l2_normalize(t(text), dim=-1).numpy()
    agree = float(((got @ table.T).argmax(-1)
                   == (want @ table.T).argmax(-1)).mean())
    assert np.isfinite(got).all()
    print(f"bf16 {kind}: field error {err!r}, top-1 agreement {agree!r}")
    assert err <= BF16_FIELD_ATOL, (kind, err, agree)
    assert agree >= BF16_MIN_AGREEMENT, (kind, err, agree)


def _draws(key, A, B):
    """Per microbatch, the draws of compute_hybrid_loss(fold_in(key, i))."""
    out = []
    for i in range(A):
        key_pix, key_contrast = jax.random.split(jax.random.fold_in(key, i))
        pixels = jax.random.randint(key_pix, (B, n_draws(H, H)), 0, H * H)
        g = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                  for k in jax.random.split(key_contrast))
        out.append(Draws(t(np.array(pixels, np.int32)), g))
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One f32 ResNet-18 window (A = 2 microbatches of 2) of JAX's step
    and the port's, from the same weights, batch and draws."""
    A, B, LR, WD = 2, 2, 1e-3, 1e-4
    model, v = _models("resnet18")
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 6, (A, B, H, H)).astype(np.int32)
    batch = {"depth": rng.standard_normal((A, B, H, H, 1)).astype(np.float32),
             "segmentation": seg, "object_label": seg[:, :, 9, 9].copy(),
             "image_embeddings": rng.standard_normal((A, B, D)).astype(
                 np.float32),
             "sample_valid": np.array([[1, 1], [1, 0]], np.float32)}
    text = rng.standard_normal((C, D)).astype(np.float32)
    medium, hard = (rng.random((C, C)) < 0.15 for _ in range(2))
    opt = jax_optimizer(WD)
    key = jax.random.key(7)
    jstate, jinfo = jax_step(model, opt, JaxLossConfig(), accum_steps=A,
                             donate=False)(
        JaxTrainState(step=jnp.int32(0), params=v["params"], batch_stats={},
                      opt_state=opt.init(v["params"])),
        {k: jnp.asarray(a) for k, a in batch.items()}, key, jnp.float32(LR),
        jnp.float32(0.3), jnp.float32(0.5), jnp.asarray(text),
        jnp.asarray(medium), jnp.asarray(hard))
    port = _port("resnet18", v, tmp_path_factory.mktemp("step"))
    state = create_train_state(port.config, torch.device("cpu"), WD,
                               model=port)
    state, info = make_train_step(HybridLossConfig(), A)(
        state, {k: t(a) for k, a in batch.items()}, (0, 0), LR, 0.3, 0.5,
        t(text), t(medium), t(hard), draws=_draws(key, A, B))
    return state, info, jax.device_get(jstate), jax.device_get(jinfo)


def test_instance_norm_train_step_loss_matches_jax(steps):
    """The info of the window (the losses within rtol 2e-5, the rest within
    rtol 1e-4, as ``test_torch_train_step.py`` holds them); the model has
    no buffer to update."""
    state, info, _, jinfo = steps
    assert sorted(info) == sorted(jinfo)
    for k, want in jinfo.items():
        rtol = 2e-5 if k.endswith("loss") else 1e-4
        np.testing.assert_allclose(float(info[k]), float(want), rtol=rtol,
                                   err_msg=k)
    assert not list(state.model.buffers())


def test_instance_norm_train_step_gradients_match_jax(steps):
    """Adam's first and second moments after the step (the gradients and
    their squares, weight decay included) against JAX's: rtol 2e-3, atol
    1e-3 of each tensor's largest entry; every moment finite."""
    state, _, jstate, _ = steps
    adam = jstate.opt_state[1]  # (decay, scale_by_adam, scale)
    held = 0
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        want_m = state_dict_from_jax(moment, {})
        for name, p in state.model.named_parameters():
            if not state.optimizer.state.get(p):
                continue  # an identity block's projection: absent in JAX
            got = state.optimizer.state[p][key].numpy()
            w = want_m[name].numpy().reshape(got.shape)
            assert np.isfinite(got).all(), name
            np.testing.assert_allclose(got, w, rtol=2e-3,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=f"{key} {name}")
            held += 1
    assert held > 40


def test_instance_norm_model_needs_no_running_statistics(tmp_path):
    """The paths that touch BatchNorm's buffers take a model without any:
    no running statistic to average or broadcast, the frozen encoder's
    restore and freeze, and the folded and fused-head predicts, whose
    labels equal ``predict``'s but for near-ties (1e-5 of the cosine)."""
    from rangeclip_tpu_torch.models.depth_unet import (
        predict_folded,
        predict_topk_fused,
    )
    from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
    from rangeclip_tpu_torch.training.train_step import running_statistics

    _, v = _models("resnet18")
    port = _port("resnet18", v, tmp_path)
    assert running_statistics(port.train()) == []
    port.eval()
    x, text = _inputs(6)
    with torch.no_grad():
        want = port.predict(t(x), t(text), None, K,
                            return_embeddings=False)[0]
        field = port(t(x))[0]
        mask = torch.ones(C, dtype=torch.bool)
        got = {"folded": predict_folded(port, t(x), t(text), top_k=K),
               "fused": predict_topk_fused(port, t(x), t(text), mask, K)}
    cos = torch.einsum("bhwd,cd->bhwc", field,
                       l2_normalize(t(text), dim=-1))
    for name, ids in got.items():
        differ = ids != want
        assert differ.float().mean() <= 1e-3, name
        gap = (cos.gather(-1, ids.long()) - cos.gather(-1, want.long()))
        assert bool((gap[differ].abs() <= TIE_TOL).all()), name

    frozen = DepthUNet(DepthUNetConfig(**CONFIGS["resnet18"],
                                       freeze_encoder=True)).train()
    assert not frozen.encoder.training and not list(frozen.buffers())
    manager = CheckpointManager(str(tmp_path / "run"))
    source = create_train_state(port.config, torch.device("cpu"), 1e-4,
                                model=port)
    source.step = 3
    manager.save(source)
    state = create_train_state(frozen.config, torch.device("cpu"), 1e-4,
                               model=frozen)
    manager.restore_encoder(state)
    for k, p in frozen.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(p, port.state_dict()[k]), k
