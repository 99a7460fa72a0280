"""The frozen-encoder finetune and the trainer's real CLIP towers on the
CPU: a frozen step against JAX's frozen step (info within the train-step
tests' rtol 1e-4) that leaves the encoder's parameters and BatchNorm
statistics bit-equal over three steps while the decoder moves; the
encoder-only restore; ``cli/train --restore_path_encoder`` with its
freeze rules and restore precedence; and ``cli/train`` with the CLIP towers
built from an HF-layout ``.safetensors`` checkpoint and a BPE vocabulary
(a tiny tower config) and with ``--clip_checkpoint_path random``."""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.training.optim import make_optimizer as jax_optimizer
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.cli import train
from rangeclip_tpu_torch.data import synthetic
from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.clip import provider
from rangeclip_tpu_torch.models.clip.convert import (
    hf_state_dict,
    write_safetensors,
)
from rangeclip_tpu_torch.models.clip.model import (
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
)
from rangeclip_tpu_torch.models.clip.tokenizer import bytes_to_unicode
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import load_reference_pth
from rangeclip_tpu_torch.training import trainer
from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step

FILTERS = (8, 16, 16, 16, 32)
A, B, C, D, H = 2, 2, 24, 32, 32
LR, WD = 1e-3, 1e-4
CPU = torch.device("cpu")
t = torch.from_numpy


def _randomise_bn(model, seed):
    """BatchNorm affine parameters and running statistics drawn at random:
    a frozen encoder normalises with them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def _model(freeze, seed=3):
    model = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D,
                                      freeze_encoder=freeze),
                      generator=torch.Generator().manual_seed(seed))
    _randomise_bn(model, seed)
    return model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 8, (A, B, H, H)).astype(np.int32)
    batch = {"depth": rng.standard_normal((A, B, H, H, 1)).astype(np.float32),
             "segmentation": seg, "object_label": seg[:, :, 5, 5].copy(),
             "image_embeddings": rng.standard_normal((A, B, D)).astype(
                 np.float32),
             "sample_valid": np.ones((A, B), np.float32)}
    text = rng.standard_normal((C, D)).astype(np.float32)
    return batch, text, rng.random((C, C)) < 0.15, rng.random((C, C)) < 0.15


def _draws(key):
    out = []
    for i in range(A):
        key_pix, key_contrast = jax.random.split(jax.random.fold_in(key, i))
        pixels = jax.random.randint(key_pix, (B, n_draws(H, H)), 0, H * H)
        g = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                  for k in jax.random.split(key_contrast))
        out.append(Draws(t(np.array(pixels, np.int32)), g))
    return out


def test_frozen_step_pins_the_encoder_and_matches_jax():
    """Three frozen steps (eval-mode encoder BatchNorm, no encoder update
    or weight decay): the first step's info against JAX's frozen step
    (``freeze_encoder=True`` in the model config and the optimizer) within
    rtol 1e-4; the third step's grad_norm (the frozen encoder's gradients
    included, as in JAX) equal to a copy's that starts from no gradient;
    after three, every encoder parameter and BatchNorm buffer bit-equal to
    the start, every decoder parameter moved."""
    batch, text, medium, hard = _inputs()
    model = _model(True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (model.encoder, model.decoder)),
        model.log_temperature_text.detach().numpy(),
        model.log_temperature_image.detach().numpy())
    opt = jax_optimizer(WD, freeze_encoder=True)
    jmodel = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=D,
                                    use_batch_norm=True,
                                    freeze_encoder=True))
    jstate = JaxTrainState(step=jnp.int32(0), params=params,
                           batch_stats=stats, opt_state=opt.init(params))
    key = jax.random.key(5)
    _, jinfo = jax_step(jmodel, opt, JaxLossConfig(), accum_steps=A,
                        donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(LR), jnp.float32(0.3), jnp.float32(0.5),
        jnp.asarray(text), jnp.asarray(medium), jnp.asarray(hard))

    state = create_train_state(model.config, CPU, WD, model=model)
    owned = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all((id(p) in owned) != name.startswith("encoder.")
               for name, p in model.named_parameters())
    step = make_train_step(HybridLossConfig(), A)
    torch_batch = {k: t(v) for k, v in batch.items()}
    for i in range(3):
        if i == 2:  # a copy takes the same step from fresh gradients
            twin = create_train_state(model.config, CPU, WD,
                                      model=copy.deepcopy(state.model))
            _, twin_info = step(twin, torch_batch, (0, i), LR, 0.3, 0.5,
                                t(text), t(medium), t(hard))
        state, info = step(state, torch_batch, (0, i), LR, 0.3, 0.5,
                           t(text), t(medium), t(hard),
                           draws=_draws(key) if i == 0 else None)
        assert state.model.encoder.training is False
        assert state.model.decoder.training is True
        if i == 0:
            assert sorted(info) == sorted(jinfo)
            for k, want in jinfo.items():
                np.testing.assert_allclose(float(info[k]), float(want),
                                           rtol=1e-4, err_msg=k)
    assert torch.isfinite(info["total_loss"])
    # the frozen encoder's gradients are the step's own, not a running sum
    assert torch.equal(info["grad_norm"], twin_info["grad_norm"])
    for k, v in state.model.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(v, start[k]), k
        elif k.startswith("decoder.") and not k.endswith(
                "num_batches_tracked"):
            assert not torch.equal(v, start[k]), k


def test_restore_encoder_takes_only_the_encoder(tmp_path):
    """The encoder's weights and BatchNorm statistics come from the latest
    checkpoint; the decoder, the temperatures, the step and the (fresh)
    optimizer from this run; another architecture's encoder is refused."""
    source = create_train_state(None, CPU, model=_model(False, seed=1))
    with torch.no_grad():
        source.model.log_temperature_text.fill_(-1.0)
    source.step = 7
    CheckpointManager(str(tmp_path)).save(source)
    state = create_train_state(None, CPU, WD, model=_model(True, seed=2))
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    CheckpointManager(str(tmp_path)).restore_encoder(state)
    saved = load_reference_pth(str(tmp_path /
                                   "depth_segmentation_model-7.pth"))
    for k, v in state.model.state_dict().items():
        want = saved[k] if k.startswith("encoder.") else init[k]
        assert torch.equal(v, want), k
    assert state.step == 0 and not state.optimizer.state
    other = DepthUNet(DepthUNetConfig(encoder_filters=(8, 8, 8, 8, 16),
                                      embedding_dim=D))
    with pytest.raises((KeyError, RuntimeError)):
        CheckpointManager(str(tmp_path)).restore_encoder(
            create_train_state(None, CPU, model=other))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "absent")).restore_encoder(state)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return synthetic.write_synthetic_dataset(str(root), n_samples=16,
                                             shape=(32, 32), num_classes=8)


def _argv(paths, ckpt, *extra):
    return ["--labeled_metadata_path", paths["metadata"],
            "--labels_path", paths["labels"],
            "--equivalence_dict_path", paths["similarity"],
            "--checkpoint_path", str(ckpt), "--unet_architecture", "resnet",
            "--batch_size", "2", "--n_height", "32", "--n_width", "32",
            "--learning_rates", "1e-3", "--learning_schedule", "2",
            "--accumulation_steps", "2", "--embedding_dim", str(D),
            "--encoder_filters", *map(str, FILTERS),
            "--n_step_per_summary", "1", "--n_step_per_checkpoint", "1",
            "--w_weight_decay", "1e-4", "--device", "cpu", *extra]


def _weights(ckpt, step):
    return load_reference_pth(os.path.join(
        ckpt, "checkpoints", f"depth_segmentation_model-{step}.pth"))


@pytest.fixture(scope="module")
def source_run(dataset_dir, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("source")
    train.main(_argv(dataset_dir, ckpt, "--max_steps", "2"))
    return ckpt


@pytest.mark.parametrize("flag,frozen", [(None, True),
                                         ("--no_freeze_encoder", False)])
def test_cli_train_restores_the_encoder(dataset_dir, source_run, tmp_path,
                                        flag, frozen):
    """--restore_path_encoder freezes by default (the JAX log line, the
    encoder of every checkpoint bit-equal to the source's latest, BN
    statistics included, the decoder trained from a fresh start at step
    1); --no_freeze_encoder restores and then trains the encoder too."""
    src = os.path.join(source_run, "checkpoints")
    train.main(_argv(dataset_dir, tmp_path, "--max_steps", "2",
                     "--restore_path_encoder", src,
                     *([flag] if flag else [])))
    log = open(os.path.join(tmp_path, "results.txt")).read()
    line = "Restored encoder weights" + (
        " (frozen-encoder finetune)." if frozen else ".")
    assert line in log
    want = _weights(source_run, 2)
    for step in (1, 2):
        got = _weights(tmp_path, step)
        enc = [k for k in got if k.startswith("encoder.")]
        assert all(torch.equal(got[k], want[k]) for k in enc) == frozen
        assert not all(torch.equal(got[k], want[k]) for k in got
                       if k.startswith("decoder."))


def test_cli_train_restore_precedence(dataset_dir, source_run, tmp_path):
    """auto_resume, then restore_path_encoder, then restore_path_model:
    given both restore paths the encoder restore runs; with a checkpoint
    of its own, --auto_resume resumes it instead; --freeze_encoder alone
    freezes a fresh encoder."""
    src = os.path.join(source_run, "checkpoints")
    both = _argv(dataset_dir, tmp_path, "--max_steps", "1",
                 "--restore_path_encoder", src, "--restore_path_model", src)
    train.main(both)
    log = open(os.path.join(tmp_path, "results.txt")).read()
    assert "Restored encoder weights (frozen-encoder finetune)." in log
    assert "Restored checkpoint" not in log
    train.main([a if a != "1" or i != both.index("--max_steps") + 1 else "2"
                for i, a in enumerate(both)] + ["--auto_resume"])
    log = open(os.path.join(tmp_path, "results.txt")).read()
    assert "Auto-resumed from step 1" in log
    fresh = tmp_path / "fresh"
    train.main(_argv(dataset_dir, fresh, "--max_steps", "1",
                     "--freeze_encoder"))
    init = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=D),
                     generator=torch.Generator().manual_seed(0))
    got = _weights(fresh, 1)
    for k, v in init.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(got[k], v), k


TINY = CLIPConfig(vocab_size=99, max_position_embeddings=77, text_width=32,
                  text_heads=4, text_layers=2, image_size=224,
                  patch_size=56, vision_width=48, vision_heads=4,
                  vision_layers=2, projection_dim=D)


def _clip_files(tmp_path):
    """A tiny HF-layout CLIP checkpoint (.safetensors) and a byte-level
    vocabulary whose end token has its highest id."""
    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    cfg = CLIPConfig(**{**TINY.__dict__, "vocab_size": len(vocab)})
    towers = (CLIPTextTower(cfg, generator=torch.Generator().manual_seed(0)),
              CLIPVisionTower(cfg, generator=torch.Generator().manual_seed(1)))
    paths = [str(tmp_path / n) for n in ("clip.safetensors", "vocab.json",
                                         "merges.txt")]
    write_safetensors(paths[0], {k: v.numpy() for k, v in
                                 hf_state_dict(*towers).items()})
    with open(paths[1], "w") as f:
        json.dump(vocab, f)
    with open(paths[2], "w") as f:
        f.write("#version: 0.2\n")
    return paths, cfg


def test_cli_train_with_the_clip_towers(dataset_dir, tmp_path, monkeypatch):
    """--clip_checkpoint_path/--clip_vocab_path/--clip_merges_path: the
    trainer builds both towers from the files (a tiny config in place of
    ViT-B/32) on its device, embeds the 8 labels once (one chunk of 128)
    and runs the image tower once per accumulation window (2 x 2 crops at
    224^2); --clip_checkpoint_path random builds the full ViT-B/32 image
    tower, widened to the embedding dim."""
    paths, cfg = _clip_files(tmp_path)
    for name in ("get_text_provider", "get_image_provider"):
        monkeypatch.setattr(trainer, name, functools.partial(
            getattr(provider, name), config=cfg))
    calls = []
    for cls in (CLIPTextTower, CLIPVisionTower):
        def spy(self, x, *args, _forward=cls.forward, _name=cls.__name__):
            calls.append((_name, tuple(x.shape), x.device.type))
            return _forward(self, x, *args)
        monkeypatch.setattr(cls, "forward", spy)
    train.main(_argv(dataset_dir, tmp_path / "towers", "--max_steps", "2",
                     "--clip_checkpoint_path", paths[0],
                     "--clip_vocab_path", paths[1],
                     "--clip_merges_path", paths[2]))
    assert calls == [("CLIPTextTower", (128, 77), "cpu")] + [
        ("CLIPVisionTower", (4, 224, 224, 3), "cpu")] * 2
    assert all(torch.isfinite(v.float()).all()
               for v in _weights(tmp_path / "towers", 2).values())
    random_tower = provider.get_image_provider("random", dim=D,
                                               device=torch.device("meta"))
    assert isinstance(random_tower, provider.CLIPImageEmbedder)
    assert random_tower.dim == D
    assert random_tower.tower.config.vision_width == 768
