"""The port stands alone: importing it (CLIs included) and running its CPU
predict paths, a CPU train step, the opt-in kernel functions, a validation
step, tiny CLIP towers (one converted from a ``.safetensors`` file), a
tiny MiT UNet, the robustness sweep, the CLIPSeg mapping, the weighted
losses, the numpy evaluation helpers, the monitors, the FLOP counter, the
multinomial pixel sampler, the native depth transform, the setup CLI's
CSV-only subcommands (combine-metadata, remove-small, pseudo-gt over
detection files), the sharded predict and the multi-rank dry run's inputs
(``parallel/``) loads no JAX, flax, pandas, PIL, transformers,
safetensors, matplotlib, h5py, scipy or ultralytics, and asking for a CUDA
device that is absent raises instead of running on the CPU (the benchmark,
convert and setup CLIs included)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import importlib, pkgutil, sys
import torch
import rangeclip_tpu_torch

for info in pkgutil.walk_packages(rangeclip_tpu_torch.__path__,
                                  "rangeclip_tpu_torch."):
    importlib.import_module(info.name)

from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet, DepthUNetConfig, build_candidate_indices, predict_folded)

model = DepthUNet(DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                                  embedding_dim=32),
                  generator=torch.Generator().manual_seed(0)).eval()
gen = torch.Generator().manual_seed(1)
depth = torch.randn(1, 32, 32, generator=gen)
text = torch.randn(20, 32, generator=gen)
seg = torch.randint(0, 5, (1, 32, 32), generator=gen)
cand = build_candidate_indices(seg, 20, 6, 128, generator=gen)
ids = predict_folded(model, depth, text, top_k=2, candidate_indices=cand)
assert ids.shape == (1, 32, 32, 2) and ids.dtype == torch.int32
ids, field, _ = model.predict(depth, text, None, 2, candidate_indices=cand,
                              return_embeddings=False)
assert ids.shape == (1, 32, 32, 2) and field.shape == (1, 16, 16, 32)

from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step

state = create_train_state(model.config, torch.device("cpu"), 1e-4,
                           model=model)
seg = torch.randint(0, 5, (2, 1, 32, 32), generator=gen, dtype=torch.int32)
batch = {"depth": torch.randn(2, 1, 32, 32, 1, generator=gen),
         "segmentation": seg, "object_label": seg[:, :, 3, 3],
         "image_embeddings": torch.randn(2, 1, 32, generator=gen),
         "sample_valid": torch.ones(2, 1)}
state, info = make_train_step(HybridLossConfig(), 2)(
    state, batch, (0, 0), 1e-3, 0.0, 0.75, text,
    torch.rand(20, 20, generator=gen) < 0.2,
    torch.rand(20, 20, generator=gen) < 0.2)
assert state.step == 1 and torch.isfinite(info["total_loss"])

from rangeclip_tpu_torch.evals.metrics import metrics_finalize, metrics_init
from rangeclip_tpu_torch.evals.validate import make_val_step
from rangeclip_tpu_torch.losses.pooling import masked_average_pooling
from rangeclip_tpu_torch.models.depth_unet import predict_topk_fused
from rangeclip_tpu_torch.ops.kernels.tv_loss import fused_tv_loss

model.eval()
mask = torch.zeros(20, dtype=torch.bool)
mask[:7] = True
ids = predict_topk_fused(model, depth, text, mask, top_k=3)
assert ids.shape == (1, 32, 32, 3) and ids.dtype == torch.int32
field, _, _ = model.forward_native(depth)
pooled = masked_average_pooling(field, seg[0, :, ::2, ::2],
                                torch.arange(6))
assert pooled.shape == (6, 32)
x = field.detach().clone().requires_grad_()
fused_tv_loss(x).backward()
assert torch.isfinite(x.grad).all()
mb = {k: v[0] for k, v in batch.items()}
acc, parts, pred = make_val_step()(
    model, mb, (999, 0), 0.0, 0.75, text,
    torch.rand(20, 20, generator=gen) < 0.2,
    torch.rand(20, 20, generator=gen) < 0.2, torch.eye(20, dtype=torch.bool),
    torch.arange(20), mb["image_embeddings"], metrics_init(20))
assert torch.isfinite(parts).all() and pred.shape == (1, 32, 32, 5)
assert 0.0 <= metrics_finalize(acc)["mIoU_tk"] <= 1.0
from rangeclip_tpu_torch.models.clip import (
    CLIPConfig, CLIPTextTower, get_image_provider)
from rangeclip_tpu_torch.models.clip.convert import (
    convert_clip_checkpoint, hf_state_dict, write_safetensors)
import os, tempfile
cfg = CLIPConfig(vocab_size=99, max_position_embeddings=16, text_width=32,
                 text_heads=4, text_layers=1, image_size=32, patch_size=8,
                 vision_width=48, vision_heads=4, vision_layers=1,
                 projection_dim=24)
vision = get_image_provider("random", config=cfg,
                            device=torch.device("cpu"))
text_tower = CLIPTextTower(cfg, generator=gen)
with tempfile.TemporaryDirectory() as tmp:
    path = write_safetensors(os.path.join(tmp, "clip.safetensors"), {
        k: v.numpy() for k, v in hf_state_dict(text_tower,
                                               vision.tower).items()})
    text_sd, _ = convert_clip_checkpoint(path)
text_tower.load_state_dict(text_sd, strict=True)
ids = torch.randint(1, 98, (2, 16), generator=gen)
assert text_tower(ids).shape == (2, 24)
assert vision(torch.randn(2, 32, 32, 3, generator=gen)).shape == (2, 24)
mit = DepthUNet(DepthUNetConfig(unet_type="mit",
                                encoder_filters=(0, 16, 32, 64, 96),
                                embedding_dim=32),
                generator=torch.Generator().manual_seed(0)).eval()
ids, _, _ = mit.predict(depth, text, None, 2, return_embeddings=False)
assert ids.shape == (1, 32, 32, 2)
import numpy as np
from rangeclip_tpu_torch.benchmark.clipseg import clipseg_topk_from_logits
from rangeclip_tpu_torch.benchmark.robustness import (
    format_results_table, robustness_sweep)
from rangeclip_tpu_torch.losses.weighted import weighted_l1_loss
from rangeclip_tpu_torch.utils import eval_utils, monitoring, roofline
seg_np = np.random.default_rng(0).integers(0, 5, (2, 8, 8)).astype(np.int32)
batch = {"image": np.random.default_rng(1).random((2, 8, 8, 3)),
         "segmentation": seg_np, "sample_valid": np.ones(2, np.float32)}
rows = robustness_sweep(lambda: [batch], lambda g, b, im: torch.from_numpy(
    np.repeat(b["segmentation"][..., None], 2, -1)), np.eye(5, dtype=bool),
    np.arange(5), 5, brightness_levels=(1.0, 0.5))
assert rows[0]["pixel_accuracy_t1"] == 1.0 and format_results_table(rows)
assert clipseg_topk_from_logits(np.zeros((3, 4, 4), np.float32), [4, 1, 2],
                                (8, 8), 5).shape == (8, 8, 5)
assert weighted_l1_loss(torch.ones(2, 3, 3, 1), torch.zeros(2, 3, 3, 1)) == 1
assert eval_utils.mean_abs_err(np.ones(3), np.zeros(3)) == 1.0
assert monitoring.validate_tensor(torch.ones(3))["nan"] == 0
with roofline.flop_counter() as counter:
    model(depth)
assert counter.get_total_flops() > 0
from rangeclip_tpu_torch.losses.infonce import multinomial_counts
assert multinomial_counts(50, 12, 2, gen).sum() == 100
from rangeclip_tpu_torch.data.transforms import depth_transform
from rangeclip_tpu_torch.native import lib
assert lib() is not None
assert depth_transform(np.ones((6, 6), np.float32), (3, 3)).sum() == 9
from rangeclip_tpu_torch.cli import setup
with tempfile.TemporaryDirectory() as tmp:
    meta = os.path.join(tmp, "meta.csv")
    with open(meta, "w") as f:
        f.write("image,depth,object_id\na.png,a_d.png,1\nb.png,b_d.png,2\n")
    assert len(setup.main(["remove-small", "--metadata_csv", meta,
                           "--output_csv", os.path.join(tmp, "kept.csv"),
                           "--min_count", "1"])) == 2
    setup.main(["combine-metadata", "--inputs", meta, meta, "--output_csv",
                os.path.join(tmp, "all.csv")])
    with open(os.path.join(tmp, "dets.txt"), "w") as f:
        f.write("1 0.5 0.5 0.4 0.4 0.9\n2 0.52 0.52 0.4 0.4 0.8\n")
    assert len(setup.main(["pseudo-gt", "--detections_glob",
                           os.path.join(tmp, "*.txt"), "--output_dir",
                           os.path.join(tmp, "nms")])) == 1
from rangeclip_tpu_torch.parallel import (
    make_mesh, make_sharded_predict, pad_class_table)
from rangeclip_tpu_torch.parallel.dryrun import StepSpec, step_inputs
cpu = torch.device("cpu")
table, ids = pad_class_table(text, 2)
assert table.shape[0] == 32 and int(ids[-1]) == -1
sharded = make_sharded_predict(model.eval(), make_mesh(1, 2, [cpu] * 2), 2)
assert torch.equal(sharded(depth, table, ids),
                   predict_folded(model, depth, text, top_k=2))
assert step_inputs(StepSpec(), 2, cpu)[0]["depth"].shape[1] == 4
loaded = sorted(m for m in ("jax", "flax", "pandas", "PIL", "rangeclip_tpu",
                            "transformers", "safetensors", "matplotlib",
                            "h5py", "scipy", "ultralytics")
                if m in sys.modules)
assert not loaded, loaded
print("OK")
"""

_NO_CUDA = r"""
import sys
import torch
from rangeclip_tpu_torch.cli import (
    benchmark, convert, serve, setup, train, validate)
from rangeclip_tpu_torch.utils.device import resolve_device

assert not torch.cuda.is_available()
for call in (lambda: resolve_device("cuda"),
             lambda: benchmark.main(["throughput"]),
             lambda: benchmark.main(["profile"]),
             lambda: benchmark.main([
                 "robustness", "--labeled_metadata_path", "absent.csv",
                 "--labels_path", "absent.csv", "--equivalence_dict_path",
                 "absent.csv", "--checkpoint_dir", "absent"]),
             lambda: setup.main(["similarity-sets", "--labels_path",
                                 "absent.csv", "--output_csv", "absent.csv"]),
             lambda: convert.main(["--from_pth", "absent.pth",
                                   "--checkpoint_path", "absent"]),
             lambda: serve.main(["--checkpoint_path", "absent.pth",
                                 "--labels_path", "absent.csv"]),
             lambda: train.main(["--labeled_metadata_path", "absent.csv",
                                 "--labels_path", "absent.csv",
                                 "--equivalence_dict_path", "absent.csv",
                                 "--unet_architecture", "resnet",
                                 "--checkpoint_path", "absent"]),
             lambda: validate.main(["--labeled_metadata_path", "absent.csv",
                                    "--labels_path", "absent.csv",
                                    "--equivalence_dict_path", "absent.csv",
                                    "--checkpoint_dir", "absent"])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        sys.exit("a CUDA request ran without CUDA")
assert resolve_device("cpu").type == "cpu"
print("OK")
"""


def _run(program, **env):
    out = subprocess.run(
        [sys.executable, "-c", program], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, **env})
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), (
        out.stdout + out.stderr)


def test_port_imports_and_predicts_without_jax_pandas_pil():
    _run(_PROGRAM)


def test_cuda_request_without_cuda_raises():
    _run(_NO_CUDA, CUDA_VISIBLE_DEVICES="")
