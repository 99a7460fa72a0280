"""One rank of the port's multi-process CPU tests, run as its own process:

    python tests/torch_dist_worker.py MODE RANK WORLD STORE INPUT OUTPUT

It imports torch and the port only (never JAX: the tests' parent has it),
joins a gloo group through the file store ``STORE`` (no port to collide on
under xdist), and writes what the test holds it to into ``OUTPUT``:

* ``ddp``: ``INPUT`` is an ``.npz`` of the global batch, this rank's draws
  (rebuilt by the test from JAX's keys), the table and matrices, and the
  weights; one ``ddp_parity`` step of the port's on this rank's rows, with
  SGD as JAX's test takes it.
* ``global``: ``INPUT`` is an ``.npz`` of the same, with the global batch's
  draws, val batches and the inputs of the ``kernel_shard`` cases; the
  global-batch step on this rank's rows, sync-BatchNorm in f64, each
  ``parallel/kernel_shard`` function and ``masked_average_pooling`` on this
  rank's rows, and ``validate_model`` on this rank's shard of the val
  batches.
* ``cli``: ``INPUT`` is a JSON list of ``cli.train`` arguments; the run's
  learning rates per epoch, best results and a checksum of its weights.

The tests start and join the ranks with :func:`start_ranks` and
:func:`join_ranks`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(mode, world, tmp_path, input_path):
    """Start ``world`` worker processes of ``mode`` on one file store in
    ``tmp_path``; :func:`join_ranks` waits for them."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    outs = [str(tmp_path / f"out{r}") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         str(tmp_path / "store"), str(input_path), outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, outs


def join_ranks(procs, outs, timeout=240):
    """Wait for the workers (each must exit 0); returns their outputs'
    paths."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return outs


def _ddp(rank, world, store, path, out):
    import torch.distributed as dist

    from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )
    from rangeclip_tpu_torch.parallel.mesh import init_distributed
    from rangeclip_tpu_torch.training.state import TrainState
    from rangeclip_tpu_torch.training.train_step import make_train_step

    data = dict(np.load(path))
    init_distributed(f"file://{store}", world, rank, device="cpu")
    group = dist.group.WORLD
    t = torch.from_numpy
    model = DepthUNet(DepthUNetConfig(
        encoder_filters=tuple(int(f) for f in data["filters"]),
        embedding_dim=int(data["dim"])))
    model.load_state_dict({k[3:]: t(v) for k, v in data.items()
                           if k.startswith("sd.")})
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    A, per = data["depth"].shape[0], data["depth"].shape[1] // world
    batch = {k: t(data[k][:, rank * per:(rank + 1) * per].copy())
             for k in ("depth", "segmentation", "object_label",
                       "image_embeddings", "sample_valid")}
    draws = [Draws(t(data[f"pixels.{rank}.{i}"]),
                   (t(data[f"gumbel0.{rank}.{i}"]),
                    t(data[f"gumbel1.{rank}.{i}"]))) for i in range(A)]
    step = make_train_step(HybridLossConfig(), A, ddp_parity=True,
                           group=group)
    state, info = step(state, batch, (0, 0), float(data["lr"]), 0.25, 0.5,
                       t(data["text"]), t(data["medium"]), t(data["hard"]),
                       draws=draws)
    torch.save({"state": state.model.state_dict(),
                "grads": {n: p.grad for n, p in model.named_parameters()
                          if p.grad is not None},
                "info": {k: float(v) for k, v in info.items()}}, out)
    dist.destroy_process_group()


def _model(data):
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )

    model = DepthUNet(DepthUNetConfig(
        encoder_filters=tuple(int(f) for f in data["filters"]),
        embedding_dim=int(data["dim"])))
    model.load_state_dict({k[3:]: torch.from_numpy(v)
                           for k, v in data.items() if k.startswith("sd.")})
    return model


def _sync_bn(data, group):
    """Sync-BatchNorm in f64 on this rank's rows of ``bn.x``: the output,
    the input's gradient of sum(y * bn.w), the local weight and bias
    gradients and the running statistics."""
    from rangeclip_tpu_torch.ops.blocks import BatchNorm2d, sync_batch_norm
    from rangeclip_tpu_torch.parallel.mesh import row_block

    x = row_block(torch.from_numpy(data["bn.x"]), group).clone()
    x.requires_grad_(True)
    bn = BatchNorm2d(x.shape[1], momentum=0.1).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["bn.weight"]))
        bn.bias.copy_(torch.from_numpy(data["bn.bias"]))
    with sync_batch_norm(group):
        y = bn(x)
    (y * row_block(torch.from_numpy(data["bn.w"]), group)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def _kernel_shard(data, group):
    """Each kernel_shard function, masked_average_pooling and the contrast
    and candidate masks, on this rank's rows of the ``ks.*`` inputs."""
    from rangeclip_tpu_torch.losses.infonce import build_contrast_mask
    from rangeclip_tpu_torch.losses.pooling import masked_average_pooling
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
    from rangeclip_tpu_torch.parallel import kernel_shard as ks
    from rangeclip_tpu_torch.parallel.mesh import row_block

    t = {k[3:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("ks.")}
    mine = lambda k: row_block(t[k], group)  # noqa: E731
    ce, n_valid = ks.sharded_ce_sum(
        mine("samples"), t["temperature"], mine("labels"), mine("valid"),
        t["table"], t["mask"], None, group)
    sums, counts = ks.sharded_masked_pooling(mine("field"), mine("seg"),
                                             t["objects"], group)
    return {
        "ce": ce, "n_valid": n_valid,
        "presence": ks.sharded_class_presence(
            mine("seg"), mine("weight")[:, None, None].expand_as(mine("seg")),
            int(t["classes"]), group),
        "histogram": ks.sharded_histogram(t["idx"], int(t["bins"]), group),
        "tv": ks.sharded_tv_rowtile(mine("field"), mine("weight"), 2, group),
        "l2": ks.sharded_l2_normalize_field(mine("field"), group),
        "sums": sums, "counts": counts,
        "pooled": masked_average_pooling(mine("field"), mine("seg"),
                                         t["objects"], group=group),
        "contrast": build_contrast_mask(
            mine("cseg"), torch.ones(mine("cseg").shape), 24,
            torch.from_numpy(data["medium"]), torch.from_numpy(data["hard"]),
            3, 0.25, 0.5, (t["gumbel0"], t["gumbel1"]), group=group),
        "candidate": build_candidate_mask(mine("cseg"), 24, 3, t["gumbel0"],
                                          group=group),
    }


def _validate(data, model, group):
    """validate_model on this rank's rows of every val batch."""
    from rangeclip_tpu_torch.evals.validate import validate_model
    from rangeclip_tpu_torch.models.clip.provider import HashImageEmbedder
    from rangeclip_tpu_torch.parallel.mesh import row_block

    keys = ("depth", "segmentation", "object_label", "sample_valid",
            "image", "object_bbox")
    batches = [{k: row_block(torch.from_numpy(data[f"val.{k}"][i]),
                             group).numpy() for k in keys}
               for i in range(data["val.depth"].shape[0])]
    t = torch.from_numpy
    return validate_model(
        model, batches, t(data["text"]), t(data["medium"]), t(data["hard"]),
        t(data["val.eq"]), t(data["val.cmap"]),
        {"pct_medium": 0.25, "pct_hard": 0.5},
        HashImageEmbedder(dim=int(data["dim"])), 3,
        {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0},
        num_negatives=5, group=group)


def _global(rank, world, store, path, out):
    import torch.distributed as dist

    from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
    from rangeclip_tpu_torch.parallel.mesh import init_distributed, row_block
    from rangeclip_tpu_torch.training.state import TrainState
    from rangeclip_tpu_torch.training.train_step import make_train_step

    data = dict(np.load(path))
    init_distributed(f"file://{store}", world, rank, device="cpu")
    group = dist.group.WORLD
    t = torch.from_numpy
    model = _model(data)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    batch = {k: row_block(t(data[k]), group, dim=1).contiguous()
             for k in ("depth", "segmentation", "object_label",
                       "image_embeddings", "sample_valid")}
    A = data["depth"].shape[0]
    draws = [Draws(t(data[f"pixels.{i}"]),
                   (t(data[f"gumbel0.{i}"]), t(data[f"gumbel1.{i}"])))
             for i in range(A)]
    step = make_train_step(HybridLossConfig(), A, group=group)
    state, info = step(state, batch, (0, 0), float(data["lr"]), 0.25, 0.5,
                       t(data["text"]), t(data["medium"]), t(data["hard"]),
                       draws=draws)
    result = {"state": state.model.state_dict(),
              "grads": {n: p.grad for n, p in model.named_parameters()
                        if p.grad is not None},
              "info": {k: float(v) for k, v in info.items()},
              "bn": _sync_bn(data, group),
              "kernel_shard": _kernel_shard(data, group)}
    if "val.depth" in data:
        result["val"] = _validate(data, _model(data), group)
    torch.save(result, out)
    dist.destroy_process_group()


def _cli(argv, out):
    from rangeclip_tpu_torch.cli import train
    from rangeclip_tpu_torch.training import trainer

    lrs, weights = [], []
    make_schedule, make_step = trainer.make_lr_schedule, trainer.make_train_step

    def recording_schedule(*args, **kwargs):
        schedule = make_schedule(*args, **kwargs)

        class Recorded:
            def __call__(self, epoch):
                lrs.append(schedule(epoch))
                return lrs[-1]

            def __getattr__(self, name):
                return getattr(schedule, name)

        return Recorded()

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, *rest, **kw):
            state, info = step(state, *rest, **kw)
            weights.append(float(sum(p.double().sum() for p in
                                     state.model.state_dict().values())))
            return state, info

        return run

    trainer.make_lr_schedule = recording_schedule
    trainer.make_train_step = recording_step
    best = train.main(argv)
    result = {"lrs": lrs, "best": best, "weights": weights}
    with open(out, "w") as f:
        json.dump(result, f)


def main():
    mode, rank, world, store, path, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    if mode in ("ddp", "global"):
        (_ddp if mode == "ddp" else _global)(rank, world, store, path, out)
        return
    with open(path) as f:
        argv = json.load(f) + ["--coordinator_address", f"file://{store}",
                               "--num_processes", str(world),
                               "--process_id", str(rank)]
    _cli(argv, out)


if __name__ == "__main__":
    main()
