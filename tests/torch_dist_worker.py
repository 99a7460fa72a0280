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
* ``halo``: ``INPUT`` names nothing; every case of :func:`halo_cases` on
  this rank's rows of a spatial grid of the world, in f64: the output
  rows, the input's gradient rows and the parameters' gradients; and what
  the grid's train step raises on its block of a 30-row batch.
* ``grid_predict`` and ``grid_step``: ``INPUT`` is an ``.npz`` of the
  weights and inputs; the grid predicts, or the grid steps, of
  ``grid_predict`` / ``grid_step`` on this rank's block, for every grid
  shape the ``.npz`` names.

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


def start_ranks(mode, world, tmp_path, input_path, threads=2):
    """Start ``world`` worker processes of ``mode`` on one file store in
    ``tmp_path``, each with ``threads`` CPU threads; :func:`join_ranks`
    waits for them."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(threads),
           "WORKER_THREADS": str(threads)}
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


def halo_cases():
    """``(name, height, width, make)``: ``make()`` returns (f, x, g) in
    f64, seeded: a layer ``f`` built on ``ops/blocks``' functions (which
    route through ``parallel/halo`` inside ``blocks.spatial_rows``), its
    NCHW input and the weights of the loss sum(f(x) * g).  The heights
    leave blocks empty and halos wider than a block on 4 ranks."""
    import torch.nn.functional as F
    from torch import nn

    from rangeclip_tpu_torch.ops import blocks
    from rangeclip_tpu_torch.ops.aspp import ASPP, group_norm

    def conv(cin, cout, k, stride=1, dilation=1, padding=None):
        layer = nn.Conv2d(cin, cout, k, stride,
                          k // 2 * dilation if padding is None else padding,
                          dilation, bias=False).double()
        return lambda x: blocks.conv2d(layer, x), layer

    def case(name, height, width, build, channels=3, out_shape=None):
        def make():
            torch.manual_seed(len(name) * 1000 + height)
            f, module = build()
            x = torch.randn(2, channels, height, width, dtype=torch.float64)
            y = f(x)
            g = torch.randn(y.shape, dtype=torch.float64)
            return f, x, g, module
        return name, height, width, make

    def transposed(k, stride, padding, out_pad, bias):
        layer = nn.ConvTranspose2d(3, 4, k, stride, padding, out_pad,
                                   bias=bias).double()
        return (lambda x: blocks.conv_transpose_2d(
            x, layer.weight, stride, padding, out_pad, layer.bias), layer)

    def norm_act_instance():
        layer = blocks.Conv2d(3, 4, 3, use_instance_norm=True,
                              activation=None).double()
        # NormAct normalises in f32; the f64 case takes the statistics
        layer.norm_act = lambda y: (
            F.instance_norm(y, eps=1e-5) if blocks._SPATIAL is None
            else blocks._SPATIAL.instance_norm(y, 1e-5))
        return layer, layer

    def gn():
        layer = nn.GroupNorm(4, 8).double()
        with torch.no_grad():
            layer.weight.uniform_(0.5, 1.5)
            layer.bias.uniform_(-1, 1)
        return lambda x: group_norm(x, layer), layer

    def aspp():
        layer = ASPP(3, 32, num_groups=8).double()
        return layer, layer

    def resize(size):
        return lambda x: blocks.resize_to(x, size), None

    cases = []
    for height in (32, 8, 5, 3, 1):
        cases += [
            case(f"conv k1 h{height}", height, 6, lambda: conv(3, 4, 1)),
            case(f"conv k3 h{height}", height, 6, lambda: conv(3, 4, 3)),
            case(f"conv k3 s2 h{height}", height, 6,
                 lambda: conv(3, 4, 3, 2)),
            case(f"conv k1 s2 h{height}", height, 6,
                 lambda: conv(3, 4, 1, 2)),
            case(f"conv k7 s2 h{height}", height, 6,
                 lambda: conv(3, 4, 7, 2)),
            case(f"conv k3 d6 h{height}", height, 6,
                 lambda: conv(3, 4, 3, 1, 6)),
            case(f"conv k3 d18 h{height}", height, 6,
                 lambda: conv(3, 4, 3, 1, 18)),
            case(f"max pool h{height}", height, 6, lambda: (
                lambda x: blocks.max_pool2d(x, 3, 2, 1), None)),
            case(f"mean h{height}", height, 6,
                 lambda: (blocks.spatial_mean, None)),
            case(f"group norm h{height}", height, 6, gn, channels=8),
            case(f"transposed k2 s2 h{height}", height, 6,
                 lambda: transposed(2, 2, 0, 0, True)),
            case(f"transposed k3 s2 h{height}", height, 6,
                 lambda: transposed(3, 2, 1, 1, False)),
            case(f"instance norm h{height}", height, 6, norm_act_instance),
        ]
    cases += [
        case("aspp h8", 8, 6, aspp),
        case("aspp h1", 1, 6, aspp),
        case("resize 16 to 8", 16, 16, lambda: resize((8, 8))),
        case("resize 8 to 5", 8, 8, lambda: resize((5, 5))),
        case("resize 3 to 7", 3, 6, lambda: resize((7, 12))),
    ]
    return cases


def _halo(rank, world, store, out):
    """Every halo case on this rank's rows of a (1, world, 1) grid."""
    import torch.distributed as dist

    from rangeclip_tpu_torch.parallel.halo import sharded_rows
    from rangeclip_tpu_torch.parallel.mesh import (
        init_distributed,
        make_grid,
        owned_rows,
    )

    init_distributed(f"file://{store}", world, rank, device="cpu")
    grid = make_grid(1, world, 1)
    result = {}
    for name, height, width, make in halo_cases():
        f, x, g, module = make()
        x = grid.row_block(x, 2).clone().requires_grad_(True)
        with sharded_rows(grid, (height, width)):
            y = f(x)
        if y.dim() == 4:
            lo, hi = owned_rows(g.shape[2], world, rank)
            g = g[:, :, lo:hi]
        elif rank:  # the same [N, C] on every rank: one rank's loss
            g = torch.zeros_like(g)
        (y * g).sum().backward()
        result[name] = {
            "y": y.detach(), "dx": x.grad,
            "dp": {} if module is None else {
                n: p.grad for n, p in module.named_parameters()
                if p.grad is not None}}
    result["step refusal"] = _step_refusal(grid, 30)
    torch.save(result, out)
    dist.destroy_process_group()


def _step_refusal(grid, height):
    """What the grid's train step raises on this rank's block of a batch
    ``height`` rows high, cut by ``owned_rows`` alone (None if it steps)."""
    from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
    from rangeclip_tpu_torch.parallel.mesh import owned_rows
    from rangeclip_tpu_torch.training.state import create_train_state
    from rangeclip_tpu_torch.training.train_step import make_train_step

    state = create_train_state(
        DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                        embedding_dim=32), torch.device("cpu"), 1e-4, 0)
    lo, hi = owned_rows(height, grid.n_spatial, grid.s)
    batch = {"depth": torch.zeros(1, 1, hi - lo, 32, 1),
             "segmentation": torch.zeros(1, 1, hi - lo, 32,
                                         dtype=torch.int32),
             "object_label": torch.zeros(1, 1, dtype=torch.int32),
             "image_embeddings": torch.zeros(1, 1, 32),
             "sample_valid": torch.ones(1, 1)}
    step = make_train_step(HybridLossConfig(), 1, group=grid)
    try:
        step(state, batch, (0, 0), 1e-3, 0.25, 0.5, torch.zeros(4, 32),
             torch.zeros(4, 4, dtype=torch.bool),
             torch.zeros(4, 4, dtype=torch.bool))
    except ValueError as err:
        return str(err)
    return None


def _grid_model(data):
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


def big_config():
    """The bf16 model of the packed-CE step at C = 2048
    (``tests/test_parallel.py:538``).  Its steps on the CPU run without
    oneDNN (``parallel/dryrun.native_cpu_convolutions``: there its bf16
    convolutions' weight gradients differ from run to run, by up to 2.5e-5
    at this size, and some entries come back NaN once in a few runs)."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig

    return DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                           embedding_dim=128, dtype=torch.bfloat16)


def _grid_predict(rank, world, store, path, out):
    """Each grid of ``grids`` predicting the batch: rank 0 of each grid
    writes the gathered map, and every member its launches."""
    import torch.distributed as dist

    from rangeclip_tpu_torch.parallel.mesh import init_distributed, make_grid
    from rangeclip_tpu_torch.parallel.predict import (
        gather_label_blocks,
        make_grid_predict,
        pad_class_table,
    )

    data = dict(np.load(path))
    init_distributed(f"file://{store}", world, rank, device="cpu")
    t = torch.from_numpy
    result = {}
    for shape in data["grids"]:
        grid = make_grid(*(int(v) for v in shape))
        if grid is None:
            continue
        model = _grid_model(data).eval()
        padded, ids = pad_class_table(t(data["table"]), grid.n_model)
        fn = make_grid_predict(model, grid, int(data["top_k"]))
        labels = gather_label_blocks(fn(t(data["depth"]), padded, ids), grid)
        result[tuple(int(v) for v in shape)] = labels
    torch.save(result, out)
    dist.destroy_process_group()


def _grid_step(rank, world, store, path, out):
    """The global-batch step on each grid of ``grids`` (the class tables
    split over 'model' where it has more than one rank, the draws of the
    whole batch), and, where the ``.npz`` names a grid ``big.grid``, the
    bf16 packed-CE step at C = 2048 on it with model-sharded tables."""
    import torch.distributed as dist

    from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
    from rangeclip_tpu_torch.parallel.dryrun import (
        _snapshot,
        native_cpu_convolutions,
    )
    from rangeclip_tpu_torch.parallel.mesh import (
        init_distributed,
        make_grid,
        shard_class_tables,
    )
    from rangeclip_tpu_torch.training.state import (
        TrainState,
        create_train_state,
    )
    from rangeclip_tpu_torch.training.train_step import make_train_step

    data = dict(np.load(path))
    init_distributed(f"file://{store}", world, rank, device="cpu")
    t = torch.from_numpy
    keys = ("depth", "segmentation", "object_label", "image_embeddings",
            "sample_valid")
    result = {}
    for shape in data["grids"]:
        A = data["depth"].shape[0]
        grid = make_grid(*(int(v) for v in shape))
        if grid is None:
            continue
        model = _grid_model(data)
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.0))
        batch = grid.local_batch({k: t(data[k]) for k in keys}, 1)
        tables = shard_class_tables(
            t(data["text"]), t(data["medium"]), t(data["hard"]),
            grid.n_model > 1, grid)
        draws = [Draws(t(data[f"pixels.{i}"]),
                       (t(data[f"gumbel0.{i}"]), t(data[f"gumbel1.{i}"])))
                 for i in range(A)]
        step = make_train_step(HybridLossConfig(), A, group=grid)
        state, info = step(state, batch, (0, 0), float(data["lr"]), 0.25,
                           0.5, *tables, draws=draws)
        result[tuple(int(v) for v in shape)] = {
            "state": model.state_dict(),
            "grads": {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None},
            "info": {k: float(v) for k, v in info.items()}}
    grid = (make_grid(*(int(v) for v in data["big.grid"]))
            if "big.grid" in data else None)
    if grid is not None:
        state = create_train_state(big_config(), torch.device("cpu"), 1e-4,
                                   5)
        batch = grid.local_batch({k: t(data[f"big.{k}"]) for k in keys}, 1)
        tables = shard_class_tables(
            t(data["big.text"]), t(data["big.medium"]), t(data["big.hard"]),
            True, grid)
        step = make_train_step(HybridLossConfig(contrast_capacity=128), 2,
                               group=grid)
        with native_cpu_convolutions(True, "cpu"):
            state, info = step(state, batch, (3, 0), 1e-3, 0.25, 0.5,
                               *tables)
        result["big"] = _snapshot(state, info)
    torch.save(result, out)
    dist.destroy_process_group()


def main():
    mode, rank, world, store, path, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(int(os.environ.get("WORKER_THREADS", "2")))
    if mode in ("ddp", "global"):
        (_ddp if mode == "ddp" else _global)(rank, world, store, path, out)
        return
    if mode == "halo":
        _halo(rank, world, store, out)
        return
    if mode in ("grid_predict", "grid_step"):
        (_grid_predict if mode == "grid_predict" else _grid_step)(
            rank, world, store, path, out)
        return
    with open(path) as f:
        argv = json.load(f) + ["--coordinator_address", f"file://{store}",
                               "--num_processes", str(world),
                               "--process_id", str(rank)]
    _cli(argv, out)


if __name__ == "__main__":
    main()
