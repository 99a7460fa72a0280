"""The multi-rank dry run (``__graft_entry__.dryrun_multichip``):

    python -m rangeclip_tpu_torch.parallel.dryrun N [--device cuda|cpu]
        [--backend gloo|nccl]

builds the kernels (on CUDA) and spawns N ranks at tiny shapes, laid out as
JAX's dry run lays its mesh (``__graft_entry__.py:164-170``): a ``data x
spatial x model`` grid with ``n_model`` 2 when N is even and ``n_spatial``
2 when 4 divides N.  In one spawn the ranks take (1) the global-batch step
on the grid, the class tables split over 'model' when it has two ranks,
against the single-device step on the whole batch with the same (rank-less)
draws (:func:`oracle_step`); (2) the ``ddp_parity`` step over the world,
against the same step simulated rank by rank (:func:`simulate_ddp_step`:
the same weights, rows and generators, the BatchNorm statistics averaged
after each microbatch, the gradients after the window); (3) with a
'spatial' axis, the grid's predict (:func:`check_grid_predict`), whose
labels must equal the ``data x model`` predict of one process; (4) with a
'model' axis, the bf16 packed-CE step at C = 2048 with model-sharded
tables, finite and against the same step over a data-only grid of the
world (``__graft_entry__.py:350-410``).  Then a sharded predict on a ``2 x
N/2`` device grid against single-device predict.  Any difference raises.
On CUDA the ranks take ``cuda:(rank % device count)``, so on one card
every rank shares it (over gloo: NCCL refuses two ranks on one GPU).

:func:`run_ranks`, :func:`oracle_step` and :func:`check_step` are also
what ``chip_smoke.py`` holds the full-width steps and grid predicts with,
and :func:`single_device_validation` what it holds the ranks' sharded
validation with (a spec's ``val_batches``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.cli.common import set_precision
from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
from rangeclip_tpu_torch.parallel.mesh import (
    init_distributed,
    make_grid,
    replicate,
    shard_class_tables,
    shutdown_distributed,
)
from rangeclip_tpu_torch.training.optim import set_learning_rate
from rangeclip_tpu_torch.training.state import TrainState, create_train_state
from rangeclip_tpu_torch.training.train_step import (
    INFO_KEYS,
    make_train_step,
    microbatch_generator,
    microbatch_loss,
    running_statistics,
)


MODES = ("global", "ddp_parity")


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One train step over the ranks: ``mode`` the global-batch step or
    ``ddp_parity``, the model's architecture (``unet_type``: 'resnet', or
    'mit' with the last four ``filters`` as its stage widths) and widths,
    ``batch`` rows a rank (a data block, on a grid) per microbatch,
    ``accum`` microbatches, ``present`` labels of ``classes`` in the
    segmentation, weights and data from ``seed``.  ``grid`` (data,
    spatial, model) runs the global-batch step on the world's first ranks
    as that grid (``mesh.make_grid``), the class tables split over 'model'
    with ``shard_classes``; without it the step runs over the world's
    group.  With ``val_batches`` each rank first validates its rows of
    that many global batches of ``val_batch`` images a rank or data block
    (default ``batch``; ``evals/validate.validate_model`` over the group,
    or over the grid: its data block's images, its spatial block of their
    rows) on the initial weights."""

    unet_type: str = "resnet"
    filters: Tuple[int, ...] = (8, 16, 16, 16, 32)
    dim: int = 32
    res: int = 32
    batch: int = 2
    accum: int = 2
    classes: int = 24
    present: int = 8
    bf16: bool = False
    seed: int = 0
    lr: float = 1e-3
    weight_decay: float = 1e-4
    mode: str = "global"
    val_batches: int = 0
    val_batch: Optional[int] = None
    grid: Optional[Tuple[int, int, int]] = None
    shard_classes: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}, expected one of {MODES}")
        if self.grid is not None and self.mode != "global":
            raise ValueError("a grid runs the global-batch step")

    def blocks(self, world: int) -> int:
        """Data blocks of the global batch over ``world`` ranks."""
        return world if self.grid is None else self.grid[0]

    @property
    def config(self) -> DepthUNetConfig:
        return _config(self)


def _config(spec) -> DepthUNetConfig:
    """The model of a :class:`StepSpec` or :class:`PredictSpec`."""
    return DepthUNetConfig(unet_type=spec.unet_type,
                           encoder_filters=tuple(spec.filters),
                           embedding_dim=spec.dim,
                           dtype=torch.bfloat16 if spec.bf16 else None)


@contextlib.contextmanager
def native_cpu_convolutions(bf16: bool, device):
    """A bf16 step on the CPU runs without oneDNN: its bf16 convolutions'
    weight gradients differ from run to run there (some entries come back
    NaN once in a few runs), where the native ones are deterministic."""
    if not (bf16 and torch.device(device).type == "cpu"):
        yield
        return
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


def step_inputs(spec: StepSpec, world: int, device: torch.device):
    """The global batch of ``world`` ranks' rows (rank r's are rows
    ``r * batch .. (r+1) * batch`` of every microbatch), the text table and
    the two similarity matrices, from numpy's generator: the same numbers
    on every device."""
    rng = np.random.default_rng(spec.seed + 1)
    shape = (spec.accum, world * spec.batch, spec.res, spec.res)
    seg = rng.integers(0, spec.present, shape).astype(np.int32)
    batch = {
        "depth": rng.standard_normal(shape + (1,)).astype(np.float32),
        "segmentation": seg,
        "object_label": seg[:, :, spec.res // 2, spec.res // 2].copy(),
        "image_embeddings": rng.standard_normal(
            shape[:2] + (spec.dim,)).astype(np.float32),
        "sample_valid": np.ones(shape[:2], np.float32),
    }
    text = rng.standard_normal((spec.classes, spec.dim)).astype(np.float32)
    medium = rng.random((spec.classes, spec.classes)) < 3 / spec.classes
    hard = rng.random((spec.classes, spec.classes)) < 3 / spec.classes
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return ({k: put(v) for k, v in batch.items()}, put(text), put(medium),
            put(hard))


def val_inputs(spec: StepSpec, world: int) -> List[Dict[str, np.ndarray]]:
    """``val_batches`` global val batches of ``world * val_batch`` rows
    (numpy, the loader's layout), the last row of each a padded one."""
    rng = np.random.default_rng(spec.seed + 2)
    rows_, res = world * (spec.val_batch or spec.batch), spec.res
    out = []
    for _ in range(spec.val_batches):
        seg = rng.integers(0, spec.present, (rows_, res, res)).astype(
            np.int32)
        valid = np.ones(rows_, np.float32)
        valid[-1] = 0.0
        out.append({
            "depth": rng.standard_normal((rows_, res, res, 1)).astype(
                np.float32),
            "segmentation": seg,
            "object_label": seg[:, res // 3, res // 3].copy(),
            "sample_valid": valid,
            "image": rng.random((rows_, res, res, 3)).astype(np.float32),
            "object_bbox": np.tile(np.array([0, 0, res // 2, res // 2],
                                            np.int32), (rows_, 1)),
        })
    return out


def validate_rows(model, spec: StepSpec, world: int, rank_id: int,
                  device: torch.device, group=None) -> Dict:
    """``validate_model`` over ``group`` (a process group of ``world``
    ranks, or a grid of ``world`` data blocks) on rows ``rank_id * batch
    ..`` of each of :func:`val_inputs`' batches (every row without
    ``group``; on a grid, ``rank_id`` is the data block, whose rows every
    rank of it is fed), with the spec's tables, identity equivalences and
    the hash image stub."""
    from rangeclip_tpu_torch.evals.validate import validate_model
    from rangeclip_tpu_torch.models.clip.provider import HashImageEmbedder

    per = (spec.val_batch or spec.batch) * (world if group is None else 1)
    batches = [{k: v[rank_id * per:(rank_id + 1) * per] for k, v in b.items()}
               for b in val_inputs(spec, world)]
    _, text, medium, hard = step_inputs(spec, world, device)
    eq = torch.eye(spec.classes, dtype=torch.bool, device=device)
    return validate_model(
        model, batches, text, medium, hard, eq,
        torch.arange(spec.classes, device=device),
        {"pct_medium": 0.3, "pct_hard": 0.5}, HashImageEmbedder(spec.dim), 0,
        {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0}, group=group)


def single_device_validation(spec: StepSpec, world: int,
                             device: torch.device) -> Dict:
    """Sharded validation's oracle: ``validate_model`` on one device over
    the whole global batches of ``world`` ranks (of the spec's data blocks
    on a grid), with the ranks' initial weights."""
    set_precision(spec.bf16)
    model = create_train_state(spec.config, device, spec.weight_decay,
                               spec.seed).model
    return validate_rows(model, spec, spec.blocks(world), 0, device)


def rows(batch: Dict[str, torch.Tensor], rank: int, per: int
         ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s rows of every microbatch."""
    return {k: v[:, rank * per:(rank + 1) * per].contiguous()
            for k, v in batch.items()}


def _snapshot(state: TrainState, info: Dict[str, torch.Tensor]) -> Dict:
    model = state.model
    return {
        "params": {n: p.detach().cpu().clone()
                   for n, p in model.named_parameters()},
        "grads": {n: p.grad.detach().cpu().clone()
                  for n, p in model.named_parameters() if p.grad is not None},
        "stats": {n: b.detach().cpu().clone()
                  for n, b in model.named_buffers()},
        "info": {k: float(v) for k, v in info.items()},
    }


@dataclasses.dataclass(frozen=True)
class PredictSpec:
    """A predict on a process grid (``predict.make_grid_predict``) of the
    world's first ranks: ``grid`` (data, spatial, model), the model's
    architecture (as :class:`StepSpec`'s) and widths, ``batch`` images of
    ``res``^2, a table of ``classes`` rows, ``top_k``, bf16 or f32,
    weights and inputs from ``seed``."""

    grid: Tuple[int, int, int] = (1, 2, 1)
    unet_type: str = "resnet"
    filters: Tuple[int, ...] = (8, 16, 16, 16, 32)
    dim: int = 32
    res: int = 32
    batch: int = 4
    classes: int = 61
    top_k: int = 3
    bf16: bool = False
    seed: int = 0

    @property
    def config(self) -> DepthUNetConfig:
        return _config(self)


def predict_inputs(spec: PredictSpec, device: torch.device):
    """(the eval-mode model, depth [B, res, res, 1], table [C, D]) of a
    :class:`PredictSpec`, from CPU generators: the same on every device."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNet

    model = DepthUNet(spec.config, device=device,
                      generator=torch.Generator().manual_seed(spec.seed)
                      ).eval()
    gen = torch.Generator().manual_seed(spec.seed + 2)
    depth = torch.randn(spec.batch, spec.res, spec.res, 1, generator=gen)
    table = torch.randn(spec.classes, spec.dim, generator=gen)
    return model, depth.to(device), table.to(device)


def _grid_predict(spec: PredictSpec, grid, dev: torch.device) -> Dict:
    """This rank's part of a grid predict: the whole map of labels
    (gathered) and the launches of its predict call."""
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.parallel.predict import (
        gather_label_blocks,
        make_grid_predict,
        pad_class_table,
    )

    set_precision(spec.bf16)
    model, depth, table = predict_inputs(spec, dev)
    padded, ids = pad_class_table(table, grid.n_model)
    fn = make_grid_predict(model, grid, spec.top_k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _lib.reset_launch_counts()
    labels = fn(depth, padded, ids)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(_lib.launch_counts)
    return {"labels": gather_label_blocks(labels, grid).cpu(),
            "launches": launches}


def _rank_main(rank_id: int, world_size: int, init_method: str,
               specs: Sequence, device: str,
               backend: Optional[str], out_dir: str) -> None:
    """One rank: join the group, then one step per :class:`StepSpec` on
    this rank's rows (after the spec's validation, if any) or one predict
    per :class:`PredictSpec`; write what it ended with, and its kernel
    launches (None for a spec whose grid leaves this rank out).  Every
    rank creates every spec's grid, in spec order."""
    import torch.distributed as dist

    from rangeclip_tpu_torch.ops.kernels import _lib

    dev = init_distributed(init_method, world_size, rank_id, backend=backend,
                           device=device)
    grids: Dict[Tuple[int, int, int], object] = {}

    def grid_of(shape):
        if shape not in grids:
            grids[shape] = make_grid(*shape)
        return grids[shape]

    try:
        out = []
        for spec in specs:
            if isinstance(spec, PredictSpec):
                grid = grid_of(spec.grid)
                out.append(None if grid is None
                           else _grid_predict(spec, grid, dev))
                continue
            set_precision(spec.bf16)  # f32 keeps cuDNN and cuBLAS off TF32
            state = create_train_state(spec.config, dev, spec.weight_decay,
                                       spec.seed)
            replicate(state.model, dist.group.WORLD)
            grid = None if spec.grid is None else grid_of(spec.grid)
            if spec.grid is not None and grid is None:
                out.append(None)
                continue
            val = None
            if spec.val_batches:
                _lib.reset_launch_counts()
                val = {"results": validate_rows(
                    state.model, spec, spec.blocks(world_size),
                    rank_id if grid is None else grid.d, dev,
                    dist.group.WORLD if grid is None else grid)}
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                val["launches"] = dict(_lib.launch_counts)
            batch, text, medium, hard = step_inputs(
                spec, spec.blocks(world_size), dev)
            if grid is None:
                batch = rows(batch, rank_id, spec.batch)
                group = dist.group.WORLD
            else:
                batch = grid.local_batch(batch, batch_axis=1)
                text, medium, hard = shard_class_tables(
                    text, medium, hard, spec.shard_classes, grid)
                group = grid
            step = make_train_step(HybridLossConfig(), spec.accum,
                                   ddp_parity=spec.mode == "ddp_parity",
                                   group=group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _lib.reset_launch_counts()
            with native_cpu_convolutions(spec.bf16, dev):
                state, info = step(state, batch, (spec.seed, 0), spec.lr,
                                   0.3, 0.5, text, medium, hard)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result = _snapshot(state, info)
            result["launches"] = dict(_lib.launch_counts)
            result["val"] = val
            out.append(result)
        torch.save(out, os.path.join(out_dir, f"rank{rank_id}.pt"))
    finally:
        shutdown_distributed()


def run_ranks(n: int, specs: Sequence, device: str = "cuda",
              backend: Optional[str] = None) -> List[List[Dict]]:
    """Spawn ``n`` ranks, each taking one step per :class:`StepSpec` (in
    the spec's mode) or one predict per :class:`PredictSpec`; returns
    ``results[rank][spec]`` (parameters, gradients, buffers and info after
    the step, or the predict's whole labels, and the rank's kernel
    launches; None where a spec's grid leaves the rank out).  On CUDA the
    kernels are built here first, not by every rank at once.  Every
    process is joined before it returns."""
    import torch.multiprocessing as mp

    if device == "cuda":
        from rangeclip_tpu_torch.ops.kernels import _lib

        _lib.build()

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n, f"file://{tmp}/store", list(specs),
                                   device, backend, tmp), nprocs=n,
                 join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(n)]


def simulate_ddp_step(spec: StepSpec, world_size: int,
                      device: torch.device) -> Dict:
    """The ``ddp_parity`` step of ``world_size`` ranks, one replica per
    rank in this process (JAX's per-shard oracle,
    ``tests/test_parallel.py:229-307``): each replica's microbatch loss on
    its rows with that rank's generator, the replicas' BatchNorm running
    statistics averaged after each microbatch, the gradients (each rank's
    sum over the window over A) averaged after it, then Adam on replica
    0."""
    set_precision(spec.bf16)
    replicas = [create_train_state(spec.config, device, spec.weight_decay,
                                   spec.seed) for _ in range(world_size)]
    batch, text, medium, hard = step_inputs(spec, world_size, device)
    loss_config = HybridLossConfig()
    sums = [None] * world_size
    for state in replicas:
        state.model.train()
        state.model.zero_grad(set_to_none=True)
    for idx in range(spec.accum):
        for r, state in enumerate(replicas):
            mb = {k: v[idx] for k, v in rows(batch, r, spec.batch).items()}
            total, info = microbatch_loss(
                state.model, mb, 0.3, 0.5, text, medium, hard, loss_config,
                generator=microbatch_generator(spec.seed, 0, idx, device, r))
            total.backward()
            info = torch.stack([info[k].detach().float() for k in INFO_KEYS])
            sums[r] = info if sums[r] is None else sums[r] + info
        with torch.no_grad():
            stats = [running_statistics(s.model) for s in replicas]
            for tensors in zip(*stats):
                mean = sum(t for t in tensors) / world_size
                for t in tensors:
                    t.copy_(mean)
    lead = replicas[0]
    params = [list(s.model.parameters()) for s in replicas]
    for ps in zip(*params):
        if ps[0].grad is not None:
            ps[0].grad = sum(p.grad / spec.accum for p in ps) / world_size
    info = sum(s / spec.accum for s in sums) / world_size
    info = dict(zip(INFO_KEYS, info.unbind()))
    set_learning_rate(lead.optimizer, spec.lr)
    lead.optimizer.step()
    return _snapshot(lead, info)


def single_device_step(spec: StepSpec, world_size: int,
                       device: torch.device) -> Dict:
    """The global-batch step's oracle: the single-device step on the
    ``world_size * batch`` rows of every rank, with the generators the
    ranks draw from (``tests/test_parallel.py:77``, JAX's layout
    invariance)."""
    set_precision(spec.bf16)
    state = create_train_state(spec.config, device, spec.weight_decay,
                               spec.seed)
    batch, text, medium, hard = step_inputs(spec, spec.blocks(world_size),
                                            device)
    step = make_train_step(HybridLossConfig(), spec.accum)
    with native_cpu_convolutions(spec.bf16, device):
        state, info = step(state, batch, (spec.seed, 0), spec.lr, 0.3, 0.5,
                           text, medium, hard)
    return _snapshot(state, info)


def oracle_step(spec: StepSpec, world_size: int,
                device: torch.device) -> Dict:
    """What the ranks of ``spec`` must end with, computed in this
    process."""
    if spec.mode == "global":
        return single_device_step(spec, world_size, device)
    return simulate_ddp_step(spec, world_size, device)


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Ranks against the oracle: the loss (relative), each gradient and
    running statistic (of the tensor's largest magnitude), all gradients
    together (``grads_norm``: the norm of the difference over the norm),
    and ``sgd``: JAX's layout test's tolerance on the parameters after an
    SGD step at lr 1e-3 (rtol 5e-4, atol 5e-6, ``tests/test_parallel.py:
    147``) applied to the gradients, as the largest ratio of an entry's
    gap to its bound (the parameters after the step stand for the initial
    ones: they differ by at most lr); the last two not held by default.
    Parameters move by about lr * sign(g) in Adam's first step, so an
    entry whose gradient is rounding noise may step the other way: all
    within 2 lr (and their f32 rounding), and ``params_close`` of them
    within 1e-3 lr."""

    loss: float = 1e-5
    grads: float = 1e-4
    stats: float = 1e-5
    params_close: float = 0.999
    grads_norm: float = math.inf
    sgd: float = math.inf


# The global-batch step against the single-device step: BatchNorm's
# statistics are combined in another order than on one device, so the
# ranks' values differ in their last bits; the loss, gradients and
# statistics are held as the ddp_parity step's.  Adam's first step moves a
# parameter by about lr * sign(g), so where a gradient entry is rounding
# noise the two sides step apart: 0.99 of the parameters within 1e-3 lr
GLOBAL_TOLERANCE = Tolerance(params_close=0.99)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.double().abs().max()) or 1.0
    return float((a.double() - b.double()).abs().max()) / scale


def check_step(results: Sequence[Dict], sim: Dict, spec: StepSpec,
               tol: Tolerance = Tolerance()) -> Dict:
    """Raise unless every rank ended with rank 0's bits (parameters,
    gradients, running statistics, info) and rank 0 agrees with the
    oracle ``sim`` (:func:`oracle_step`) within ``tol``; returns the
    largest errors."""
    results = [res for res in results if res is not None]
    lead = results[0]
    for r, res in enumerate(results[1:], 1):
        for part in ("params", "grads", "stats"):
            for name, t in lead[part].items():
                if not torch.equal(res[part][name], t):
                    raise AssertionError(f"rank {r}'s {part} {name} differ "
                                         "from rank 0's")
        if res["info"] != lead["info"]:
            raise AssertionError(f"rank {r}'s info differs from rank 0's")
    if sorted(lead["grads"]) != sorted(sim["grads"]):
        raise AssertionError("the ranks and the oracle have gradients "
                             "for different parameters")
    errors = {
        "loss": abs(lead["info"]["total_loss"] - sim["info"]["total_loss"])
        / max(abs(sim["info"]["total_loss"]), 1e-30),
        "grads": max(_rel(lead["grads"][n], g)
                     for n, g in sim["grads"].items()),
        "stats": max(_rel(lead["stats"][n], s)
                     for n, s in sim["stats"].items()
                     if s.is_floating_point()),
        "grads_norm": math.sqrt(
            sum(float((lead["grads"][n].double() - g.double()).square().sum())
                for n, g in sim["grads"].items())
            / max(sum(float(g.double().square().sum())
                      for g in sim["grads"].values()), 1e-300)),
        "sgd": max(float((1e-3 * (lead["grads"][n].double() - g.double())
                          .abs() / (5e-6 + 5e-4 * sim["params"][n].double()
                                    .abs())).max())
                   for n, g in sim["grads"].items()),
    }
    close = total = 0
    apart = []
    for name, want in sim["params"].items():
        diff = (lead["params"][name].double() - want.double()).abs()
        # Adam's first steps apart, and each side's f32 rounding
        ulps = 2 * torch.finfo(torch.float32).eps * want.double().abs()
        if not bool((diff <= 2 * spec.lr + ulps).all()):
            apart.append(name)
        close += int((diff <= 1e-3 * spec.lr).sum())
        total += diff.numel()
    errors["params_close"] = close / total
    failed = [f"{key} {errors[key]:.3g} > {getattr(tol, key)}"
              for key in ("loss", "grads", "stats", "grads_norm", "sgd")
              if not errors[key] <= getattr(tol, key)]
    if errors["params_close"] < tol.params_close:
        failed.append(f"params_close {errors['params_close']:.6f} < "
                      f"{tol.params_close}")
    if apart:
        failed.append(f"parameters more than 2 lr apart: {apart[:5]}")
    if failed:
        raise AssertionError(f"the ranks against the oracle: "
                             f"{'; '.join(failed)} (errors {errors})")
    return errors


def check_sharded_predict(n: int, device: str = "cuda") -> Dict:
    """A sharded predict on a ``2 x n/2`` grid (``cuda:(i % device
    count)`` or the CPU, repeated) against single-device predict, folded
    and default, in f32: the labels must be equal."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNet, predict_folded
    from rangeclip_tpu_torch.parallel.mesh import make_mesh
    from rangeclip_tpu_torch.parallel.predict import (
        make_sharded_predict,
        pad_class_table,
    )

    if n % 2:
        raise ValueError(f"the predict grid is 2 x n/2: n={n} is odd")
    count = torch.cuda.device_count() if device == "cuda" else 1
    devices = [torch.device(device, i % count) if device == "cuda"
               else torch.device("cpu") for i in range(n)]
    home = devices[0]
    spec = StepSpec()
    model = DepthUNet(spec.config, device=home,
                      generator=torch.Generator().manual_seed(spec.seed)
                      ).eval()
    gen = torch.Generator().manual_seed(spec.seed + 2)
    depth = torch.randn(4, spec.res, spec.res, 1, generator=gen).to(home)
    table = torch.randn(61, spec.dim, generator=gen).to(home)
    mesh = make_mesh(2, n // 2, devices)
    padded, ids = pad_class_table(table, n // 2)
    want = {"folded": predict_folded(model, depth, table, top_k=3),
            "default": model.predict(depth, table, None, 3,
                                     return_embeddings=False)[0]}
    for path, labels in want.items():
        got = make_sharded_predict(model, mesh, 3, path)(depth, padded, ids)
        differ = int((got != labels).sum())
        if differ:
            raise AssertionError(f"sharded predict ({path}, 2 x {n // 2}): "
                                 f"{differ} labels differ")
    return {"grid": [2, n // 2], "labels": int(depth[..., 0].numel()) * 3}


def near_ties(got: torch.Tensor, want: torch.Tensor, model, depth,
              table: torch.Tensor, tol: float) -> int:
    """The entries in which two predicts' labels [B, H, W, k] of ``model``
    on ``depth`` over ``table`` differ, each required to be a near-tie:
    its two ids' cosine scores on the single-device native field within
    ``tol`` (a convolution over a block of rows may round otherwise than
    over the whole map); raises otherwise."""
    from rangeclip_tpu_torch.utils.math import l2_normalize

    differ = int((got != want).sum())
    if not differ:
        return 0
    with torch.no_grad():
        field = l2_normalize(model.native_field(depth, normalize=False)
                             .float(), dim=-1)
    up = got.shape[1] // field.shape[1]
    scores = (field @ l2_normalize(table.float(), dim=-1).T).cpu()
    g = got[:, ::up, ::up].long().cpu()
    w = want[:, ::up, ::up].long().cpu()
    gap = (scores.gather(-1, g.clamp_min(0))
           - scores.gather(-1, w.clamp_min(0))).abs()
    far = int(((g != w) & ((gap > tol) | (g < 0) | (w < 0))).sum())
    if far:
        raise AssertionError(f"{differ} labels differ, {far} of them by "
                             f"more than {tol} of the cosine")
    return differ


def check_grid_predict(ranks: Sequence[Optional[Dict]], spec: PredictSpec,
                       device: torch.device, tol: float = 1e-5) -> Dict:
    """A grid predict's ranks (:func:`run_ranks`) against the ``data x
    model`` predict of one process (``make_sharded_predict`` on a
    ``(data * spatial) x model`` device grid, JAX's check of its spatial
    layout): every rank gathered the same map, and the labels are equal
    but for near-ties (:func:`near_ties`, counted)."""
    from rangeclip_tpu_torch.parallel.mesh import make_mesh
    from rangeclip_tpu_torch.parallel.predict import (
        make_sharded_predict,
        pad_class_table,
    )

    got = [r["labels"] for r in ranks if r is not None]
    if any(not torch.equal(g, got[0]) for g in got[1:]):
        raise AssertionError("the grid's ranks gathered different maps")
    set_precision(spec.bf16)
    model, depth, table = predict_inputs(spec, device)
    n_data, n_spatial, n_model = spec.grid
    mesh = make_mesh(n_data * n_spatial, n_model,
                     [device] * (n_data * n_spatial * n_model))
    padded, ids = pad_class_table(table, n_model)
    with torch.no_grad():
        want = make_sharded_predict(model, mesh, spec.top_k, "default")(
            depth, padded, ids).cpu()
    if got[0].shape != want.shape:
        raise AssertionError(f"grid predict {tuple(got[0].shape)} against "
                             f"{tuple(want.shape)}")
    return {"grid": list(spec.grid), "labels": want.numel(),
            "near_ties": near_ties(got[0], want, model, depth, table, tol)}


# the bf16 packed-CE step at C = 2048 (tests/test_parallel.py:538): the
# model-sharded grid against a data-only grid of the same global batch
LARGE_C = dict(bf16=True, classes=2048, present=16)
LARGE_C_TOLERANCE = Tolerance(loss=5e-3, grads=math.inf, stats=math.inf,
                              params_close=0.0, grads_norm=0.1)


def layout(n: int) -> Tuple[int, int, int]:
    """JAX's dry-run mesh for ``n`` devices (``__graft_entry__.py:
    164-170``): (data, spatial, model), 'model' 2 when n is even, 'spatial'
    2 when 4 divides n."""
    n_model = 2 if n % 2 == 0 else 1
    n_spatial = 2 if n % 4 == 0 else 1
    return n // (n_model * n_spatial), n_spatial, n_model


def dryrun_multichip(n: int, device: str = "cuda",
                     backend: Optional[str] = None) -> Dict:
    """Build the kernels (CUDA), run ``n`` ranks of the global-batch step
    on JAX's layout, of the ``ddp_parity`` step, of the grid's predict
    (with a 'spatial' axis) and of the model-sharded packed-CE step (with
    a 'model' axis) against their oracles, then the ``2 x n/2`` device-grid
    predict; raises on any difference, returns a summary (``loss`` and
    ``errors`` of the ``ddp_parity`` step, ``global``, ``grid_predict`` and
    ``large_c``)."""
    n_data, n_spatial, n_model = grid = layout(n)
    # a global batch of 8 rows whatever the layout: at 2 rows the deepest
    # BatchNorm (1 x 1 maps) rounds its statistics apart by 3e-4
    specs: List = [StepSpec(mode="global", grid=grid,
                            shard_classes=n_model > 1,
                            batch=max(1, 8 // n_data)),
                   StepSpec(mode="ddp_parity")]
    if n_spatial > 1:
        specs.append(PredictSpec(grid=grid, batch=2 * n_data * n_spatial))
    if n_model > 1:
        specs += [StepSpec(**LARGE_C, grid=(n // n_model, 1, n_model),
                           shard_classes=True, batch=n_model),
                  StepSpec(**LARGE_C, grid=(n, 1, 1), batch=1)]
    results = run_ranks(n, specs, device, backend)
    home = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    summary: Dict = {"ranks": n, "layout": list(grid), "backend": backend or (
        "nccl" if device == "cuda" else "gloo")}
    launches: Dict[str, int] = {}
    for i, spec in enumerate(specs):
        ranks = [r[i] for r in results]
        for res in ranks:
            for k, v in (res or {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        if isinstance(spec, PredictSpec):
            summary["grid_predict"] = check_grid_predict(ranks, spec, home)
            continue
        if spec.classes == LARGE_C["classes"]:
            continue
        errors = check_step(ranks, oracle_step(spec, n, home), spec,
                            GLOBAL_TOLERANCE if spec.mode == "global"
                            else Tolerance())
        part = {"loss": next(r for r in ranks if r)["info"]["total_loss"],
                "errors": errors}
        if spec.mode == "global":
            summary["global"] = part
        else:
            summary.update(part)
    if n_model > 1:
        sharded, data_only = ([r[i] for r in results]
                              for i in (len(specs) - 2, len(specs) - 1))
        lead = data_only[0]
        loss = next(r for r in sharded if r)["info"]["total_loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite C=2048 packed-CE loss {loss}")
        summary["large_c"] = {
            "loss": loss, "data_only_loss": lead["info"]["total_loss"],
            "errors": check_step(sharded, lead, specs[-2],
                                 LARGE_C_TOLERANCE)}
    summary["predict"] = check_sharded_predict(n, device)
    summary["launches"] = {k: v for k, v in launches.items() if v}
    return summary


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("n", type=int, help="ranks (even)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    summary = dryrun_multichip(args.n, args.device, args.backend)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
