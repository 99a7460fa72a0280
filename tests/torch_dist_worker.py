"""One rank of the port's multi-process CPU tests, run as its own process:

    python tests/torch_dist_worker.py MODE RANK WORLD STORE INPUT OUTPUT

It imports torch and the port only (never JAX: the tests' parent has it),
joins a gloo group through the file store ``STORE`` (no port to collide on
under xdist), and writes what the test holds it to into ``OUTPUT``:

* ``ddp``: ``INPUT`` is an ``.npz`` of the global batch, this rank's draws
  (rebuilt by the test from JAX's keys), the table and matrices, and the
  weights; one ``ddp_parity`` step of the port's on this rank's rows, with
  SGD as JAX's test takes it, and the step without ``ddp_parity`` over the
  group, which must raise.
* ``cli``: ``INPUT`` is a JSON list of ``cli.train`` arguments; the run's
  learning rates per epoch, best results and a checksum of its weights.
* ``cli_refuse``: the same, expecting the refusal of item 10b.

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
    try:
        make_train_step(HybridLossConfig(), 2, group=group)
        refusal = ""
    except NotImplementedError as e:
        refusal = str(e)
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
                "info": {k: float(v) for k, v in info.items()},
                "refusal": refusal}, out)
    dist.destroy_process_group()


def _cli(argv, out, refuse):
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
    try:
        best = train.main(argv)
        result = {"lrs": lrs, "best": best, "weights": weights}
    except NotImplementedError as e:
        if not refuse:
            raise
        result = {"refusal": str(e)}
    with open(out, "w") as f:
        json.dump(result, f)


def main():
    mode, rank, world, store, path, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    if mode == "ddp":
        _ddp(rank, world, store, path, out)
        return
    with open(path) as f:
        argv = json.load(f) + ["--coordinator_address", f"file://{store}",
                               "--num_processes", str(world),
                               "--process_id", str(rank)]
    _cli(argv, out, refuse=mode == "cli_refuse")


if __name__ == "__main__":
    main()
