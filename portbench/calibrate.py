"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's runs do not run this):

* ``program``: the program's numbers on each of ``--seeds`` (a full run
  with a short window);
* ``control``: the reference computed one precision below the
  configuration's (float8 e4m3 where it states bfloat16) in the
  program's place, against the float32 reference, on ``--control-seeds``;
* ``half_batch`` (train cells): the program's step given half of each
  batch, the mean taken over the rest, on ``--control-seeds``.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] [--out file.jsonl]

One JSON line per reading, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.reference import predict as ref_predict  # noqa: E402


def half_batch_step(make_step):
    """A train step that leaves out the second half of each microbatch."""
    from rangeclip_tpu_torch.losses.hybrid import Draws

    def make(cell):
        step = make_step(cell)

        def half(state, batch, rng, lr, pm, ph, text, medium, hard,
                 draws=None):
            h = batch["depth"].shape[1] // 2
            batch = {k: v[:, :h] for k, v in batch.items()}
            draws = [Draws(pixels=d.pixels[:h], gumbel=d.gumbel)
                     for d in draws]
            return step(state, batch, rng, lr, pm, ph, text, medium, hard,
                        draws=draws)

        return half

    return make


def control_train(cell, seed: int, device) -> dict:
    p = cell.params
    inputs = harness.Inputs(cell, seed, device, int(p["microbatch"]),
                            int(p["checked_steps"]), draws=True)
    params = ref_model.make_params(cell.config, harness.generator(
        seed, harness.WEIGHTS, device), device)
    ref = harness.reference_train(cell, params, inputs, device)
    harness.free(device)
    ctl = harness.reference_train(cell, params, inputs, device,
                                  ref_model.control_round(
                                      cell.config["compute_dtype"]))
    leaves = {}
    gaps = harness.train_gaps(ctl, ref, leaves)
    return dict(gaps, leaves=leaves, detail={"control": ctl,
                                             "reference": ref})


def control_predict(cell, seed: int, device) -> dict:
    p, cfg = cell.params, cell.config
    pool = int(p["pool_batches"])
    inputs = harness.Inputs(cell, seed, device, int(p["batch"]), pool,
                            draws=False)
    params = ref_model.make_params(cfg, harness.generator(
        seed, harness.WEIGHTS, device), device)
    q = ref_model.control_round(cfg["compute_dtype"])
    table_n = torch.nn.functional.normalize(inputs.text.float(), dim=-1)
    with harness.reference_precision(device):
        params.update(ref_predict.calibrated_statistics(
            cfg, params, inputs.batches[0]["depth"][:int(
                p["calibration_maps"])]))
        answers = {}
        for i, (b, d) in enumerate(zip(inputs.batches, inputs.draws)):
            live = ref_predict.candidates(
                b["segmentation"], int(cfg["num_classes"]),
                int(p["negatives"]), d["gumbel"][0], int(p["slots"]))
            picks = ref_predict.reference_picks(cfg, p, params, b["depth"],
                                                live, table_n, q)
            s = cfg["resolution"][0] // picks.shape[1]
            answers[i] = picks.repeat_interleave(s, 1).repeat_interleave(
                s, 2)
        return ref_predict.answer_gaps(cfg, p, params, inputs, answers,
                                       pool, np.random.default_rng(seed))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(kind, seed, values, **extra):
        line = json.dumps(dict(workload=args.workload, kind=kind, seed=seed,
                               values=values, **extra))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds:
        t = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, device, t)
        emit("program", seed, out.checks,
             end_to_end=out.end_to_end, setup_s=out.setup_s,
             check_s=out.check_s, failed=out.failed, detail=out.detail)
        del out
        harness.free(device)
    for seed in control:
        if cell.kind == "train":
            emit("control", seed, control_train(cell, seed, device))
            harness.free(device)
            make = harness.program_train_step
            harness.program_train_step = half_batch_step(make)
            try:
                out = harness.run_cell(cell, seed, 0.5, False, device,
                                       time.perf_counter())
            finally:
                harness.program_train_step = make
            emit("half_batch", seed, out.checks, detail=out.detail)
            del out
        else:
            emit("control", seed, control_predict(cell, seed, device))
        harness.free(device)


if __name__ == "__main__":
    main()
