"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, and the result line.

Everything that belongs to a cell is read by name from files under
``portbench/``: the manifest's entry (``BENCHMARK.json``), the cell's
parameters (``workloads/<cell>.json``, with its kind, sizes and limits),
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``).  Two kinds of cell exist: 'train' drives the
program's train step, 'predict' its labels-only predict.

The program under test is ``rangeclip_tpu_torch``; from it the benchmark
takes the model, the train state and step, the predict functions, the
candidate builder and the kernels' launch counts.  Weights, scenes, draws
and tables are the benchmark's, made on the device from the seed, and the
reference (``portbench/reference``) works out from them alone what the
program should have produced.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import scenes
from portbench.reference import loss as ref_loss
from portbench.reference import model as ref_model
from portbench.reference import predict as ref_predict
from portbench.yardstick import (
    ce_cost,
    conv_score_topk_cost,
    label_modules,
    least_seconds,
    percentile,
)

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
MANIFEST = REPO / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "rangeclip_tpu")

# the streams drawn from one seed
WEIGHTS, TABLES, SCENES, DRAWS, CHECK = 1, 2, 3, 4, 5


def sub_seed(seed: int, stream: int) -> int:
    state = np.random.SeedSequence((int(seed) % 2 ** 64, stream))
    return int(state.generate_state(1, np.uint64)[0] % 2 ** 63)


def generator(seed: int, stream: int, device: torch.device
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the manifest's workload entry
    params: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    manifest: dict

    @property
    def kind(self) -> str:
        return self.params["kind"]

    def metrics(self, section: str) -> List[dict]:
        """The manifest's metrics of ``section`` that this cell reports."""
        return [m for m in self.manifest[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, manifest_path: Path = MANIFEST,
              root: Path = ROOT) -> Cell:
    manifest = read_json(manifest_path)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {manifest_path.name}")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])
    return Cell(name, entry, read_json(root / "workloads" / f"{name}.json"),
                read_json(manifest_path.parent / config["file"]),
                read_json(root / "traffic" / f"{entry['traffic']}.json"),
                manifest)


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    import sys

    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


class Clock:
    """Step boundaries on the card's own clock (CUDA events, read after
    the window); on the CPU, which only the tests drive, the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[object] = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) * 1e-3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phases:
    """Seconds from the process's start to the end of each step of
    set-up, the device synced at each."""

    def __init__(self, device: torch.device, t_start: float):
        self.device, self.t_start = device, t_start
        self.at: Dict[str, float] = {}

    def mark(self, name: str) -> float:
        sync(self.device)
        self.at[name] = time.perf_counter() - self.t_start
        return self.at[name]


DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _model_fields(key: str, value) -> dict:
    """The program's ``DepthUNetConfig`` fields that one key of a
    configuration file sets."""
    from rangeclip_tpu_torch.models.depth_unet import norm_fields

    if key == "norm":
        return norm_fields(value)
    if key == "compute_dtype":
        return {"dtype": DTYPES[value]}
    if key == "param_dtype":
        if value != "float32":
            raise ValueError(f"param_dtype {value!r}: the program keeps "
                             "float32 parameters")
        return {}
    if key == "encoder_filters":
        return {key: tuple(int(x) for x in value)}
    cast = {"unet_type": str, "activation": str, "n_layer": int,
            "input_channels": int, "embedding_dim": int,
            "temperature_text": float, "temperature_image": float}
    return {key: cast[key](value)}


# Every key of a configuration file is one of these.  MODEL_KEYS set the
# program's config; the program derives LAYOUT_KEYS from them, and
# ``check_layout`` holds what it built to the file; BENCH_KEYS are the
# benchmark's own (inputs, table, notes).  Any other key is refused, so
# that the program and the reference never read one file two ways.
MODEL_KEYS = ("unet_type", "n_layer", "input_channels", "encoder_filters",
              "embedding_dim", "activation", "norm", "temperature_text",
              "temperature_image", "compute_dtype", "param_dtype")
LAYOUT_KEYS = ("block", "n_blocks", "expansion", "aspp_rates",
               "aspp_groups")
BENCH_KEYS = ("source", "resolution", "num_classes", "assumed")


def port_config(cfg: dict):
    """The program's ``DepthUNetConfig`` of a configuration file, built
    from its own keys."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig

    unknown = sorted(set(cfg) - set(MODEL_KEYS + LAYOUT_KEYS + BENCH_KEYS))
    if unknown:
        raise ValueError(f"configuration keys with no mapping: {unknown}")
    fields = {}
    for key in MODEL_KEYS:
        fields.update(_model_fields(key, cfg[key]))
    return DepthUNetConfig(**fields)


def check_layout(model, cfg: dict) -> None:
    """Holds the program's model to the file's layout keys.  The blocks
    (``block``, ``n_blocks``, ``expansion``) fix the reference's state-dict
    names and shapes, which the model loads strictly; ASPP's rates and
    groups are read off its modules."""
    aspp = model.encoder.aspp
    rates = [int(branch[0].dilation[0]) for branch in aspp.branches]
    groups = {m.num_groups for m in aspp.modules()
              if isinstance(m, torch.nn.GroupNorm)}
    if rates != [int(r) for r in cfg["aspp_rates"]] \
            or groups != {int(cfg["aspp_groups"])}:
        raise ValueError(f"the program's ASPP (rates {rates}, groups "
                         f"{sorted(groups)}) is not the configuration's")


def port_model(cfg: dict, params: dict, device: torch.device):
    """The program's DepthUNet holding the benchmark's weights."""
    from rangeclip_tpu_torch.models.depth_unet import DepthUNet

    model = DepthUNet(port_config(cfg), device=torch.device("meta"))
    model = model.to_empty(device=device)
    model.load_state_dict(params, strict=True)
    check_layout(model, cfg)
    return model


class Inputs:
    """The seed's tables and a pool of scene batches, on the device."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 batch: int, pool: int, draws: bool):
        cfg, mix = cell.config, cell.mix
        C, D = int(cfg["num_classes"]), int(cfg["embedding_dim"])
        shape = tuple(cfg["resolution"])
        g = generator(seed, TABLES, device)
        self.text = scenes.unit_rows(C, D, g, device)
        self.medium = scenes.similarity_sets(C, 3, g, device)
        self.hard = scenes.similarity_sets(C, 3, g, device)
        vocab = scenes.Vocabulary(mix, C, g, device)
        g = generator(seed, SCENES, device)
        self.batches = []
        for k in range(pool):
            b = scenes.make_scenes(vocab, batch, shape, g, k)
            b["image_embeddings"] = scenes.unit_rows(batch, D, g, device)
            b["sample_valid"] = torch.ones(batch, device=device)
            self.batches.append(b)
        self.draws = []
        g = generator(seed, DRAWS, device)
        for _ in range(pool):
            d = {"gumbel": (scenes.gumbel(C, g, device),
                            scenes.gumbel(C, g, device))}
            if draws:
                d["pixels"] = scenes.pixel_draws(
                    batch, shape, float(cell.params["loss"]
                                        ["percent_image_sampling"]),
                    g, device)
            self.draws.append(d)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""
    kind: str
    cell: Cell
    rate: float  # maps/s of the measured window
    dispatch_s: List[float]  # host seconds of each call in the window
    flops_per_map: float
    peak_bytes: int
    trace: Optional[object] = None  # trace.TraceView
    bound_s: float = 0.0  # least seconds of the traced calls' kernel


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: Readings
    checks: Dict[str, Dict[str, float]]
    launches: Dict[str, int]
    setup_s: float
    check_s: float = 0.0  # seconds of the check against the reference
    detail: Optional[dict] = None  # every reading of the check
    phases: Optional[Dict[str, float]] = None  # Phases.at of set-up


def network_flops(cfg: dict, train: bool):
    """(FLOPs, native pixels) of the reference network on one map,
    counted by ``torch.utils.flop_counter`` on meta tensors: the forward,
    and with ``train`` the backward too."""
    from torch.utils.flop_counter import FlopCounterMode

    H, W = cfg["resolution"]
    meta = torch.device("meta")
    spec = ref_model.param_spec(cfg)
    learned = set(ref_model.trainable({k: None for k, *_ in spec}))
    params = {k: torch.empty(s, device=meta, dtype=torch.int64)
              if kind == "count" else
              torch.empty(s, device=meta, requires_grad=train and k in learned)
              for k, s, kind, _ in spec}
    with FlopCounterMode(display=False) as counter:
        field = ref_model.Net(cfg, params, train=train).field(
            torch.empty(1, H, W, 1, device=meta))
        if train:
            field.sum().backward()
    return counter.get_total_flops(), field.shape[1] * field.shape[2]


def flops_train_per_map(cfg: dict, members: float) -> float:
    """The network's forward and backward FLOPs for one map, plus the
    cross-entropy over the mean contrast set, forward and backward."""
    flops, rows = network_flops(cfg, train=True)
    return flops + 3 * 2 * rows * int(cfg["embedding_dim"]) * members


def flops_predict_per_map(cfg: dict, live: float) -> float:
    """The unfolded forward for one map, plus the scoring of its native
    pixels against the live candidates."""
    flops, rows = network_flops(cfg, train=False)
    return flops + 2 * rows * int(cfg["embedding_dim"]) * live


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def measure(call: Callable[[int], object], seconds: float,
            device: torch.device):
    """Run ``call(i)`` back to back for ``seconds`` of the host's clock,
    with no sync between calls; returns (outputs of each call, host
    seconds of each call, the card's seconds between call boundaries, the
    window's seconds from its start to the last call's end)."""
    clock = Clock(device)
    outs, dispatch = [], []
    sync(device)
    t0 = time.perf_counter()
    clock.mark()
    i = 0
    while time.perf_counter() - t0 < seconds:
        h = time.perf_counter()
        outs.append(call(i))
        dispatch.append(time.perf_counter() - h)
        clock.mark()
        i += 1
    sync(device)
    return outs, dispatch, clock.intervals_s(), time.perf_counter() - t0


# ------------------------------------------------------------------ train

def program_train_step(cell: Cell):
    """The program's train step (the window's own call): one microbatch,
    then Adam's update."""
    from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
    from rangeclip_tpu_torch.training.train_step import make_train_step

    return make_train_step(HybridLossConfig(**cell.params["loss"]), 1)


@dataclasses.dataclass
class TrainProgram:
    state: object  # the program's TrainState
    call: Callable[[int], Dict[str, torch.Tensor]]  # step on batch i
    names: Dict[int, str]  # parameter id -> name


def build_train(cell: Cell, seed: int, device: torch.device, inputs: Inputs,
                params: dict) -> TrainProgram:
    from rangeclip_tpu_torch.losses.hybrid import Draws
    from rangeclip_tpu_torch.training.state import create_train_state

    p = cell.params
    model = port_model(cell.config, params, device)
    state = create_train_state(model.config, device, 0.0, model=model)
    step = program_train_step(cell)
    lr, pm, ph = float(p["learning_rate"]), float(p["pct_medium"]), \
        float(p["pct_hard"])
    fed = [({k: v[None] for k, v in b.items()},
            [Draws(pixels=d["pixels"], gumbel=d["gumbel"])])
           for b, d in zip(inputs.batches, inputs.draws)]

    def call(i: int):
        batch, draws = fed[i % len(fed)]
        _, info = step(state, batch, (seed, state.step), lr, pm, ph,
                       inputs.text, inputs.medium, inputs.hard, draws=draws)
        return info

    names = {id(q): n for n, q in model.named_parameters()}
    return TrainProgram(state, call, names)


def _loss_ranges():
    """Wrap the train step's loss calls in a profiler range 'loss' (the
    traced sub-window only); returns the undo."""
    from rangeclip_tpu_torch.training import train_step as module

    saved = {n: getattr(module, n) for n in ("compute_hybrid_loss",
                                             "per_item_masked_pooling")}

    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function("loss"):
                return fn(*args, **kwargs)
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def run_train(cell: Cell, seed: int, seconds: float, trace: bool,
              device: torch.device, t_start: float) -> Outcome:
    from rangeclip_tpu_torch.ops.kernels import _lib

    p, cfg = cell.params, cell.config
    B = int(p["microbatch"])
    pool = int(p["pool_batches"])
    checked = int(p["checked_steps"])
    if pool < checked:
        raise ValueError("the checked steps need batches that all differ")
    phases = Phases(device, t_start)
    phases.mark("started")
    inputs = Inputs(cell, seed, device, B, pool, draws=True)
    phases.mark("inputs")
    params = ref_model.make_params(cfg, generator(seed, WEIGHTS, device),
                                   device)
    prog = build_train(cell, seed, device, inputs, params)
    phases.mark("program")
    opt = prog.state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]

    # set-up: the first steps, each on its own batch, read for the check
    losses, grad_norms, change_norms = [], {}, {}
    for i in range(checked):
        losses.append(prog.call(i)["total_loss"])
        if i == 0:
            for q, st in opt.state.items():
                grad_norms[prog.names[id(q)]] = st["exp_avg"].double(
                ).norm() / (1.0 - beta1)
    for name, q in prog.state.model.named_parameters():
        change_norms[name] = (q.detach() - params[name]).double().norm()
    losses = [float(x) for x in losses]
    grad_norms = {k: float(v) for k, v in grad_norms.items()}
    change_norms = {k: float(v) for k, v in change_norms.items()}
    members = [ref_loss.contrast_mask(
        b["segmentation"], ref_loss.pixel_weights(b["segmentation"],
                                                  d["pixels"]),
        int(cfg["num_classes"]), inputs.medium, inputs.hard,
        int(p["loss"]["k_distractors"]), float(p["pct_medium"]),
        float(p["pct_hard"]), d["gumbel"]).sum().item()
        for b, d in zip(inputs.batches, inputs.draws)]
    setup_s = phases.mark("steps")

    _lib.reset_launch_counts()
    infos, dispatch, steps_s, window_s = measure(
        lambda i: prog.call(checked + i), seconds, device)
    launches = {k: v for k, v in _lib.launch_counts.items() if v}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = len(infos)
    totals = torch.stack([x["total_loss"] for x in infos])
    failed = int((~torch.isfinite(totals)).sum())
    del infos, totals
    rate = n * B / window_s
    end_to_end = {"train_maps_per_s": rate,
                  "train_step_p95_ms": percentile(steps_s, 95) * 1e3}
    readings = Readings("train", cell, rate, dispatch,
                        flops_train_per_map(cfg, float(np.mean(members))),
                        peak)
    if trace:
        from portbench.trace import trace_calls

        used = []
        calls = itertools.count(checked + n)

        def traced():
            i = next(calls)
            used.append(i % pool)
            return prog.call(i)

        undo = _loss_ranges()
        try:
            with label_modules({"encoder": prog.state.model.encoder,
                                "decoder": prog.state.model.decoder}):
                readings.trace = trace_calls(traced, int(p["trace_steps"]))
        finally:
            undo()
        h = cfg["resolution"][0] // 2
        w = cfg["resolution"][1] // 2
        readings.bound_s = sum(least_seconds(*ce_cost(
            B * h * w, int(cfg["embedding_dim"]), 4, members[k]))
            for k in used[1:])
    del prog
    free(device)
    t0 = time.perf_counter()
    checks, detail = check_train(cell, params, inputs, losses, grad_norms,
                                 change_norms, device)
    return Outcome(n, failed, end_to_end, readings, checks, launches,
                   setup_s, time.perf_counter() - t0, detail, phases.at)


def train_gaps(prog: Dict[str, object], ref: Dict[str, object],
               worst_leaves: Optional[Dict[str, str]] = None
               ) -> Dict[str, float]:
    """The numbers of a train check: the largest relative gap of a step's
    loss; by the worst leaf (``grad_gap``, ``change_gap``) and by the
    median leaf (``..._median``) the gap between the program's and the
    reference's norm of the first gradient and of the parameters' change,
    each over that leaf's reference norm or the median leaf's, whichever
    is larger.  The change leaves out leaves whose reference gradient is
    under a thousandth of the median leaf's."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    median_g = float(np.median(list(g_ref.values())))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * median_g]

    out = {"loss_gap": loss}
    for name, p, r, keys in (
            ("grad_gap", prog["grad_norms"], g_ref, list(g_ref)),
            ("change_gap", prog["change_norms"], ref["change_norms"],
             moved)):
        med = float(np.median([r[k] for k in keys]))
        gap = {k: abs(p.get(k, 0.0) - r[k]) / max(r[k], med) for k in keys}
        leaf = max(gap, key=gap.get)
        if worst_leaves is not None:
            worst_leaves[name] = leaf
        out[name] = gap[leaf]
        out[f"{name}_median"] = float(np.median(list(gap.values())))
    return out


def reference_train(cell: Cell, params: dict, inputs: Inputs,
                    device: torch.device, q=None) -> Dict[str, object]:
    n = int(cell.params["checked_steps"])
    with reference_precision(device):
        return ref_loss.reference_steps(
            cell.config, cell.params, params, inputs.batches[:n],
            inputs.draws[:n], inputs.text, inputs.medium, inputs.hard, q)


class reference_precision:
    """float32 with TF32 off, restored on exit."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def check_train(cell: Cell, params: dict, inputs: Inputs, losses,
                grad_norms, change_norms, device: torch.device
                ) -> Dict[str, Dict[str, float]]:
    ref = reference_train(cell, params, inputs, device)
    leaves: Dict[str, str] = {}
    prog = {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms}
    gaps = train_gaps(prog, ref, leaves)
    return compared(cell, gaps, leaves), {"program": prog, "reference": ref,
                                          "gaps": gaps}


def compared(cell: Cell, gaps: Dict[str, float],
             leaves: Optional[Dict[str, str]] = None
             ) -> Dict[str, Dict[str, object]]:
    """The numbers that the cell's file gives a limit, each beside it."""
    leaves = leaves or {}
    return {k: {"value": gaps[k], "limit": float(limit)}
            | ({"leaf": leaves[k]} if k in leaves else {})
            for k, limit in cell.params["limits"].items()}


# ---------------------------------------------------------------- predict

def program_predict(cell: Cell, model, device: torch.device):
    """The program's labels-only predict, by its CLIs' rule for
    ``--predict_path``."""
    from rangeclip_tpu_torch.cli.common import use_folded
    from rangeclip_tpu_torch.models.depth_unet import predict_folded

    p, cfg = cell.params, cell.config
    folded = use_folded(p["predict_path"], int(p["slots"]),
                        int(cfg["embedding_dim"]), int(p["batch"]),
                        model.compute_dtype, device)
    k = int(p["top_k"])

    def predict(depth, text, candidates):
        with torch.inference_mode():
            if folded:
                return predict_folded(model, depth, text, top_k=k,
                                      candidate_indices=candidates)
            return model.predict(depth, text, None, k,
                                 return_embeddings=False,
                                 candidate_indices=candidates)[0]

    return predict


def run_predict(cell: Cell, seed: int, seconds: float, trace: bool,
                device: torch.device, t_start: float) -> Outcome:
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_indices
    from rangeclip_tpu_torch.ops.kernels import _lib

    p, cfg = cell.params, cell.config
    B, pool = int(p["batch"]), int(p["pool_batches"])
    phases = Phases(device, t_start)
    phases.mark("started")
    inputs = Inputs(cell, seed, device, B, pool, draws=False)
    phases.mark("inputs")
    params = ref_model.make_params(cfg, generator(seed, WEIGHTS, device),
                                   device)
    # running statistics: the reference's batch statistics of a few maps
    with reference_precision(device):
        params.update(ref_predict.calibrated_statistics(
            cfg, params, inputs.batches[0]["depth"][:int(
                p["calibration_maps"])]))
    model = port_model(cfg, params, device).eval()
    C = int(cfg["num_classes"])
    cands = [build_candidate_indices(b["segmentation"], C,
                                     int(p["negatives"]), int(p["slots"]),
                                     gumbel=d["gumbel"][0])
             for b, d in zip(inputs.batches, inputs.draws)]
    predict = program_predict(cell, model, device)
    phases.mark("program")

    def call(i: int):
        b = inputs.batches[i % pool]
        return predict(b["depth"], inputs.text, cands[i % pool])

    for i in range(2 * pool):  # every batch's shapes, twice
        call(i)
    live = [ref_predict.candidates(b["segmentation"], C,
                                   int(p["negatives"]), d["gumbel"][0],
                                   int(p["slots"])).numel()
            for b, d in zip(inputs.batches, inputs.draws)]
    setup_s = phases.mark("calls")

    g = np.random.default_rng(sub_seed(seed, CHECK))
    keep = set(g.choice(int(p["check"]["among"]), int(p["check"]["calls"]),
                        replace=False).tolist())
    kept: Dict[int, torch.Tensor] = {}
    last: List[object] = [None]

    def timed(i: int):
        out = call(i)
        if i in keep:
            kept[i] = out
        last[0] = out
        return None

    _lib.reset_launch_counts()
    outs, dispatch, _, window_s = measure(timed, seconds, device)
    launches = {k: v for k, v in _lib.launch_counts.items() if v}
    n = len(outs)
    kept[n - 1] = last[0]  # and the window's last answers
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rate = n * B / window_s
    readings = Readings("predict", cell, rate, dispatch,
                        flops_predict_per_map(cfg, float(np.mean(live))),
                        peak)
    if trace:
        from portbench.trace import trace_calls

        used = []
        calls = itertools.count(n)

        def traced():
            i = next(calls)
            used.append(i % pool)
            return call(i)

        with label_modules({"encoder": model.encoder,
                            "decoder": model.decoder}):
            readings.trace = trace_calls(traced, int(p["trace_calls"]))
        H, W = cfg["resolution"]
        readings.bound_s = sum(least_seconds(*conv_score_topk_cost(
            B, H // 2, W // 2, int(cfg["encoder_filters"][0]), live[k],
            int(p["top_k"])))
            for k in used[1:])
    answers = {i: kept[i].clone() for i in kept}
    del model, predict, kept, outs
    free(device)
    t0 = time.perf_counter()
    with reference_precision(device):
        gaps = ref_predict.answer_gaps(cfg, p, params, inputs, answers, pool,
                                       np.random.default_rng(
                                           sub_seed(seed, CHECK + 1)))
    checks = compared(cell, gaps)
    return Outcome(n, 0, {"predict_maps_per_s": rate}, readings, checks,
                   launches, setup_s, time.perf_counter() - t0,
                   {"gaps": gaps}, phases.at)


KINDS = {"train": run_train, "predict": run_predict}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> Outcome:
    return KINDS[cell.kind](cell, seed, seconds, trace, device, t_start)


def result_line(cell: Cell, out: Outcome, trace: bool,
                device: torch.device) -> dict:
    """The run's JSON result: the cell's end-to-end metrics (or with a
    trace its per-layer ones), the device, and last the checked numbers
    beside their limits."""
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"]
             + cell.manifest["per_layer"]}
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            value = load_reader(m["name"])(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out.readings.peak_bytes}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in out.checks.values()),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    tv = out.readings.trace
    if trace and tv is not None:
        dev["busy_s"] = tv.busy_s
        dev["window_s"] = tv.window_s
        line["breakdown"] = {"device_ops": tv.top_ops(10),
                             "idle_gaps": tv.idle_gaps}
    line["correct"] = line["correct"] and out.failed == 0
    line["checks"] = out.checks
    return line
