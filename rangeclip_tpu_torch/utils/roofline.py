"""Roofline attribution of a profiled window (``rangeclip_tpu/utils/
roofline.py``), rebuilt for ``torch.profiler``.

The JAX module parses compiled TPU HLO (``parse_hlo_instructions``); the
port has none, so :func:`records_from_profile` reads a trace instead:

  * every device event of the profiled window (``utils/profiling.
    profile``'s window: the events launched by the window's runtime calls,
    joined by correlation id), or with ``device="cpu"`` every CPU operator
    event in it, by its own CPU time;
  * each event's operator path: the enclosing ``encoder`` / ``decoder`` /
    ``head`` range (:func:`label_modules`; a backward operator takes the
    range of the forward operator that made its autograd node, by sequence
    number), then the operators from the outermost to the one that
    launched it;
  * its bytes and FLOPs: ``aten::convolution`` (and its backward),
    ``mm``, ``addmm``, ``bmm`` and ``linear`` get ``2·MAC`` from the shapes
    ``record_shapes=True`` recorded; the port's own operators get
    :data:`OP_COSTS`' counts, the ones ``chip_smoke.py``'s Bound column
    uses (a masked top-k counts only the classes that can win, a CE only
    its contrast members), read from their arguments as
    :class:`CostRecorder` saw them in an unprofiled call; every other
    operator the bytes of its tensor inputs and, for one that is not in
    place, an output as large as its largest input (exact for elementwise
    operators and copies, an overcount for reductions), with FLOPs 0.  An
    operator's cost goes to its first event once.

:func:`roofline_rows`, :func:`bucket_rows` and :func:`format_interval_table`
are the JAX functions with their semantics unchanged: first match wins,
unmatched rows go to ``other``, attainment = ``max(t_flop, t_byte) / t``.

The same table gives ``torch.utils.flop_counter`` a formula for each of the
port's operators (:func:`flop_counter`), so a kernel's work is counted
whether the kernel or its plain version runs.

The card's peaks (:data:`PEAK_FLOPS`, :data:`PEAK_BYTES_PER_S`) live here
and nowhere else.
"""

from __future__ import annotations

import collections
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet (dense, at the full 700 W): FLOP/s by input
# type (bf16 on the tensor cores, f32 on the CUDA cores) and HBM bytes/s.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Buckets of the interval table: (name, regex on the operator path, then
# on the event name); first match wins.
BUCKETS = [
    ("CE", r"rangeclip::pixel_text_ce"),
    ("TV", r"rangeclip::tv_(rowtile|loss)"),
    ("normalisation", r"rangeclip::l2_normalize"),
    ("head/selection", r"rangeclip::(score_topk|conv_score_topk|"
                       r"pixel_text_topk|head_topk)|^head(/|$)"),
    ("encoder", r"^encoder(/|$)"),
    ("decoder", r"^decoder(/|$)"),
]
LABELS = ("encoder", "decoder", "head")
_EVALUATE = "autograd::engine::evaluate_function"


# ---------------------------------------------------------------- costs

def _live(t: Optional[torch.Tensor]) -> int:
    return int((t != 0).sum()) if t is not None else 0


def _score_topk(scores, ids, top_k, packed, want_values):
    return (scores.numel() * scores.element_size()
            + scores.shape[0] * top_k * 4 * (1 + bool(want_values)), 0)


def _conv_score_topk(features, weight_rows, ids, top_k, want_values):
    B, h, w, c_in = features.shape
    n_pix, live = B * h * w, int((ids >= 0).sum())
    return (features.numel() * features.element_size()
            + live * 9 * c_in * weight_rows.element_size()
            + n_pix * top_k * 4 * (1 + bool(want_values)),
            2 * n_pix * 9 * c_in * live)


def _class_presence(labels, valid, num_classes):
    return labels.numel() * (4 if valid is None else 8) + num_classes, 0


def _pixel_text_topk(field, table, ids, top_k, want_values):
    n, d = field.shape
    live = int((ids >= 0).sum())
    return (field.numel() * field.element_size()
            + live * d * table.element_size()
            + n * top_k * 4 * (1 + bool(want_values)), 2 * n * d * live)


def _l2_normalize(x):
    return 2 * x.numel() * x.element_size(), 0


def _l2_normalize_backward(x, grad):
    return 3 * x.numel() * x.element_size(), 0


def _histogram(idx, n_bins):
    return idx.numel() * 4 + idx.shape[0] * n_bins * 4, 0


def _ce_classes(samples, labels, mask, packed_table, packed_mask,
                use_packed) -> int:
    """The classes the CE scores: the packed capacity on the tensor-core
    route when the device flag selects it, else the members of the table
    the flag selects (a non-member's exp term is 0)."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import tc_route

    packed = packed_table is not None and bool(use_packed)
    if packed and tc_route(samples, packed_table, labels.shape[0]):
        return packed_table.shape[0]
    return _live(packed_mask if packed else mask)


def _pixel_text_ce(samples, temperature, labels, valid, table, mask,
                   packed_table=None, packed_mask=None, packed_ids=None,
                   use_packed=None):
    n, d = samples.shape
    classes = _ce_classes(samples, labels, mask, packed_table, packed_mask,
                          use_packed)
    es = samples.element_size()
    return (n * d * es + labels.numel() * 8 + classes * d * es,
            2 * n * classes * d)


def _pixel_text_ce_backward(grad, stats, samples, *rest):
    nbytes, flops = _pixel_text_ce(samples, *rest)
    return nbytes + samples.numel() * samples.element_size(), 2 * flops


def _field_read(x, *rest):
    return x.numel() * x.element_size(), 0


def _field_read_write(x, *rest):
    return 2 * x.numel() * x.element_size(), 0


def _masked_pooling(embeddings, segmentation, object_indices):
    n_obj, d = object_indices.numel(), embeddings.shape[-1]
    return (embeddings.numel() * embeddings.element_size()
            + segmentation.numel() * 4 + n_obj * 4 + n_obj * (d + 1) * 4,
            embeddings.numel())


def _head_topk(features, rows, table, mask, top_k):
    B, h, w, c_in = features.shape
    n_pix, d = B * h * w, rows.shape[-1]
    return (features.numel() * features.element_size()
            + rows.numel() * rows.element_size()
            + table.numel() * table.element_size() + n_pix * top_k * 8,
            2 * n_pix * (9 * c_in * d + d * _live(mask)))


# (bytes, FLOPs) of one call of each of the port's operators, from its
# arguments
OP_COSTS: Dict[str, Callable[..., Tuple[int, int]]] = {
    "rangeclip::score_topk": _score_topk,
    "rangeclip::conv_score_topk": _conv_score_topk,
    "rangeclip::class_presence": _class_presence,
    "rangeclip::pixel_text_topk": _pixel_text_topk,
    "rangeclip::l2_normalize": _l2_normalize,
    "rangeclip::l2_normalize_backward": _l2_normalize_backward,
    "rangeclip::histogram": _histogram,
    "rangeclip::pixel_text_ce": _pixel_text_ce,
    "rangeclip::pixel_text_ce_backward": _pixel_text_ce_backward,
    "rangeclip::pixel_text_ce_slots": _pixel_text_ce,
    "rangeclip::pixel_text_ce_slots_backward": _pixel_text_ce_backward,
    "rangeclip::tv_rowtile": _field_read,
    "rangeclip::tv_rowtile_backward": _field_read_write,
    "rangeclip::masked_pooling": _masked_pooling,
    "rangeclip::head_topk": _head_topk,
    "rangeclip::tv_loss": _field_read,
    "rangeclip::tv_loss_backward": _field_read_write,
}


def _operator_packets():
    """{name: overload packet} of the port's operators (their modules
    define them when imported)."""
    import importlib

    for module in ("class_presence", "conv_score_topk", "head_topk",
                   "histogram", "l2_normalize", "masked_pooling",
                   "pixel_text_ce", "pixel_text_topk", "score_topk",
                   "tv_loss", "tv_rowtile"):
        importlib.import_module(f"rangeclip_tpu_torch.ops.kernels.{module}")
    return {name: getattr(torch.ops.rangeclip, name.split("::")[1])
            for name in OP_COSTS}


def register_flop_formulas() -> None:
    """Give ``torch.utils.flop_counter`` the FLOPs of :data:`OP_COSTS` for
    each of the port's operators (once per process)."""
    from torch.utils import flop_counter

    for name, packet in _operator_packets().items():
        if packet in flop_counter.flop_registry:
            continue
        cost = OP_COSTS[name]
        flop_counter.register_flop_formula(packet, get_raw=True)(
            lambda *args, out_val=None, _cost=cost, **kwargs:
            _cost(*args, **kwargs)[1])


def flop_counter():
    """A ``FlopCounterMode`` (no display) that counts the port's operators
    with :data:`OP_COSTS`' FLOPs: ``with flop_counter() as fc: ...;
    fc.get_total_flops()``."""
    from torch.utils.flop_counter import FlopCounterMode

    register_flop_formulas()
    return FlopCounterMode(display=False)


class CostRecorder(TorchDispatchMode):
    """Records (bytes, FLOPs) of every call of the port's operators made
    under it, by operator name in call order (``costs``)."""

    def __init__(self):
        super().__init__()
        self.costs: Dict[str, List[Tuple[int, int]]] = (
            collections.defaultdict(list))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in OP_COSTS:
            self.costs[name].append(OP_COSTS[name](*args, **kwargs))
        return out


# ------------------------------------------------- costs from the profiler

_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
    "int": 4, "long int": 8, "long": 8, "bool": 1, "unsigned char": 1,
    "signed char": 1, "short int": 2, "short": 2,
}


def _tensor_args(event, dtypes) -> List[Tuple[List[int], int]]:
    """(shape, element size) of each tensor input of an operator event."""
    out = []
    for i, shape in enumerate(event.input_shapes or []):
        dtype = dtypes[i] if dtypes and i < len(dtypes) else "float"
        size = _DTYPE_BYTES.get(dtype, 0)
        if size and isinstance(shape, (list, tuple)) and all(
                isinstance(v, int) for v in shape):
            out.append((list(shape), size))
    return out


def _concrete(event, index, default):
    values = getattr(event, "concrete_inputs", None) or []
    value = values[index] if index < len(values) else None
    return default if value is None else value


def _conv_geometry(event, inp, weight, at: int) -> Tuple[int, int]:
    """(MACs, output elements) of a convolution of ``inp`` [N, C, *S] by
    ``weight``, from the stride, padding, dilation, transposed,
    output_padding and groups recorded from input ``at`` on (stride 1 and
    SAME padding where they were not recorded)."""
    n, spatial, kernel = inp[0], inp[2:], weight[2:]
    dims = len(spatial)
    stride = _concrete(event, at, [1] * dims)
    padding = _concrete(event, at + 1, [k // 2 for k in kernel])
    dilation = _concrete(event, at + 2, [1] * dims)
    if _concrete(event, at + 3, False):  # transposed: [C_in, O/g, *k]
        out_pad = _concrete(event, at + 4, [0] * dims)
        groups = _concrete(event, at + 5, 1)
        out = [(s - 1) * st - 2 * p + d * (k - 1) + op + 1
               for s, k, st, p, d, op in zip(spatial, kernel, stride,
                                             padding, dilation, out_pad)]
        return (n * math.prod(spatial) * math.prod(weight),
                n * weight[1] * groups * math.prod(out))
    out = [(s + 2 * p - d * (k - 1) - 1) // st + 1
           for s, k, st, p, d in zip(spatial, kernel, stride, padding,
                                     dilation)]
    return (n * math.prod(out) * math.prod(weight),
            n * weight[0] * math.prod(out))


# operators that move no data (views, metadata)
_NO_DATA = ("aten::view", "aten::_unsafe_view", "aten::as_strided",
            "aten::as_strided_", "aten::t", "aten::transpose",
            "aten::permute", "aten::expand", "aten::reshape", "aten::select",
            "aten::slice", "aten::unsqueeze", "aten::squeeze",
            "aten::detach", "aten::alias", "aten::resolve_conj",
            "aten::resolve_neg", "aten::resize_", "aten::lift_fresh",
            "aten::_reshape_alias", "aten::unflatten", "aten::flatten")


def aten_cost(event, dtypes) -> Tuple[float, float]:
    """(bytes, FLOPs) of an aten operator event from its recorded shapes."""
    args = _tensor_args(event, dtypes)
    name = event.name
    if not args or name in _NO_DATA:
        return 0.0, 0.0
    nbytes = sum(math.prod(s) * e for s, e in args)
    es = args[0][1]
    if name == "aten::convolution" and len(args) >= 2:
        mac, out = _conv_geometry(event, args[0][0], args[1][0], 3)
        return nbytes + out * es, 2.0 * mac
    if name == "aten::convolution_backward" and len(args) >= 3:
        inp, weight = args[1][0], args[2][0]
        mac, _ = _conv_geometry(event, inp, weight, 4)
        mask = _concrete(event, 10, [True, True, True])
        outs = (math.prod(inp) if mask[0] else 0) + (
            math.prod(weight) if mask[1] else 0)
        return nbytes + outs * es, 2.0 * mac * (int(mask[0]) + int(mask[1]))
    if name == "aten::linear" and len(args) >= 2:
        inp, weight = args[0][0], args[1][0]
        rows = math.prod(inp[:-1])
        return (nbytes + rows * weight[0] * es,
                2.0 * rows * weight[0] * weight[1])
    if name in ("aten::mm", "aten::addmm", "aten::bmm") and len(args) >= 2:
        a, b = args[-2][0], args[-1][0]
        batch = a[0] if name == "aten::bmm" else 1
        n, k, m = a[-2], a[-1], b[-1]
        return nbytes + batch * n * m * es, 2.0 * batch * n * k * m
    if name.endswith("_"):  # in place: the first input is the output
        return float(nbytes), 0.0
    return float(nbytes + max(math.prod(s) * e for s, e in args)), 0.0


FLOP_OPS = ("aten::convolution", "aten::convolution_backward", "aten::mm",
            "aten::addmm", "aten::bmm", "aten::linear")


def _dtype_lookup(prof) -> Callable:
    """event -> its input dtypes: the FunctionEvent's own where this torch
    keeps them, else (torch 2.11) the kineto event's of the same
    correlation id."""
    table = None

    def dtypes(event):
        nonlocal table
        own = getattr(event, "input_dtypes", None)
        if own is not None:
            return own
        if table is None:
            table = {k.correlation_id(): k.dtypes()
                     for k in prof.profiler.kineto_results.events()
                     if k.device_type() == DeviceType.CPU}
        return table.get(event.id)

    return dtypes


def _chain(event, stop) -> List[object]:
    """``event`` and its ancestors, innermost first, below ``stop``."""
    out = []
    while event is not None and event is not stop:
        out.append(event)
        event = event.cpu_parent
    return out


def records_from_profile(prof, calls: int = 1,
                         op_costs: Optional[Dict[str, List]] = None,
                         device: str = "cuda"
                         ) -> Tuple[List[Tuple[str, float, str]],
                                    Dict[str, Dict[str, float]]]:
    """The window of a trace taken with ``record_shapes=True`` (the
    ``profiler`` of ``utils/profiling.profile``, or any trace holding its
    window range) -> ``(trace_rows, instrs)`` in :func:`roofline_rows`'
    form: ``trace_rows`` [(event key, ms per call, operator path)],
    ``instrs`` {event key: {bytes, flops, op}} per call.  ``op_costs`` is a
    :class:`CostRecorder`'s ``costs`` for one call: the k-th event of a
    port operator in the window takes its (k mod n)-th cost; without it
    those operators are costed like any other.  ``device="cuda"`` reads
    device events, ``"cpu"`` the CPU operators' own time; neither falls
    back to the other."""
    from rangeclip_tpu_torch.utils.profiling import WINDOW, window_events

    traced = prof.events()
    dtypes = _dtype_lookup(prof)
    if device == "cuda":
        window, runtime, events = window_events(traced)
        by_id = {e.id: e for e in runtime}
        timed = [(e.name, e.time_range.elapsed_us(),
                  _chain(by_id[e.id].cpu_parent, window)) for e in events]
    elif device == "cpu":
        window = next(e for e in traced if e.name == WINDOW
                      and e.device_type == DeviceType.CPU)
        timed = []
        for e in traced:
            chain = _chain(e, window)
            if (e is not window and e.device_type == DeviceType.CPU
                    and chain and chain[-1].cpu_parent is window):
                timed.append((e.name, e.self_cpu_time_total, chain))
    else:
        raise ValueError(f"records_from_profile: device {device!r}")

    # the range label of each forward operator, by its sequence number
    seq_label = {}
    for e in traced:
        if e.device_type == DeviceType.CPU and e.sequence_nr >= 0 \
                and not e.name.startswith(_EVALUATE):
            label = _label(_chain(e, None), seq_label)
            if label:
                seq_label.setdefault(e.sequence_nr, label)

    seen, occurrences = set(), collections.Counter()
    trace_rows, instrs = [], {}
    # in the order of the operators that launched them: the k-th call of a
    # port operator meets its k-th recorded cost
    timed.sort(key=lambda t: t[2][0].time_range.start if t[2] else 0.0)
    for i, (name, us, chain) in enumerate(timed):
        label = _label(chain, seq_label)
        ops = [e.name for e in reversed(chain) if e.name not in LABELS]
        path = "/".join(([label] if label else []) + ops)
        nbytes = flops = 0.0
        costed = next((e for e in reversed(chain)
                       if e.name in OP_COSTS or e.name in FLOP_OPS), None)
        owner = costed or (chain[0] if chain else None)
        if owner is not None and id(owner) not in seen and (
                costed is not None or device == "cuda"
                or not owner.cpu_children):
            seen.add(id(owner))
            if owner.name in OP_COSTS and op_costs \
                    and op_costs.get(owner.name):
                recorded = op_costs[owner.name]
                nbytes, flops = recorded[occurrences[owner.name]
                                         % len(recorded)]
                occurrences[owner.name] += 1
            else:
                nbytes, flops = aten_cost(owner, dtypes(owner))
        key = f"{name}#{i}"
        trace_rows.append((key, us / calls / 1e3, path))
        instrs[key] = {"bytes": nbytes / calls, "flops": flops / calls,
                       "op": path}
    return trace_rows, instrs


def _label(chain, seq_label) -> str:
    for e in chain:
        if e.name in LABELS:
            return e.name
        if e.name.startswith(_EVALUATE) and e.sequence_nr in seq_label:
            return seq_label[e.sequence_nr]
    return ""


class label_modules:
    """Context that opens a profiler range named ``name`` around every
    forward of each given module (``{"encoder": model.encoder, ...}``), so
    :func:`records_from_profile` can place its operators and, through the
    autograd sequence numbers, their backward ones."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []

    def __enter__(self):
        for name, module in self.modules.items():
            stack = []

            def enter(_module, _args, _name=name, _stack=stack):
                _stack.append(torch.profiler.record_function(_name))
                _stack[-1].__enter__()

            def leave(_module, _args, _out, _stack=stack):
                _stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(enter),
                             module.register_forward_hook(leave)]
        return self

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        self.handles = []


# ------------------------------------ the JAX module's roofline and buckets

def roofline_rows(
    trace_rows: List[Tuple[str, float, str]],
    instrs: Dict[str, Dict[str, float]],
    peak_flops: float,
    peak_bytes: float,
    kernel_flops: Optional[Dict[str, float]] = None,
) -> List[Dict]:
    """Join trace durations with per-event bytes/flops.

    kernel_flops: {substring-of-event-or-op-name: flops} — analytic FLOP
    counts that override the record's where larger; first match wins,
    insertion order preserved.
    """
    rows = []
    for name, ms, op in trace_rows:
        rec = instrs.get(name, {})
        byt = rec.get("bytes", 0.0)
        fl = rec.get("flops", 0.0)
        op = op or rec.get("op", "")
        if kernel_flops:
            for pat, kfl in kernel_flops.items():
                if pat in name or pat in op:
                    fl = max(fl, kfl)
                    break
        t = ms / 1e3
        t_fl = fl / peak_flops
        t_by = byt / peak_bytes
        bound = "flop" if t_fl >= t_by else "byte"
        attain = (max(t_fl, t_by) / t) if t > 0 else 0.0
        rows.append({
            "instr": name, "op": op, "ms": ms,
            "gb": byt / 1e9, "gflop": fl / 1e9,
            "gbps": byt / t / 1e9 if t > 0 else 0.0,
            "tflops": fl / t / 1e12 if t > 0 else 0.0,
            "bound": bound, "attainment": attain,
        })
    return rows


def bucket_rows(rows: List[Dict], buckets: List[Tuple[str, str]],
                ) -> List[Dict]:
    """Group rows into named intervals.  ``buckets`` is an ordered list of
    (bucket_name, regex) matched against ``op`` then ``instr``; first
    match wins; unmatched rows land in 'other'."""
    agg: Dict[str, Dict] = {}
    order = [b for b, _ in buckets] + ["other"]
    for r in rows:
        dest = "other"
        for bname, pat in buckets:
            if re.search(pat, r["op"]) or re.search(pat, r["instr"]):
                dest = bname
                break
        a = agg.setdefault(dest, {"interval": dest, "ms": 0.0, "gb": 0.0,
                                  "gflop": 0.0, "t_bound": 0.0,
                                  "n_instr": 0})
        a["ms"] += r["ms"]
        a["gb"] += r["gb"]
        a["gflop"] += r["gflop"]
        # binding time adds per event (each binds on its own better
        # roofline: ms * attainment == max(t_flop, t_byte))
        a["t_bound"] += r["ms"] * r["attainment"]
        a["n_instr"] += 1
    out = []
    for name in order:
        if name not in agg:
            continue
        a = agg[name]
        t = a["ms"] / 1e3
        a["gbps"] = a["gb"] / t if t > 0 else 0.0
        a["tflops"] = a["gflop"] / 1e3 / t if t > 0 else 0.0
        a["attainment"] = a["t_bound"] / a["ms"] if a["ms"] > 0 else 0.0
        out.append(a)
    return out


def format_interval_table(buckets: List[Dict], total_ms: float) -> str:
    lines = [
        "| interval | ms/step | % step | GB | GB/s | GFLOP | TFLOP/s |"
        " % of own roofline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for b in buckets:
        lines.append(
            f"| {b['interval']} | {b['ms']:.2f} | "
            f"{100 * b['ms'] / total_ms:.0f}% | {b['gb']:.2f} | "
            f"{b['gbps']:.0f} | {b['gflop']:.0f} | {b['tflops']:.1f} | "
            f"{100 * b['attainment']:.0f}% |"
        )
    return "\n".join(lines)
