"""The traced sub-window: ``torch.profiler`` over a few calls after the
measured window, read into device events placed by layer.

Event selection follows ``rangeclip_tpu_torch/utils/profiling.
window_events`` (copied): the device events launched by the runtime calls
made inside the sub-window's host range, joined by correlation id, without
the user annotations that enclose kernels.  Each event carries the names
of the host operators that launched it, innermost first, and a layer
label: the enclosing range opened by ``yardstick.label_modules`` or by the
benchmark's own wrappers ('encoder', 'decoder', 'loss'), and for a
backward operator the label of the forward operator that made its
autograd node (by sequence number).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.autograd import DeviceType

from portbench.yardstick import union_seconds

WINDOW = "portbench::traced_calls"
LABELS = ("encoder", "decoder", "loss")
_EVALUATE = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class Event:
    name: str
    start_us: float
    end_us: float
    label: str
    ops: Tuple[str, ...]  # launching host operators, innermost first

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclasses.dataclass
class TraceView:
    calls: int
    window_s: float
    events: List[Event]
    idle_gaps: List[Tuple[str, float]]

    @property
    def busy_s(self) -> float:
        return union_seconds((e.start_us, e.end_us)
                             for e in self.events) * 1e-6

    def seconds(self, keep: Callable[[Event], bool]) -> float:
        return sum(e.seconds for e in self.events if keep(e))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by_name: Dict[str, float] = collections.Counter()
        for e in self.events:
            by_name[e.name] += e.seconds
        return [[k, v] for k, v in by_name.most_common(n)]


def _chain(event, stop) -> List[object]:
    out = []
    while event is not None and event is not stop:
        out.append(event)
        event = event.cpu_parent
    return out


def _label(chain, seq_label) -> str:
    for e in chain:
        if e.name in LABELS:
            return e.name
        if e.name.startswith(_EVALUATE) and e.sequence_nr in seq_label:
            return seq_label[e.sequence_nr]
    return ""


def read_trace(prof, wall_s: float, calls: int) -> TraceView:
    traced = prof.events()
    window = next(e for e in traced if e.name == WINDOW
                  and e.device_type == DeviceType.CPU)
    runtime = [e for e in traced if e.device_type == DeviceType.CPU
               and e.name.startswith("cu")
               and e.time_range.start >= window.time_range.start]
    by_id = {e.id: e for e in runtime}
    device = [e for e in traced if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.id in by_id]
    seq_label = {}
    for e in traced:
        if (e.device_type == DeviceType.CPU and e.sequence_nr >= 0
                and not e.name.startswith(_EVALUATE)):
            label = _label(_chain(e, None), seq_label)
            if label:
                seq_label.setdefault(e.sequence_nr, label)
    events = []
    for e in device:
        chain = _chain(by_id[e.id].cpu_parent, window)
        events.append(Event(e.name, e.time_range.start, e.time_range.end,
                            _label(chain, seq_label),
                            tuple(c.name for c in chain)))
    events.sort(key=lambda e: e.start_us)
    return TraceView(calls, wall_s, events, idle_gaps(events, by_id, device))


def idle_gaps(events: Sequence[Event], by_id, device) -> List[
        Tuple[str, float]]:
    """The device's idle gaps, summed by what the host was doing: the
    outermost host operator that launched the event ending the gap."""
    launcher = {}
    for e in device:
        chain = _chain(by_id[e.id].cpu_parent, None)
        names = [c.name for c in chain if c.name != WINDOW]
        launcher[(e.name, e.time_range.start)] = (names[-1] if names
                                                  else by_id[e.id].name)
    gaps: Dict[str, float] = collections.Counter()
    reach = None
    for e in events:
        if reach is not None and e.start_us > reach:
            gaps[launcher.get((e.name, e.start_us), e.name)] += (
                e.start_us - reach) * 1e-6
        reach = e.end_us if reach is None else max(reach, e.end_us)
    return [[k, v] for k, v in gaps.most_common(10)]


def trace_calls(call: Callable[[], object], calls: int) -> TraceView:
    """Profile ``calls`` calls after one that the tracer's start may lose
    events of; the host range spans the calls and the final sync."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        call()
        torch.cuda.synchronize()
        time.sleep(1e-3)
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return read_trace(prof, wall, calls)
