"""Spans the harness records around its calls into the program, and the
device trace of a traced run.

``Spans`` keeps, per name, the host seconds of every call it timed, and
opens a ``torch.profiler.record_function`` range of the same name
(``perfbench.<name>``) so that a trace can say what the host was doing.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activity, shapes and
scalar arguments recorded) between ``start`` and ``stop``, called on the
thread whose CPU operators are to be seen, and reduces the events to what
the metrics read: the device's busy seconds in the traced window, each
device operation with the innermost CPU operator that launched it and
the harness ranges around that operator, and the idle gaps with the
range the host was in.  Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time

import torch

PREFIX = "perfbench."


class Spans:
    def __init__(self):
        self.seconds: dict[str, list] = {}
        self.tags: dict[str, list] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str, tag=None):
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds.setdefault(name, []).append(dt)
                    self.tags.setdefault(name, []).append(tag)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int                 # ns, the profiler's clock
    end: int
    op: str | None             # innermost CPU operator that launched it
    op_id: int                 # that operator call's correlation id
    launched: int              # when that operator call started, ns
    thread: int                # and on which thread
    shapes: list | None
    dtypes: list | None
    concrete: list | None
    ranges: tuple              # harness ranges around that operator


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: list                  # DeviceOp, in start order
    gaps: list                 # (range name or 'outside', seconds)
    ranges: dict               # range name -> count in the window
    calls: dict                # the program's operators (``eamm::*``):
    # name -> [(start, end, thread, shapes, dtypes, scalar arguments)]


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")()
                                                * 1000)


class Trace:
    """``start`` and ``stop`` the profiler on the thread to be traced;
    ``summarize`` afterwards, on any thread."""

    def __init__(self):
        self.prof = None
        self.stopped = None
        self.summary: Summary | None = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities, record_shapes=True)
        self.prof.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.stopped, self.prof = self.prof, None

    def summarize(self):
        if self.stopped is not None:
            self.summary = reduce_events(
                self.stopped.profiler.kineto_results.events())
            self.stopped = None


def reduce_events(events) -> Summary:
    """Kineto events -> ``Summary``.  The window runs from the first to the
    last event; device operations are the device-side events that are not
    a harness range's own device annotation."""
    cpu_ops, ranges, device = {}, [], []
    lo, hi = None, None
    for e in events:
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        name = e.name()
        on_device = "CPU" not in str(e.device_type())
        if name.startswith(PREFIX):
            if not on_device:
                ranges.append((start, end, name[len(PREFIX):],
                               e.start_thread_id()))
            continue
        if on_device:
            device.append((start, end, name, e.linked_correlation_id()))
        else:
            cpu_ops[e.correlation_id()] = (name, start, end,
                                           e.start_thread_id(), e)
    ranges.sort()
    starts = [r[0] for r in ranges]

    def around(t: int, thread) -> tuple:
        out = []
        for r in ranges[:bisect.bisect_right(starts, t)]:
            if r[0] <= t <= r[1] and (thread is None or r[3] == thread):
                out.append(r[2])
        return tuple(out)

    ops = []
    for start, end, name, link in sorted(device):
        op = cpu_ops.get(link)
        if op is not None:
            e = op[4]
            ops.append(DeviceOp(name, start, end, op[0], link, op[1], op[3],
                                _safe(e.shapes),
                                _safe(e.dtypes), _safe(e.concrete_inputs),
                                around(op[1], op[3])))
        else:
            ops.append(DeviceOp(name, start, end, None, 0, 0, 0, None, None,
                                None, ()))
    busy, gaps = 0, []
    cur_s = cur_e = None
    prev_end = lo
    for o in ops:
        if cur_e is None or o.start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gap = o.start - (prev_end if cur_e is None else cur_e)
            if gap > 0:
                t = (o.start + (prev_end if cur_e is None else cur_e)) // 2
                inside = around(t, None)
                gaps.append((inside[-1] if inside else "outside", gap / 1e9))
            cur_s, cur_e = o.start, o.end
        else:
            cur_e = max(cur_e, o.end)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            inside = around((hi + cur_e) // 2, None)
            gaps.append((inside[-1] if inside else "outside",
                         (hi - cur_e) / 1e9))
    counts: dict = {}
    for r in ranges:
        counts[r[2]] = counts.get(r[2], 0) + 1
    calls: dict = {}
    for name, start, end, thread, e in cpu_ops.values():
        if name.startswith("eamm::"):
            calls.setdefault(name, []).append(
                (start, end, thread, _safe(e.shapes), _safe(e.dtypes),
                 _safe(e.concrete_inputs)))
    return Summary(window_s=((hi - lo) / 1e9) if lo is not None else 0.0,
                   busy_s=busy / 1e9, ops=ops, gaps=gaps, ranges=counts,
                   calls=calls)


def _safe(fn):
    try:
        return fn()
    except (AttributeError, RuntimeError):
        return None


def breakdown(summary: Summary, n: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle gaps summed by the range the host was in, each the
    top ``n`` as [name, seconds]."""
    by_op: dict = {}
    for o in summary.ops:
        by_op[o.name] = by_op.get(o.name, 0.0) + (o.end - o.start) / 1e9
    by_gap: dict = {}
    for name, s in summary.gaps:
        by_gap[name] = by_gap.get(name, 0.0) + s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
