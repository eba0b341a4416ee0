"""The program's own spans in a traced run (``rehrseg.*``, recorded by
``rehrseg_tpu_torch.utils.timer.span``), read from the profiler's record
that ``trace.Trace`` keeps.

Host spans are grouped by name; each device operation (kernel, copy,
set) carries the host time of the call that launched it. A device
operation shares CUPTI's correlation id with its runtime call on the host
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...: a host event linked to
an operator, or named ``cu*``); where no runtime call carries it, its
linked correlation id names the innermost host operator open at the
launch. Everything is clipped to the traced window. A program without
these spans (one older than them) gives none, and the readers that need
them return None.
"""

from __future__ import annotations

import bisect


def events(trace):
    """(spans, ops): ``spans`` maps each ``rehrseg.*`` name to its host
    intervals (s, t), ``ops`` lists the device operations as (s, t,
    launch time or None); seconds, read once and kept on ``trace``."""
    if getattr(trace, "program_events", None) is not None:
        return trace.program_events
    from torch.autograd import DeviceType

    w0, w1 = trace.w0, trace.w1
    spans, dev, runtime, frontend = {}, [], {}, {}
    for e in trace.prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() > 0 or (
                    name.startswith("cu") and not e.is_user_annotation()):
                runtime[e.correlation_id()] = s
                continue
            frontend[e.correlation_id()] = s
            if name.startswith("rehrseg.") and t > w0 and s < w1:
                spans.setdefault(name, []).append((max(s, w0), min(t, w1)))
        elif not (e.is_user_annotation()
                  or name.startswith(("h100bench.", "rehrseg."))):
            dev.append((s, t, e.correlation_id(),
                        e.linked_correlation_id()))
    ops = [(max(s, w0), min(t, w1),
            runtime.get(corr, frontend.get(linked)))
           for s, t, corr, linked in dev if t > w0 and s < w1]
    trace.program_events = (spans, ops)
    return trace.program_events


def union(intervals) -> list:
    """Sorted disjoint intervals covering ``intervals``."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def subtract(a, b) -> list:
    """The parts of the disjoint sorted intervals ``a`` outside ``b``."""
    out = []
    for s, t in a:
        for bs, bt in b:
            if bt <= s or bs >= t:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, bt)
        if t > s:
            out.append((s, t))
    return out


def intersect(a, b) -> list:
    """The parts of the intervals ``a`` inside the disjoint sorted ``b``."""
    return [(max(s, bs), min(t, bt)) for s, t in a for bs, bt in b
            if min(t, bt) > max(s, bs)]


def total(intervals) -> float:
    return sum(t - s for s, t in intervals)


def covers(intervals, when) -> bool:
    """Does one of the disjoint sorted ``intervals`` hold ``when``?"""
    i = bisect.bisect_right(intervals, (when, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= when < intervals[i][1]


def outside(spans, outer: str, inner: str):
    """The time under ``outer`` spans and outside every ``inner`` span, or
    None where the run has no ``outer`` span."""
    if outer not in spans:
        return None
    return subtract(union(spans[outer]), union(spans.get(inner, [])))


def seconds_in(trace, name: str):
    """Summed host seconds of the ``name`` spans, or None without one."""
    spans, _ = events(trace)
    return total(spans[name]) if name in spans else None
