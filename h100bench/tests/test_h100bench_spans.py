"""The readers of the program's spans on synthetic traces, whose gaps,
launches and spans are known: each reader's number, and None from a run
of a program without the spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from h100bench.run import load_reader
from h100bench.trace import Trace

MS = 1e-3


class Event:
    """What the readers call of a profiler event (times in ms)."""

    def __init__(self, name, s, t, kind="cpu_op", corr=0, linked=0):
        self._name, self.s, self.t = name, s, t
        self.kind, self.corr, self.linked = kind, corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return int(round(self.s * 1e6))

    def duration_ns(self):
        return int(round((self.t - self.s) * 1e6))

    def device_type(self):
        return (DeviceType.CPU if self.kind in ("cpu_op", "user_annotation",
                                                "cuda_runtime")
                else DeviceType.CUDA)

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def span(name, s, t):
    return Event(name, s, t, kind="user_annotation")


def launch(corr, at):
    return Event("cudaLaunchKernel", at, at + 0.1, kind="cuda_runtime",
                 corr=corr)


def kernel(s, t, corr=0, linked=0):
    return Event("void kernel", s, t, kind="kernel", corr=corr,
                 linked=linked)


def trace_of(events):
    t = Trace.__new__(Trace)
    results = SimpleNamespace(events=lambda: events)
    t.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    t.analyse()
    return t


def serving(with_spans: bool):
    """Two volumes in a 100 ms window. Device busy [10, 45] and [60, 95];
    idle under the requests outside their tiles: [0, 10], [45, 50],
    [50, 60], [95, 100] (30 ms). Launched outside the forwards: the copy
    at 10.5 (10 ms), the accumulation at 35 (7 ms) and the argmax at 91,
    tied by its linked operator (10 ms): 27 ms."""
    ev = [span("h100bench.window", 0, 100),
          span("h100bench.request", 0, 50), span("h100bench.request", 50, 100),
          Event("rehrseg.segment", 0, 100, kind="gpu_user_annotation"),
          launch(1, 10.5), kernel(10, 20, corr=1),
          launch(2, 15), kernel(20, 38, corr=2),
          launch(3, 35), kernel(38, 45, corr=3),
          Event("aten::convolution", 64, 70, corr=50),
          kernel(60, 85, corr=99, linked=50),
          Event("aten::argmax", 91, 92, corr=51),
          kernel(85, 95, corr=98, linked=51)]
    if with_spans:
        ev += [span("rehrseg.segment", 0, 50),
               span("rehrseg.segment", 50, 100),
               span("rehrseg.segment.tile", 10, 40),
               span("rehrseg.segment.tile", 60, 90),
               span("rehrseg.segment.forward", 12, 30),
               span("rehrseg.segment.forward", 62, 80)]
    return SimpleNamespace(trace=trace_of(ev),
                           driver=SimpleNamespace(volumes_done=2))


def training(with_spans: bool):
    """Two steps in a 100 ms window; the sampler's spans add to 3 + 2 ms
    and the part of one inside the window (1 ms), the steps' to 35 + 40."""
    ev = [span("h100bench.window", 0, 100),
          span("h100bench.data_wait", 0, 4),
          span("h100bench.data_wait", 50, 53),
          kernel(6, 98, corr=1), launch(1, 5)]
    if with_spans:
        ev += [span("rehrseg.sampler.next", -5, 1),
               span("rehrseg.sampler.next", 0, 3),
               span("rehrseg.sampler.next", 50, 52),
               span("rehrseg.sr_step", 5, 40), span("rehrseg.sr_step", 55, 95)]
    return SimpleNamespace(trace=trace_of(ev),
                           driver=SimpleNamespace(steps_done=2))


@pytest.mark.parametrize("metric, ctx, want", [
    ("request_idle_ms_per_vol.serve", serving, 15.0),
    ("engine_ms_per_vol.serve", serving, 13.5),
    ("sampler_ms_per_step.train", training, 3.0),
    ("step_host_ms_per_step.train", training, 37.5),
])
def test_reader_on_a_synthetic_trace(metric, ctx, want):
    reader = load_reader(metric)
    assert reader.read(ctx(True)) == pytest.approx(want, abs=1e-6)
    assert reader.read(ctx(False)) is None


def test_span_mirrors_on_the_device_are_no_work():
    """The device-side range of a span adds nothing to busy time."""
    t = serving(True).trace
    assert t.busy_s == pytest.approx(70 * MS)
