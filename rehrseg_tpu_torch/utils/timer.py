"""The port's tracing: spans inside any running ``torch.profiler`` session,
and counters of the work done.

- :func:`span` names a stretch of host work. While a profiler runs it is
  a user-scope ``record_function`` range, so it sits in the profiler's own
  timeline, on the clock of the device's kernels and copies, under the
  span open around it on the same thread; any trace gets it with no
  change (``h100bench.run --trace 1``, ``extra.profile_dir``,
  ``profile_serve``). With no profiler running it returns one shared null
  context, and its only cost is the check
  ``torch._C._autograd._profiler_enabled()``. Its keyword values (the
  request id of ``rehrseg.segment``, the step of ``rehrseg.sr_step`` and
  ``rehrseg.seg_step``) are recorded as the range's inputs, which a
  profiler with ``record_shapes=True`` keeps ("Concrete Inputs" in its
  chrome trace); the spans inside a request nest under it.
- :func:`count` adds to a plain dict of ints, always on;
  :func:`counters` returns a snapshot of it with the hand kernels' launch
  counts (``k1.launches`` ...), read from the ops' own ``.launches`` /
  ``.fused_launches`` attributes and not counted a second time, and the
  norm-act op's (``norm_act.launches``: tails that ran its two kernels).

Spans (all named ``rehrseg.*``):

- serving: ``segment`` (one request: a ``Segmenter.segment`` call, or
  one volume of ``segment_many``) and under it ``segment.prep``,
  ``segment.upload``, ``segment.tile`` (one forward of the sliding window,
  with ``segment.mirror``, ``segment.forward`` and ``segment.accumulate``
  under it), ``segment.argmax``, ``segment.fetch``, ``segment.crop``;
- the packed forward: ``segnet.encoder``, ``segnet.residual`` and
  ``segnet.norm_act`` (every ConvNormAct's norm-act tail, whichever route
  it takes);
- stage 1: ``sampler.next`` (``sampler.draw``, ``sampler.gather``),
  ``augment``, ``lr_sim``, ``sr_step`` (``.forward``, ``.backward``,
  ``.all_reduce`` with a process group, ``.optimizer``);
- stage 2: ``seg_step`` (``.teacher``, ``.forward``, ``.distill``,
  ``.loss``, ``.backward``, ``.optimizer``), ``augment``;
- loaders: ``loader.next``.

Counters: ``serve.volumes``, ``serve.tiles``, ``serve.aligned_fallbacks``
(volumes that asked for the aligned grid and were served on the parity
grid), ``serve.fetch_wait_ns`` (host blocked in the label fetch's
synchronize), ``train.steps``, ``train.samples``, ``loader.batches`` and
``loader.wait_ns`` (batches taken from a queue loader, and the time its
consumer blocked in the queue's ``get``).
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch._C._autograd._record_function_with_args_enter(
            self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch._C._autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, **args):
    """A context naming the host work inside it in a running profiler's
    trace; the shared null context when none runs."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    return _Span(name, tuple(args.values()))


def count(name: str, n: int = 1) -> int:
    """Adds ``n`` to the counter ``name``; returns its new value."""
    _COUNTS[name] = value = _COUNTS.get(name, 0) + n
    return value


def counters() -> dict:
    """A snapshot of every counter, with the hand kernels' launches."""
    from ..ops.conv2x2 import conv2x2_valid_bias
    from ..ops.norm_act import norm_act
    from ..ops.pconv import (pconv3_valid, pconv_pad11, pconv_pad11_cat,
                             pconv_valid)
    from ..ops.tail import accumulate_tta_tile

    out = dict(_COUNTS)
    for k, op, attr in (
            ("k1", pconv_pad11_cat, "launches"),
            ("k2", accumulate_tta_tile, "launches"),
            ("k3", pconv_valid, "launches"),
            ("k4", pconv_pad11, "launches"),
            ("k5", pconv3_valid, "launches"),
            ("k6a", pconv_pad11_cat, "fused_launches"),
            ("k6b", pconv_valid, "fused_launches"),
            ("k6c", pconv3_valid, "fused_launches"),
            ("k7", conv2x2_valid_bias, "launches"),
            ("norm_act", norm_act, "launches")):
        out[f"{k}.launches"] = getattr(op, attr)
    return out
