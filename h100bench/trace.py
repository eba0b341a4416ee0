"""The traced run: ``torch.profiler`` over the measured window (CPU and CUDA
activities, no shapes, no stacks), reduced to device time.

The window is the ``h100bench.window`` range the driver records. Busy
time is the union of the device's operations (kernels, copies, sets)
inside it; kernel time is summed by class, the classes copied from the
program's own serving profile (first match wins); an idle gap is named by
the innermost host operation running at its middle (an ``h100bench.*``
span where no operator of the program runs there).
"""

from __future__ import annotations

import bisect

# kernel-name fragments -> class, first match wins (the program's
# ``profile_serve`` classes: K1 is conv_wgmma_kernel<Pad11Cat, ..>, K2
# accumulate_kernel)
CLASSES = (
    ("k6a_pconv_pad11_cat_stats", ("K6aPad11Cat",)),
    ("k6c_pconv3_valid_fused", ("K6cValid3",)),
    ("k6b_pconv_valid_fused", ("K6bValid2",)),
    ("k1_pconv_pad11_cat", ("Pad11Cat",)),
    ("k4_pconv_pad11", ("Pad11",)),
    ("k3_pconv_valid", ("Valid2",)),
    ("k5_pconv3_valid", ("Valid3",)),
    ("k2_accumulate_tta_tile", ("accumulate_kernel",)),
    ("conv_and_gemm", ("conv", "gemm", "xmma", "cutlass", "sm90_", "sm80_",
                       "cudnn", "implicit")),
    ("copy_and_layout", ("copy", "cat", "pad", "flip", "permute",
                         "CatArray", "memcpy", "Memcpy")),
    ("reduction", ("reduce", "Reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)

WINDOW = "h100bench.window"


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def _union(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


class Trace:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False)

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def analyse(self) -> None:
        """Reads the profiler's events once (times in seconds)."""
        from torch.autograd import DeviceType

        dev, host = [], []
        win = None
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() * 1e-9
            t = s + e.duration_ns() * 1e-9
            if e.device_type() != DeviceType.CPU and (
                    e.is_user_annotation() or e.name().startswith(
                        "h100bench.")):
                continue        # a host range mirrored on the device
            if e.device_type() == DeviceType.CPU:
                if e.name() == WINDOW and win is None:
                    win = (s, t)
                host.append((s, t, e.name()))
            else:
                dev.append((s, t, e.name()))
        if win is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        self.w0, self.w1 = win
        self.window_s = win[1] - win[0]
        self.kernels = [(max(s, win[0]), min(t, win[1]), n)
                        for s, t, n in dev if t > win[0] and s < win[1]]
        self.busy_s = _union([(s, t) for s, t, _ in self.kernels])
        self.host = sorted((s, t, n) for s, t, n in host
                           if t > win[0] and s < win[1] and n != WINDOW)

    def seconds_by_name(self) -> dict:
        out: dict[str, float] = {}
        for s, t, n in self.kernels:
            out[n] = out.get(n, 0.0) + (t - s)
        return out

    def class_seconds(self) -> dict:
        out: dict[str, float] = {}
        for n, sec in self.seconds_by_name().items():
            c = classify(n)
            out[c] = out.get(c, 0.0) + sec
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def kernels_of(self, cls: str) -> list:
        """(count, seconds) of the kernels of one class."""
        ks = [t - s for s, t, n in self.kernels if classify(n) == cls]
        return len(ks), sum(ks)

    def gaps(self) -> list:
        """Idle stretches of the device inside the window: (start, end)."""
        out, cur = [], self.w0
        for s, t, _ in sorted(self.kernels):
            if s > cur:
                out.append((cur, s))
            cur = max(cur, t)
        if self.w1 > cur:
            out.append((cur, self.w1))
        return out

    def _host_at(self, when: float) -> str:
        starts = [s for s, _, _ in self.host]
        i = bisect.bisect_right(starts, when)
        best = None
        for s, t, n in reversed(self.host[max(i - 2000, 0):i]):
            if t >= when:
                best = n
                break
        return best or "host idle"

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k[:200], v] for k, v in ops[:n]],
                "idle_gaps": [[self._host_at((a + b) / 2)[:200], b - a]
                              for a, b in gaps]}
