"""Run one cell of the benchmark once, from the root of a checkout::

    python3 -m h100bench.run --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name from ``BENCHMARK.json``: the cell's traffic
file ``h100bench/workloads/<traffic>.json`` names its driver
(``h100bench/drivers/<driver>.py``), the configuration's file is the
``file`` of its entry, and each per-layer metric is read by
``h100bench/metrics/<metric>.py``. The driver sets up the program (counted
in ``setup_s``), runs the measured window, and checks what the window
produced against the plain reference once the window has closed.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number with its limit).
Earlier lines give the card, the set-up's split and the driver's counts;
the compared numbers are also the last lines of standard error. Without a
card, or with fewer cards than the cell asks for, it prints no result and
exits with 2; with a module of JAX or of the JAX package loaded once the
window has closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rehrseg_tpu")


def _started_before() -> float:
    """Seconds the process had run before this module started (from
    /proc; 0 where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_OFFSET = _started_before()


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    build = root / "build"
    os.environ["REHRSEG_TORCH_BUILD_DIR"] = str(build / "rehrseg_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_context(spec: dict, name: str, root: Path = ROOT):
    """The cell ``name``: its entry, configuration and traffic, and the
    metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return SimpleNamespace(
        name=name, entry=w, config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_driver(name: str):
    return importlib.import_module(f"h100bench.drivers.{name}")


def load_reader(metric: str):
    """The reader module of a per-layer metric,
    ``h100bench/metrics/<metric>.py`` (a name may hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics._{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class SetupClock:
    """The set-up's split: seconds from the previous mark to each."""

    def __init__(self, t0: float):
        self.last = t0
        self.split: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.split[name] = now - self.last
        self.last = now


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, offset: float = 0.0):
    """Set up, measure and check one run; returns (result, checks,
    earlier-line info). ``device`` may be the CPU in tests."""
    import torch

    clock = SetupClock(t_start)
    drv_mod = load_driver(cell.traffic["driver"])
    clock.mark("import")
    if device.type == "cuda":
        from rehrseg_tpu_torch import kernels

        kernels.build()
        for name in kernels.SOURCES:
            kernels.load(name)
    clock.mark("libraries")
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    clock.mark("context")
    drv = drv_mod.setup(cell, seed, device, clock)
    setup_s = time.perf_counter() - t_start + offset
    tracer = None
    if trace:
        from .trace import Trace

        tracer = Trace(device)
        tracer.start()
    win = drv.window(seconds)
    if tracer is not None:
        tracer.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    info = dict(setup_split_s=clock.split, setup_s=setup_s,
                process_start_s=offset, **drv.info())
    metrics = {}
    breakdown = None
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(peak))
    if trace:
        tracer.analyse()
        ctx = SimpleNamespace(trace=tracer, driver=drv, window=win,
                              cell=cell)
        for m in cell.per_layer:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
        breakdown = tracer.breakdown()
        info["kernel_classes_s"] = tracer.class_seconds()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, unit in units.items():
            if name == "setup_s":
                metrics[name] = {"value": setup_s, "unit": unit}
            elif name in win["end_to_end"]:
                metrics[name] = {"value": win["end_to_end"][name],
                                 "unit": unit}
    drv.release()
    limits = cell.traffic["limits"]
    t_check = time.perf_counter()
    checks = [(name, float(v), float(limits[name]))
              for name, v in drv.check()]
    info["check_s"] = time.perf_counter() - t_check
    correct = (win["failed"] == 0 and win["attempted"] > 0
               and all(v <= lim for _, v, lim in checks))
    result = dict(correct=bool(correct), attempted=win["attempted"],
                  failed=win["failed"], metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks, info


def report(result: dict, checks: list, info: dict) -> int:
    """Print the earlier line, the compared numbers and the result; the
    look for JAX comes last, once the check too has run, and a module found
    withholds the result (exit 3)."""
    print(json.dumps({"info": info}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"h100bench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} = {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = cell_context(load_spec(), args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    print(json.dumps({"card": card_line(), "cell": cell.name,
                      "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace}), flush=True)
    result, checks, info = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device,
        offset=PROCESS_OFFSET)
    return report(result, checks, info)


if __name__ == "__main__":
    sys.exit(main())
