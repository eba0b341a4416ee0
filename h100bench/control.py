"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and its lower-precision control's over a few, in one process::

    python3 -m h100bench.control --workload NAME --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 5] \
        [--fault NAME ...] [--out FILE]

For each program seed the cell's driver is set up as in a run, serves a
short window at the cell's own load, and is checked as a run checks it.
For each control seed the same, and then the reference with its
convolutions in the lower precision (``reference.lowp``) takes the
program's place: its outputs are checked in the program's stead. With
``--fault NAME`` (``faults.py``) the control seeds are also run with that
fault planted in the program. A driver's ``diag`` (statistics beside
the compared numbers) is printed with them. The benchmark's own runs never
run this.
Prints one JSON line a run and, last, each number's largest program
reading and smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults, run


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def readings(cell, seed: int, seconds: float, device, control=False,
             fault=None) -> dict:
    """One seed's compared numbers: the program's, the control's in its
    place, or the program's with ``fault`` planted underneath."""
    patch = faults.Patch()
    if fault is not None:
        faults.BY_DRIVER[cell.traffic["driver"]][fault](patch)
    try:
        drv = run.load_driver(cell.traffic["driver"]).setup(
            cell, seed, device, run.SetupClock(time.perf_counter()))
        drv.window(seconds)
        drv.release()
        out = dict(drv.control_check() if control else drv.check())
        return {**out, **getattr(drv, "diag", {})}
    finally:
        patch.undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault", action="append", default=[],
                    help="also read the control seeds with this fault "
                         "planted (faults.py); repeatable")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("h100bench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = run.cell_context(run.load_spec(), args.workload)
    lines = []
    runs = [("program", s, False, None) for s in args.seeds]
    runs += [("control", s, True, None) for s in args.control_seeds]
    runs += [(f"fault:{f}", s, False, f) for f in args.fault
             for s in args.control_seeds]
    for kind, seed, control, fault in runs:
        r = readings(cell, seed, args.seconds, device, control, fault)
        line = {"kind": kind, "seed": seed, **r}
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    names = sorted({k for ln in lines for k in ln
                    if k not in ("kind", "seed")})
    summary = {"summary": {
        n: {kind: (max if kind == "program" else min)(
            ln[n] for ln in lines if ln["kind"] == kind)
            for kind in dict.fromkeys(ln["kind"] for ln in lines)}
        for n in names}, "card": run.card_line()}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
