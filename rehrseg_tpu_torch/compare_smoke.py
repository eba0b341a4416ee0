"""Run ``chip_smoke.py`` of two trees in turns on one card and set their
numbers side by side.

    python -m rehrseg_tpu_torch.compare_smoke PARENT_DIR [--order pccp]
                                              [--out FILE]

``PARENT_DIR`` holds another checkout of the repo (for example ``git
archive <commit> | tar -x -C build/parent``); the change is the tree this
module was imported from. Each letter of ``--order`` is one whole run of
that tree's ``chip_smoke.py`` in a process of its own (p: parent, c:
change), so both trees are timed on the same card under the same power
limit. Prints one JSON line: for every kernel of the ``kernels`` line its
``ms`` and ``library_ms`` in each run, and for the volume, tile-forward,
CLI and fold-evaluation phases their seconds and milliseconds, then the
ratio change / parent of the means (of the metrics both trees print). Exits with 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def run_smoke(root: Path) -> dict:
    """One run of root/chip_smoke.py -> {metric: value}; {} if it failed."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          capture_output=True, text=True)
    recs = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            recs.append(json.loads(line))
    if proc.returncode != 0 or not recs or not recs[-1].get("ok"):
        print(f"chip_smoke.py in {root} failed ({proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}",
              file=sys.stderr)
        return {}
    out = {}
    for rec in recs:
        for k in rec.get("kernels", ()):
            out[f"{k['name']} ms"] = k["ms"]
            if k.get("library_ms") is not None:
                out[f"{k['name']} library_ms"] = k["library_ms"]
            if "hr" in k:
                out[f"{k['name']} hr ms"] = k["hr"]["ms"]
        phase = rec.get("phase")
        if phase == "main":
            out["main aligned_dual s"] = rec["aligned_dual"]["seconds"]
            out["main parity_lr s"] = rec["parity_lr"]["seconds"]
            out["main aligned_many2 s"] = rec["aligned_many2"]["seconds"]
        elif phase in ("main_pallas", "main_fused"):
            out[f"{phase} s"] = rec["seconds"]
        elif phase == "cli":
            out["cli wall s"] = rec["cli_wall_seconds"]
            out["cli in_process s"] = rec["in_process_seconds_per_volume"]
        elif phase == "evaluate":
            out["evaluate s/subject"] = rec["seconds_per_subject"]
        if phase in ("main", "main_pallas", "tile_fused"):
            for key, val in rec.items():
                if key.startswith("tile_dual_forward_ms"):
                    out[f"{phase} {key}"] = val
        if phase == "env":
            out["card"] = rec["card"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    roots = {"p": args.parent.resolve(),
             "c": Path(__file__).resolve().parent.parent}
    runs = [(side, run_smoke(roots[side])) for side in args.order]
    ok = all(r for _, r in runs)
    table = {}
    for metric in sorted({m for _, r in runs for m in r} - {"card"}):
        row = {"runs": [r.get(metric) for _, r in runs]}
        means = {}
        for side in "pc":
            vals = [r[metric] for s, r in runs if s == side and metric in r]
            if vals:
                means[side] = sum(vals) / len(vals)
        if len(means) == 2:
            row["change_over_parent"] = means["c"] / means["p"]
        table[metric] = row
    line = json.dumps({"order": args.order,
                       "cards": [r.get("card") for _, r in runs],
                       "ok": ok, "metrics": table})
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
