"""Time K2 (``accumulate_tta_tile``) of two trees in turns on one card.

    python -m rehrseg_tpu_torch.compare_k2 PARENT_DIR [--order pccp]
                                           [--out FILE]

``PARENT_DIR`` holds another checkout of the repo (for example ``git
archive <commit> | tar -x -C build/parent``); the change is the tree this
module was imported from. Each letter of ``--order`` runs
:func:`k2_times` in a process of its own from that tree's root (p: parent,
c: change), so the process imports that tree's package and builds that
tree's kernel: K2's wrapper at the serving shapes, bf16 LR and HR, on
seeded inputs with the gaussian already bf16 (no cast in the time), warm
(launches back to back, queued behind a sleep of the stream so that the
host's launch rate does not pace them; and unqueued, as paced) and cold
(each launch between its own CUDA events after a 256 MB write that evicts
the L2, queued as well); then the served path's labels:
one seeded (20, 455, 633) volume through the aligned dual ``Segmenter`` at
full width with seeded weights (chip_smoke ``main``'s first volume), their
sha256 and K2's launches. Prints one JSON line: the card, every run's times
and labels, the ratio change / parent of the mean times, and whether every
run's labels are the same bytes. Exits with 1 if a run failed.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def k2_times(iters=20):
    """{"lr" | "hr": {"warm_ms", "paced_ms", "cold_ms"}, "labels", "card"}
    of the importable package's ``accumulate_tta_tile`` and ``Segmenter``.
    Imports inside, so that it runs as it is in another tree
    (:func:`run_tree`)."""
    import hashlib

    import numpy as np
    import torch
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile
    from rehrseg_tpu_torch.serve import Segmenter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scrub = torch.empty(64 << 20, device=dev)
    out = {"card": torch.cuda.get_device_name(0)}
    for form, z in (("lr", 1), ("hr", 4)):
        od = 16 * z
        logits = torch.randn(2, 20 * z, 456, 640, generator=gen, device=dev)
        preds = torch.randn(8, 2, od, 320, 384, generator=gen,
                            device=dev).to(torch.bfloat16)
        g = (torch.rand(od, 320, 384, generator=gen, device=dev)
             + 0.1).to(torch.bfloat16)

        def run():
            accumulate_tta_tile(logits, preds, g, (4, 136, 256, 1),
                                z_scale=z)

        def event():
            return torch.cuda.Event(enable_timing=True)

        def warm(queued):
            torch.cuda.synchronize()
            if queued:
                torch.cuda._sleep(20_000_000)
            start, end = event(), event()
            start.record()
            for _ in range(iters):
                run()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        for _ in range(3):
            run()
        out[form] = {"warm_ms": warm(True), "paced_ms": warm(False)}
        cold = [(event(), event()) for _ in range(iters)]
        torch.cuda._sleep(20_000_000)
        for a, b in cold:
            scrub.zero_()
            a.record()
            run()
            b.record()
        torch.cuda.synchronize()
        out[form]["cold_ms"] = sum(a.elapsed_time(b)
                                   for a, b in cold) / iters
        del logits, preds, g
    del scrub
    seg = Segmenter.from_flax(convert.random_flax_params(DEFAULT_ARCH, 0),
                              DEFAULT_ARCH, tile_grid="aligned",
                              patch_size=(16, 320, 384),
                              compute_dtype=torch.bfloat16, device=dev)
    vol = np.random.default_rng(0).normal(size=(20, 455, 633)).astype(
        np.float32)
    before = accumulate_tta_tile.launches
    lr, hr = seg.segment(vol, hr=True)
    out["labels"] = {"lr": hashlib.sha256(lr.tobytes()).hexdigest(),
                     "hr": hashlib.sha256(hr.tobytes()).hexdigest(),
                     "k2_launches": accumulate_tta_tile.launches - before}
    return out


def run_tree(fn, root: Path):
    """``fn()`` (a function that imports what it uses inside, its result a
    JSON-able dict with a "card") in a fresh process from ``root``, so
    that it runs as it is against that tree's package -> its result, or
    None if the process failed."""
    code = (inspect.getsource(fn)
            + f"\nimport json\nprint(json.dumps({fn.__name__}()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"{fn.__name__} in {root} failed ({proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}",
              file=sys.stderr)
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare(fn, summarize, argv, description: str) -> int:
    """The command line of a two-tree comparison: ``fn`` run in the
    parent (p) and in this tree (c) in the order ``--order`` gives, then
    one JSON line of the order, the card and ``summarize(runs)`` (runs:
    (tree letter, result) pairs), also written to ``--out``. 1 if a run
    failed."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("parent", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    roots = {"p": args.parent.resolve(),
             "c": Path(__file__).resolve().parent.parent}
    runs = [(tree, run_tree(fn, roots[tree])) for tree in args.order]
    if any(r is None for _, r in runs):
        return 1
    line = json.dumps({"order": args.order, "card": runs[0][1]["card"],
                       **summarize(runs)})
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


def _summary(runs) -> dict:
    result = {"times": {}}
    for form in ("lr", "hr"):
        for metric in ("warm_ms", "paced_ms", "cold_ms"):
            by = {tree: [r[form][metric] for t, r in runs if t == tree]
                  for tree in "pc"}
            mean = {t: sum(v) / len(v) for t, v in by.items() if v}
            result["times"][f"{form} {metric}"] = {
                "parent": by["p"], "change": by["c"],
                "change_over_parent": (mean["c"] / mean["p"]
                                       if len(mean) == 2 else None)}
    result["labels"] = [{"tree": t, **r["labels"]} for t, r in runs]
    result["labels_equal"] = all(
        (r["labels"]["lr"], r["labels"]["hr"])
        == (runs[0][1]["labels"]["lr"], runs[0][1]["labels"]["hr"])
        for _, r in runs)
    return result


def main(argv=None) -> int:
    return compare(k2_times, _summary, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    sys.exit(main())
