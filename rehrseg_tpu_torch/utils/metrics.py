"""Structured metrics logging: the port's own copy of
``rehrseg_tpu.utils.metrics``. Under data parallelism only the primary
process writes (every process trains in lockstep with the same metrics).

Writes one JSON object per line to ``<dir>/metrics.jsonl`` with a wall-clock
timestamp, plus keeps the running history in memory for quick inspection.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, directory: str, filename: str = "metrics.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self.history: list[dict] = []

    def log(self, step: int, **metrics):
        # one writer keeps a shared-storage jsonl uncorrupted
        from ..parallel.multihost import is_primary
        if not is_primary():
            return None
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.history.append(rec)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def max_on_disk(self, key: str, default: float = 0.0) -> float:
        """Max of `key` over every record already in the jsonl FILE (not
        just this process's history) — lets a resumed run recover
        watermarks like best-val-dice instead of resetting them."""
        best = default
        try:
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn final line from a killed run
                    v = rec.get(key)
                    if isinstance(v, (int, float)) and v > best:
                        best = float(v)
        except OSError:
            pass
        return best

    def last(self, key: str):
        for rec in reversed(self.history):
            if key in rec:
                return rec[key]
        return None
