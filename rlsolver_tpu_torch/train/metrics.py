"""Structured metrics stream and throughput gauge (counterpart of
`rlsolver_tpu/train/metrics.py`; the port keeps its own copy).

One JSONL stream per run, each record carrying the step and the wall time
since the logger started; `Throughput` counts samples per second;
`should_stop` reads the graceful-stop sentinel.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: Optional[str] = None, print_every: int = 0):
        self.path = path
        self.print_every = print_every
        self._fh = None
        self._n = 0
        self.start_time = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, step: int, **scalars) -> Dict:
        rec = {"step": int(step), "time": round(time.time() - self.start_time, 4)}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self._n += 1
        if self.print_every and self._n % self.print_every == 0:
            print(" ".join(f"{k}={v}" for k, v in rec.items()))
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Throughput:
    """Samples/sec gauge."""

    def __init__(self):
        self.t0 = time.time()
        self.total = 0

    def add(self, n: int) -> None:
        self.total += int(n)

    @property
    def per_second(self) -> float:
        dt = time.time() - self.t0
        return self.total / dt if dt > 0 else 0.0


def should_stop(run_dir: str) -> bool:
    """Graceful-stop sentinel: a `stop` file in the run dir ends training."""
    return os.path.exists(os.path.join(run_dir, "stop"))
