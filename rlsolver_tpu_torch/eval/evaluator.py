"""Best-solution tracking and run recording (counterpart of
`rlsolver_tpu/eval/evaluator.py`, numpy only).

Functional equivalent of the reference `Evaluator`/`Recorder`
(`rlsolver/methods/util_evaluator.py:68-180`): tracks the incumbent solution
across training, records (step, value, wall_time) curves, and persists them.
Differences by design: records stream to JSONL (machine-readable) instead of
.npy+jpg, and the solution codec is the shared `SolutionCodec`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Union

import numpy as np

from rlsolver_tpu_torch.core.encode import SolutionCodec


class Evaluator:
    def __init__(
        self,
        save_dir: Optional[str],
        num_bits: int,
        x: np.ndarray,
        v: float,
        if_maximize: bool = True,
        log_every: int = 1,
    ):
        self.start_time = time.time()
        self.if_maximize = if_maximize
        self.num_bits = num_bits
        self.codec = SolutionCodec(num_bits)
        self.best_x = np.asarray(x)
        self.best_v = float(v)
        self.records = [(0.0, self.best_v, 0.0)]
        self.save_dir = save_dir
        self.log_every = log_every
        self._n_records = 0
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def record(self, step: float, vs: Union[np.ndarray, float], xs: np.ndarray) -> bool:
        """Record the best of a batch; returns True if the incumbent improved.

        Accepts either a single (v, x) or batched (vs [B], xs [B, n]).
        """
        vs = np.asarray(vs)
        xs = np.asarray(xs)
        if xs.ndim == 2:
            i = int(vs.argmax() if self.if_maximize else vs.argmin())
            v, x = float(vs[i]), xs[i]
        else:
            v, x = float(vs), xs
        elapsed = time.time() - self.start_time
        self.records.append((float(step), v, elapsed))
        improved = v > self.best_v if self.if_maximize else v < self.best_v
        if improved:
            self.best_v = v
            self.best_x = x.copy()
        self._n_records += 1
        return improved

    def log_line(self, step: float, extra: str = "") -> str:
        elapsed = time.time() - self.start_time
        return f"step {step:8.0f}  best {self.best_v:12.2f}  time {elapsed:8.1f}s  {extra}"

    def best_str(self) -> str:
        return self.codec.bits_to_str(self.best_x.astype(bool))

    def save(self) -> None:
        if not self.save_dir:
            return
        with open(os.path.join(self.save_dir, "records.jsonl"), "w") as f:
            for step, v, t in self.records:
                f.write(json.dumps({"step": step, "value": v, "time": t}) + "\n")
        with open(os.path.join(self.save_dir, "best.json"), "w") as f:
            json.dump(
                {
                    "best_v": self.best_v,
                    "num_bits": self.num_bits,
                    "best_x_base64": self.best_str(),
                },
                f,
            )
