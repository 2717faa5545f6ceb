"""Throughput autotuner: the best batch size for this card (counterpart of
`rlsolver_tpu/eval/autotune.py`).

Times any `run(num_sims)` over a sweep of batch sizes and returns the
throughput-optimal one. The device is synchronized around each timed
window. A candidate that runs out of device memory scores 0; any other
error propagates, so a broken candidate never reads as a slow one.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from rlsolver_tpu_torch.device import synchronize


def measure_throughput(run: Callable[[int], object], num_sims: int, reps: int = 3) -> float:
    """Items/sec for `run(num_sims)` (the first call, a warm-up, excluded)."""
    run(num_sims)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run(num_sims)
    synchronize()
    return num_sims * reps / (time.perf_counter() - t0)


def find_best_num_sims(
    run: Callable[[int], object],
    candidates: Optional[Sequence[int]] = None,
    reps: int = 3,
    verbose: bool = False,
) -> Tuple[int, List[Tuple[int, float]]]:
    """Sweep batch sizes; returns (best num_sims, [(num_sims, items/s)]).

    Default sweep: powers of two 2^8 .. 2^14. A candidate that raises an
    out-of-memory error is recorded with throughput 0."""
    if candidates is None:
        candidates = [2**k for k in range(8, 15)]
    results: List[Tuple[int, float]] = []
    for n in candidates:
        try:
            tp = measure_throughput(run, n, reps)
        except torch.cuda.OutOfMemoryError:  # the same class as torch.OutOfMemoryError
            tp = 0.0
            torch.cuda.empty_cache()  # a no-op where CUDA was never initialised
        results.append((n, tp))
        if verbose:
            print(f"num_sims={n:>7}  throughput={tp:,.0f}/s")
    best = max(results, key=lambda t: t[1])[0]
    return best, results
