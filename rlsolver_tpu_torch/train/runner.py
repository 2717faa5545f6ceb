"""Unified training loop (counterpart of `rlsolver_tpu/train/runner.py`).

The host loop handles the edges of a run: resume, periodic checkpoints,
the JSONL metrics stream, the graceful-stop sentinel and evaluation
callbacks. Contract: `step_fn(state) -> (state, metrics)`, where `state` is
anything `train.checkpoint` can save (tensors, generators, scalars in
dicts, lists and tuples) and `metrics` a flat dict of scalars or 0-d
tensors. Nothing is compiled: the JAX loop's `jit=` option has no
counterpart. Device work is queued asynchronously, so the loop
synchronizes the device where the host needs finished work: before a
log line's throughput, before an evaluation and before a save.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

from rlsolver_tpu_torch.device import synchronize
from rlsolver_tpu_torch.train.checkpoint import CheckpointManager
from rlsolver_tpu_torch.train.metrics import MetricsLogger, Throughput, should_stop


@dataclasses.dataclass
class LoopConfig:
    run_dir: str = "runs/default"
    total_steps: int = 1000
    log_every: int = 10
    checkpoint_every: int = 0  # 0 = never
    keep_checkpoints: int = 3
    eval_every: int = 0  # 0 = never
    resume: bool = False
    print_every: int = 0
    samples_per_step: int = 0  # for the throughput gauge


class TrainLoop:
    def __init__(
        self,
        cfg: LoopConfig,
        step_fn: Callable[[Any], tuple],
        eval_fn: Optional[Callable[[Any, int], Dict]] = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.eval_fn = eval_fn

    def run(self, state: Any) -> Any:
        cfg = self.cfg
        os.makedirs(cfg.run_dir, exist_ok=True)
        metrics = MetricsLogger(os.path.join(cfg.run_dir, "metrics.jsonl"), cfg.print_every)
        ckpt = None
        start_step = 0
        if cfg.checkpoint_every > 0:
            ckpt = CheckpointManager(
                os.path.join(cfg.run_dir, "checkpoints"),
                save_every=cfg.checkpoint_every,
                keep=cfg.keep_checkpoints,
            )
            if cfg.resume:
                restored, start_step = ckpt.restore_latest(like=state)
                if restored is not None:
                    state = restored
        throughput = Throughput()

        step = start_step
        for step in range(start_step + 1, cfg.total_steps + 1):
            state, step_metrics = self.step_fn(state)
            if cfg.samples_per_step:
                throughput.add(cfg.samples_per_step)
            if cfg.log_every and step % cfg.log_every == 0:
                synchronize()
                step_metrics = {k: float(v) for k, v in dict(step_metrics).items()}
                if cfg.samples_per_step:
                    step_metrics["samples_per_second"] = throughput.per_second
                metrics.log(step, **step_metrics)
            if self.eval_fn is not None and cfg.eval_every and step % cfg.eval_every == 0:
                synchronize()
                metrics.log(step, **{f"eval/{k}": v for k, v in self.eval_fn(state, step).items()})
            if ckpt is not None and step % ckpt.save_every == 0:
                synchronize()
                ckpt.save(step, state)
            if should_stop(cfg.run_dir):
                break

        synchronize()
        if ckpt is not None:
            ckpt.save(step, state)
        metrics.close()
        return state
