"""Training runtime: loop, checkpoint/resume, metrics stream (counterpart
of `rlsolver_tpu/train/`, with `torch.save` checkpoints)."""

from rlsolver_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from rlsolver_tpu_torch.train.metrics import MetricsLogger, Throughput, should_stop
from rlsolver_tpu_torch.train.runner import LoopConfig, TrainLoop

__all__ = [
    "CheckpointManager",
    "LoopConfig",
    "MetricsLogger",
    "Throughput",
    "TrainLoop",
    "restore_checkpoint",
    "save_checkpoint",
    "should_stop",
]
