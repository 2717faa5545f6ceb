"""MCPG's policy (counterpart of `rlsolver_tpu/models/policy.py:BernoulliPolicy`):
a free per-node logit vector mapped through a sigmoid and squashed into
(lo, lo + span) so that no bit saturates (`Simpler`, `MCPG.py:169-186` in
RLSolver)."""

from __future__ import annotations

import torch
from torch import nn

from rlsolver_tpu_torch.device import resolve_device


class BernoulliPolicy(nn.Module):
    """Per-node Bernoulli probabilities. Logits start at zero, on `cuda`
    unless the caller passes `device="cpu"`."""

    def __init__(self, num_nodes: int, lo: float = 0.2, span: float = 0.6, device=None):
        super().__init__()
        self.lo, self.span = lo, span
        self.logits = nn.Parameter(torch.zeros(num_nodes, dtype=torch.float32, device=resolve_device(device)))

    def forward(self) -> torch.Tensor:
        return torch.sigmoid(self.logits) * self.span + self.lo
