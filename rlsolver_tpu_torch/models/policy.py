"""Policy networks for the Pattern-II methods (counterpart of
`rlsolver_tpu/models/policy.py`):

  * BernoulliPolicy, MCPG's policy: a free per-node logit vector mapped
    through a sigmoid and squashed into (lo, lo + span) so that no bit
    saturates (`Simpler`, `MCPG.py:169-186` in RLSolver);
  * PolicyMLP, L2A's solution-probability refiner (`L2A/network.py:124-143`):
    [B, N] -> [B, N] in (0, 1), flax's names (`hidden_0`, ..., `out`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense


class BernoulliPolicy(nn.Module):
    """Per-node Bernoulli probabilities. Logits start at zero, on `cuda`
    unless the caller passes `device="cpu"`."""

    def __init__(self, num_nodes: int, lo: float = 0.2, span: float = 0.6, device=None):
        super().__init__()
        self.lo, self.span = lo, span
        self.logits = nn.Parameter(torch.zeros(num_nodes, dtype=torch.float32, device=resolve_device(device)))

    def forward(self) -> torch.Tensor:
        return torch.sigmoid(self.logits) * self.span + self.lo


class PolicyMLP(nn.Module):
    """ReLU layers of `hidden` widths, then a sigmoid output of N, with
    flax's [in, out] kernels initialised as flax does from a generator
    seeded `seed` (load JAX's with `convert.flax_state_dict`)."""

    def __init__(self, num_nodes: int, hidden: Sequence[int] = (256, 256), seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        widths = [num_nodes, *hidden]
        self.hidden = len(hidden)
        for i in range(self.hidden):
            setattr(self, f"hidden_{i}", Dense(widths[i], widths[i + 1], gen))
        self.out = Dense(widths[-1], num_nodes, gen)
        self.to(resolve_device(device))

    def forward(self, probs: torch.Tensor) -> torch.Tensor:
        x = probs
        for i in range(self.hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        return torch.sigmoid(self.out(x))
