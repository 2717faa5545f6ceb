"""Prioritized experience replay (counterpart of `rlsolver_tpu/train/replay.py`;
RLSolver `elegantrl/train/replay_buffer.py:226-307`, the SumTree variant).

Priorities live in a flat [capacity] vector, 0 marking an empty slot; a
sample draws `batch` indices in proportion to the priorities (argmax of
log-priorities plus Gumbel noise, JAX's `categorical`), and importance
weights follow (N P(i))^-beta, normalised to a maximum of 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rlsolver_tpu_torch.ops.sampling import gumbel_noise


class PrioritizedReplay(NamedTuple):
    data: tuple  # tensors [capacity, ...]
    priorities: torch.Tensor  # f32 [capacity], 0 = empty slot
    ptr: int
    size: int
    alpha: float  # priority exponent
    max_priority: torch.Tensor  # f32 0-d

    @staticmethod
    def create(example: tuple, capacity: int, alpha: float = 0.6, device=None) -> "PrioritizedReplay":
        """Empty buffer for items shaped and typed like `example` (tensors),
        on `device` (default: the example's)."""
        data = tuple(torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                 device=x.device if device is None else device) for x in example)
        dev = data[0].device
        return PrioritizedReplay(data, torch.zeros(capacity, device=dev), 0, 0, alpha,
                                 torch.ones((), device=dev))


def per_add(buf: PrioritizedReplay, item: tuple) -> PrioritizedReplay:
    """Insert at `ptr` with max priority ** alpha (a new item is seen at
    least once). The data and priority tensors are written in place."""
    cap = buf.priorities.shape[0]
    for d, x in zip(buf.data, item):
        d[buf.ptr] = x
    buf.priorities[buf.ptr] = buf.max_priority ** buf.alpha
    return buf._replace(ptr=(buf.ptr + 1) % cap, size=min(buf.size + 1, cap))


def per_sample(buf: PrioritizedReplay, gen: Optional[torch.Generator], batch: int, beta: float = 0.4,
               gumbel: Optional[torch.Tensor] = None) -> Tuple[tuple, torch.Tensor, torch.Tensor]:
    """(batch items, indices [batch], importance weights [batch]), indices
    drawn in proportion to the priorities; the Gumbel noise [batch,
    capacity] comes from `gen` unless given."""
    logits = torch.where(buf.priorities > 0, torch.log(buf.priorities + 1e-12),
                         torch.tensor(float("-inf"), device=buf.priorities.device))
    if gumbel is None:
        gumbel = gumbel_noise((batch, logits.shape[0]), gen, logits.device)
    idx = (gumbel.to(logits.device) + logits).argmax(dim=1)
    probs = buf.priorities / torch.clamp(buf.priorities.sum(), min=1e-12)
    w = (max(buf.size, 1) * probs[idx]) ** (-beta)
    return tuple(d[idx] for d in buf.data), idx, w / w.max()


def per_update(buf: PrioritizedReplay, idx: torch.Tensor, td_errors: torch.Tensor) -> PrioritizedReplay:
    """Write back (|TD error| + 1e-6) ** alpha for the sampled indices (a
    repeated index keeps its last write) and raise the max priority."""
    err = torch.abs(td_errors) + 1e-6
    idx = idx.long()
    # each slot's last position in idx (scatter order on the card is not fixed)
    last = torch.full_like(buf.priorities, -1, dtype=torch.long).scatter_reduce(
        0, idx, torch.arange(idx.shape[0], device=idx.device), "amax")
    priorities = torch.where(last >= 0, (err ** buf.alpha)[last.clamp(min=0)], buf.priorities)
    return buf._replace(priorities=priorities, max_priority=torch.maximum(buf.max_priority, err.max()))
