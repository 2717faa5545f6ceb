"""The JAX package's optimizer, `optax.chain(optax.clip_by_global_norm(1.0),
optax.adam(lr))`, written out so that it follows optax step for step; with
`max_norm=None` it is a plain `optax.adam(lr)` (L2A's pretraining). With
`schedule_steps=T` the step size follows `optax.linear_schedule(lr, 0, T)`
over optax's update count c = 0, 1, ...: lr (1 - min(c, T) / T), in f32
(PPO's annealed learning rate).

Two places where the torch built-ins differ from optax:
  * optax scales the gradients by max_norm / norm only when norm >= max_norm;
    `torch.nn.utils.clip_grad_norm_` always scales by max_norm / (norm + 1e-6).
  * optax divides the moments by the bias corrections first and adds eps to
    sqrt(nu_hat); `torch.optim.Adam` folds the corrections into the step size
    and adds eps to sqrt(nu) / sqrt(correction).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class ClippedAdam:
    """Global-norm clipping (none when `max_norm` is None), then Adam, on a
    list of parameters (their .grad; a parameter without one counts as a
    zero gradient, as in JAX); a fixed step size `lr` unless `schedule_steps`
    anneals it linearly to 0."""

    def __init__(self, params, lr: float, max_norm: Optional[float] = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, schedule_steps: Optional[int] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.schedule_steps = schedule_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def corrections(self) -> torch.Tensor:
        """Counts the next update and returns its bias corrections [1 - b1^c,
        1 - b2^c] as f32 on the host."""
        self.count += 1
        count = torch.tensor(self.count, dtype=torch.float32)
        return torch.stack([1 - torch.tensor(self.b1, dtype=torch.float32) ** count,
                            1 - torch.tensor(self.b2, dtype=torch.float32) ** count])

    def state_tensors(self) -> List[torch.Tensor]:
        """The tensors a step writes: the parameters and both moments."""
        return self.params + self.mu + self.nu

    @torch.no_grad()
    def step(self, corr: Optional[torch.Tensor] = None) -> None:
        """One update. The clip is optax's `where`, on the card, so the step
        never waits for it. `corr` is this update's `corrections()` (counted
        here when None); a step captured in a CUDA graph takes it as an
        input (`capture.CapturedCall`), refilled before each replay, and
        then needs a fixed step size."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm) for g in grads]
        lr = self.lr
        if corr is None:
            if self.schedule_steps is not None:
                steps = np.float32(self.schedule_steps)
                lr = float(np.float32(self.lr) * (np.float32(1.0) - np.float32(min(self.count, self.schedule_steps))
                                                  / steps))
            corr = self.corrections()
        elif self.schedule_steps is not None:
            raise ValueError("a step given its bias corrections takes a fixed step size")
        if self.params:
            corr = corr.to(self.params[0].device)
        c1, c2 = corr[0], corr[1]
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(-lr * update)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": [m.clone() for m in self.mu], "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
