"""Deep compressed sensing and ISTA/LISTA sparse recovery (counterpart of
`rlsolver_tpu/algos/dcs.py`; RLSolver's
`methods_problem_specific/compressive_sensing/`, after Wu et al. 2019).

A generator G(z) is trained jointly with a learned measurement operator F
and a learned step size: recovery runs `num_grad_iters` latent gradient
steps z <- z - eta grad_z ||F G(z) - y||^2 (`nn_dcs.py:99-122`), and
training backpropagates the reconstruction error through those steps, so
it differentiates through a gradient (`torch.autograd.grad(...,
create_graph=True)`, as `jax.grad` inside the JAX loss). Synthetic k-sparse
Gaussian signals stand in for MNIST. ISTA is the classic LASSO baseline,
LISTA its unrolled learned form. Draws come from a generator or are
injected (`DCSDraws`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense, lecun_normal
from rlsolver_tpu_torch.optim import ClippedAdam


# ------------------------------------------------------------ classic ISTA
def ista(f: torch.Tensor, y: torch.Tensor, lam: float = 0.05, num_iters: int = 200) -> torch.Tensor:
    """Batched ISTA for min ||F x - y||^2 / 2 + lam ||x||_1; f [M, N], y
    [B, M] -> x [B, N]. Step 1 / L, L = ||F||_2^2 by 20 power iterations."""
    v = torch.ones(f.shape[1], device=f.device)
    for _ in range(20):
        v = f.T @ (f @ v)
        v = v / torch.linalg.norm(v)
    step = 1.0 / torch.linalg.norm(f @ v) ** 2

    def soft(x, t):
        return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)

    x = torch.zeros(y.shape[0], f.shape[1], device=f.device)
    for _ in range(num_iters):
        x = soft(x - step * ((x @ f.T - y) @ f), step * lam)
    return x


class Lista(nn.Module):
    """Learned ISTA: `num_layers` unrolled iterations with a learned W
    [M, N], S_t [N, N] (near the identity) and thresholds softplus(theta_t)."""

    def __init__(self, num_measure: int, signal_dim: int, num_layers: int = 8, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.num_layers = num_layers
        self.w = nn.Parameter(lecun_normal((num_measure, signal_dim), num_measure, gen))
        for t in range(num_layers):
            s = torch.eye(signal_dim) * 0.9 + torch.randn(signal_dim, signal_dim, generator=gen) * 0.01
            self.register_parameter(f"s{t}", nn.Parameter(s))
            self.register_parameter(f"theta{t}", nn.Parameter(torch.tensor(-3.0)))  # softplus(-3) ~ 0.049
        self.to(resolve_device(device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = y @ self.w
        for t in range(self.num_layers):
            h = y @ self.w + x @ getattr(self, f"s{t}")
            x = torch.sign(h) * torch.clamp(torch.abs(h) - nn.functional.softplus(getattr(self, f"theta{t}")), min=0.0)
        return x


# ------------------------------------------------------------------- DCS
class Generator(nn.Module):
    """z -> signal MLP (`nn_dcs.py:48-61`): Dense_0, relu, Dense_1, relu, Dense_2."""

    def __init__(self, latent_dim: int, out_dim: int, mid_dim: int = 256, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = Dense(latent_dim, mid_dim, gen)
        self.Dense_1 = Dense(mid_dim, mid_dim, gen)
        self.Dense_2 = Dense(mid_dim, out_dim, gen)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(z)))))


@dataclasses.dataclass
class DCSConfig:
    signal_dim: int = 64
    latent_dim: int = 16
    num_measure: int = 24
    sparsity: int = 6
    num_grad_iters: int = 5  # latent steps (`num_grad_iters`, nn_dcs.py:122)
    lr: float = 1e-3
    num_epochs: int = 300
    batch_size: int = 64
    learn_f: bool = True  # the measurement F learned too
    seed: int = 0


def sparse_signals(gen: Optional[torch.Generator], batch: int, dim: int, sparsity: int, device=None,
                   scores: Optional[torch.Tensor] = None, vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Synthetic k-sparse Gaussian signals [batch, dim]: normal values kept
    where the uniform `scores` are among each row's `sparsity` smallest."""
    if scores is None:
        scores = torch.rand(batch, dim, generator=gen, device=device)
    if vals is None:
        vals = torch.randn(batch, dim, generator=gen, device=device)
    thresh = torch.sort(scores, dim=1).values[:, sparsity - 1][:, None]
    return vals * (scores <= thresh)


class DCSDraws(NamedTuple):
    """One training step's signals [B, N] and latent starts [B, latent]."""

    x: torch.Tensor
    z0: torch.Tensor


class DCS:
    """Joint training of G, F (unless `learn_f` is off) and the step size.
    `params` = {"gen.Dense_0.kernel", ..., "f" [M, N], "log_step" []}."""

    def __init__(self, cfg: DCSConfig = DCSConfig(), device=None, params: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg, self.device = cfg, resolve_device(device)
        self.gen = Generator(cfg.latent_dim, cfg.signal_dim, gen=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(cfg.seed)
        if params is None:
            f0 = torch.randn(cfg.num_measure, cfg.signal_dim, generator=self.rng, device=self.device)
            params = {**{"gen." + k: v.detach().clone() for k, v in self.gen.state_dict().items()},
                      "f": f0 / np.sqrt(cfg.num_measure),
                      "log_step": torch.tensor(np.log(0.01), dtype=torch.float32)}
        self.params = {k: v.to(self.device).detach().clone().requires_grad_(True) for k, v in params.items()}
        self.names = list(self.params)
        self.opt = ClippedAdam([self.params[k] for k in self.names], cfg.lr, max_norm=None)

    def _gen_params(self, params):
        return {k[len("gen."):]: v for k, v in params.items() if k.startswith("gen.")}

    def recover_latent(self, params, y: torch.Tensor, z0: torch.Tensor, create_graph: bool = True) -> torch.Tensor:
        """`num_grad_iters` latent gradient steps from z0 (the "+ grad" path);
        with `create_graph` the steps stay differentiable in the params."""
        step, f, gp = torch.exp(params["log_step"]), params["f"], self._gen_params(params)
        z = z0 if z0.requires_grad else z0.detach().requires_grad_(True)
        with torch.enable_grad():
            for _ in range(self.cfg.num_grad_iters):
                loss = torch.sum((functional_call(self.gen, gp, (z,)) @ f.T - y) ** 2)
                (g,) = torch.autograd.grad(loss, z, create_graph=create_graph)
                z = z - step * g
                if not create_graph:
                    z = z.detach().requires_grad_(True)
        return z

    def reconstruct(self, params, y: torch.Tensor, z0: torch.Tensor, create_graph: bool = True) -> torch.Tensor:
        z = self.recover_latent(params, y, z0, create_graph)
        return functional_call(self.gen, self._gen_params(params), (z,))

    def draw(self) -> DCSDraws:
        cfg = self.cfg
        x = sparse_signals(self.rng, cfg.batch_size, cfg.signal_dim, cfg.sparsity, self.device)
        return DCSDraws(x, torch.randn(cfg.batch_size, cfg.latent_dim, generator=self.rng, device=self.device))

    def train_step(self, draws: Optional[DCSDraws] = None) -> float:
        """One Adam step on the mean squared reconstruction error through
        the latent steps (second order); returns the loss."""
        x, z0 = draws if draws is not None else self.draw()
        x, z0 = x.to(self.device), z0.to(self.device)
        xhat = self.reconstruct(self.params, x @ self.params["f"].T, z0)
        loss = torch.mean(torch.sum((xhat - x) ** 2, dim=1))
        self.opt.zero_grad()
        loss.backward()
        if not self.cfg.learn_f:
            self.params["f"].grad = torch.zeros_like(self.params["f"])
        self.opt.step()
        return float(loss.detach())

    def train(self, timings: Optional[List[float]] = None) -> List[float]:
        import time

        history = []
        for _ in range(self.cfg.num_epochs):
            t0 = time.time()
            history.append(self.train_step())
            if timings is not None:
                timings.append(time.time() - t0)
        return history

    def recovery_error(self, num_eval: int = 128, gen: Optional[torch.Generator] = None) -> float:
        """Mean ||x - xhat||_2 over fresh signals (the readme's metric), from
        `gen` (seeded seed + 999 when None)."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed + 999)
        x = sparse_signals(gen, num_eval, cfg.signal_dim, cfg.sparsity, self.device)
        z0 = torch.randn(num_eval, cfg.latent_dim, generator=gen, device=self.device)
        params = {k: v.detach() for k, v in self.params.items()}
        xhat = self.reconstruct(params, x @ params["f"].T, z0, create_graph=False).detach()
        return float(torch.linalg.norm(xhat - x, dim=1).mean())
