"""QUBO / Ising: batched energies and incremental coordinate sweeps
(counterpart of `rlsolver_tpu/problems/qubo.py`; RLSolver
`MCPG/sampling.py:325-370`, `mcpg_sampling_qubo` and `mcpg_sampling_qubo_bin`,
and `dataloader.py:278-293`, `qubo_dataloader`).

Both variables domains maximize x^T Q x: spins in {-1, +1} with the sweep
x_i <- sign(sum_{j != i} Q_ij x_j), or bits in {0, 1} with the threshold
-Q_ii / 2. A sweep keeps the field h = Q x up to date with one rank-1 update
per coordinate (as the JAX package does), node-major [N, B] so that a
coordinate's field and value are contiguous rows; one step is a handful of
launches and one [N, B] update.
"""

from __future__ import annotations

import numpy as np
import torch

from rlsolver_tpu_torch.device import resolve_device


def read_qubo(path: str) -> np.ndarray:
    """Dense Q from whitespace- or comma-separated text, one row a line."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.replace(",", " ").strip()
            if line:
                rows.append([float(x) for x in line.split()])
    q = np.asarray(rows, np.float64)
    if q.shape[0] != q.shape[1]:
        raise ValueError(f"Q must be square, got {q.shape}")
    return q


class QuboEnv:
    """The symmetrized Q (in float64 on the host, then cast to f32) on one
    device, `cuda` unless the caller passes `device="cpu"`."""

    def __init__(self, q: np.ndarray, device=None):
        q = np.asarray(q, np.float64)
        self.device = resolve_device(device)
        self.num_vars = q.shape[0]
        self.q = torch.from_numpy(((q + q.T) / 2.0).astype(np.float32)).to(self.device)
        self.q_diag = torch.diagonal(self.q).clone()

    def _energy(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        return torch.sum((x @ self.q) * x, dim=1)

    def _sweep(self, x: torch.Tensor, num_sweeps: int, binary: bool) -> torch.Tensor:
        """Sequential coordinate sweeps on f32 x [B, N]; returns xn [N, B]."""
        xn = x.t().to(torch.float32).contiguous()
        hn = self.q @ xn  # the field, self term included
        lo = 0.0 if binary else -1.0
        thr = -self.q_diag / 2.0 if binary else torch.zeros_like(self.q_diag)
        for _ in range(num_sweeps):
            for i in range(self.num_vars):
                field = hn[i] - self.q_diag[i] * xn[i]
                new = torch.where(field > thr[i], 1.0, lo)
                hn.addcmul_(self.q[i][:, None], (new - xn[i])[None, :])
                xn[i] = new
        return xn

    def obj_pm(self, spins: torch.Tensor) -> torch.Tensor:
        """x in {-1, +1} [B, N]: x^T Q x, f32 [B]."""
        return self._energy(spins)

    def sweep_pm(self, spins: torch.Tensor, num_sweeps: int = 1) -> torch.Tensor:
        """x_i <- sign(sum_{j != i} Q_ij x_j) (-1 on 0), coordinates in
        order, `num_sweeps` times. f32 spins [B, N] -> f32 spins [B, N]."""
        return self._sweep(spins, num_sweeps, binary=False).t()

    def obj_bin(self, bits: torch.Tensor) -> torch.Tensor:
        """x in {0, 1} [B, N]: x^T Q x, f32 [B]."""
        return self._energy(bits)

    def sweep_bin(self, bits: torch.Tensor, num_sweeps: int = 1) -> torch.Tensor:
        """x_i <- [sum_{j != i} Q_ij x_j > -Q_ii / 2], coordinates in order.
        bits [B, N] -> bool [B, N]."""
        return self._sweep(bits, num_sweeps, binary=True).t() > 0.5


def maxcut_to_qubo(adjacency: np.ndarray) -> np.ndarray:
    """Maxcut as a +-1 QUBO: x^T (-A) x = 4 cut(x) - 2 W (W the total
    weight), so maximizing it maximizes the cut (PISCO's dense form,
    `envs/env_ISCO.py:436-444` in RLSolver)."""
    return -np.asarray(adjacency, np.float64)
