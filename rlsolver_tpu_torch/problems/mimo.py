"""MIMO maximum-likelihood detection as an Ising problem, and its linear
baselines (counterpart of `rlsolver_tpu/problems/mimo.py`; RLSolver
`MCPG/dataloader.py:297-430`, `read_data_mimo3/5`, `MCPG/sampling.py:288-323`,
`mcpg_sampling_mimo`, and the zero-forcing and MMSE detectors of
`mimo_beamforming/.../baseline_zf_mmse.py`).

BPSK symbols over a complex channel, written in the real (re, im) block form
that defines the instance: x in {-1, +1}^{2K}, E(x) = ||y - H x||^2 =
x^T Sigma x + d.x + y.y with Sigma = H^T H, d = -2 H^T y. The sweep sets
x_i <- -sign(2 (Sigma_off x)_i + d_i) coordinate by coordinate, keeping the
field Sigma_off x up to date with one rank-1 update each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rlsolver_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MimoInstance:
    """h: [2M, 2K] real channel; y: [2M] received; x_true: [2K] +-1 sent;
    snr_db: the SNR per symbol; sigma2: the real noise variance per
    component."""

    h: np.ndarray
    y: np.ndarray
    x_true: np.ndarray
    snr_db: float
    sigma2: float

    @property
    def num_vars(self) -> int:
        return int(self.h.shape[1])


def generate_mimo(k: int, m: Optional[int] = None, snr_db: float = 10.0, seed: int = 0) -> MimoInstance:
    """A complex Gaussian channel [M, K], BPSK symbols and white noise at
    `snr_db` (`read_data_mimo5`: noise scaled by sqrt(K 10^(-SNR/10))),
    drawn by `numpy.random.RandomState(seed)` as the JAX package draws it."""
    m = m or k
    rng = np.random.RandomState(seed)
    hc = (rng.randn(m, k) + 1j * rng.randn(m, k)) / np.sqrt(2.0)
    h = np.block([[hc.real, -hc.imag], [hc.imag, hc.real]])
    x = rng.choice([-1.0, 1.0], size=2 * k)
    sigma2 = k * 10.0 ** (-snr_db / 10.0)
    y = h @ x + rng.randn(2 * m) * np.sqrt(sigma2)
    return MimoInstance(h, y, x, snr_db, sigma2)


class MimoEnv:
    """The detection energy over x in {-1, +1}^{2K} on one device (`cuda`
    unless `device="cpu"`); Sigma, d and y.y computed in float64 on the host,
    then cast to f32."""

    def __init__(self, inst: MimoInstance, device=None):
        self.inst = inst
        self.device = dev = resolve_device(device)
        self.num_vars = inst.num_vars
        sigma = inst.h.T @ inst.h
        self.sigma = torch.from_numpy(sigma.astype(np.float32)).to(dev)
        self.sigma_offdiag = torch.from_numpy((sigma - np.diag(np.diag(sigma))).astype(np.float32)).to(dev)
        self.d = torch.from_numpy((-2.0 * inst.y @ inst.h).astype(np.float32)).to(dev)
        self.const = float(inst.y @ inst.y)
        self.h = torch.from_numpy(inst.h.astype(np.float32)).to(dev)
        self.y = torch.from_numpy(inst.y.astype(np.float32)).to(dev)

    def obj(self, spins: torch.Tensor) -> torch.Tensor:
        """The residual energy ||y - H x||^2, f32 [B] (minimize)."""
        r = self.y[None, :] - spins.to(torch.float32) @ self.h.t()
        return torch.sum(r * r, dim=1)

    def random_spins(self, gen: torch.Generator, num_chains: int) -> torch.Tensor:
        bits = torch.rand(num_chains, self.num_vars, generator=gen, device=self.device) < 0.5
        return torch.where(bits, 1.0, -1.0)

    def sweep(self, spins: torch.Tensor, num_sweeps: int = 1) -> torch.Tensor:
        """Coordinate descent x_i <- -sign(2 (Sigma_off x)_i + d_i) (+1 where
        it is negative, else -1), in coordinate order. f32 spins [B, N] ->
        f32 spins [B, N]."""
        sn = spins.t().to(torch.float32).contiguous()
        hn = self.sigma_offdiag @ sn  # Sigma_off is symmetric: the field, node-major
        for _ in range(num_sweeps):
            for i in range(self.num_vars):
                new = torch.where(2.0 * hn[i] + self.d[i] < 0, 1.0, -1.0)
                hn.addcmul_(self.sigma_offdiag[i][:, None], (new - sn[i])[None, :])
                sn[i] = new
        return sn.t()

    def bit_error_rate(self, spins: torch.Tensor) -> torch.Tensor:
        x = torch.from_numpy(self.inst.x_true.astype(np.float32)).to(spins.device)
        return torch.mean((spins.to(torch.float32) != x[None, :]).to(torch.float32), dim=1)


def detect_zf(inst: MimoInstance) -> np.ndarray:
    """Zero forcing: sign(pinv(H) y)."""
    xh = np.linalg.pinv(inst.h) @ inst.y
    return np.where(xh >= 0, 1.0, -1.0)


def detect_mmse(inst: MimoInstance) -> np.ndarray:
    """MMSE: sign((H^T H + sigma^2 I)^-1 H^T y)."""
    a = inst.h.T @ inst.h + inst.sigma2 * np.eye(inst.num_vars)
    xh = np.linalg.solve(a, inst.h.T @ inst.y)
    return np.where(xh >= 0, 1.0, -1.0)


def detect_ml_brute(inst: MimoInstance) -> np.ndarray:
    """Exact ML by enumerating all 2^{2K} symbol vectors (2K <= 20), on the
    CPU in f32 as the JAX package scores them; the first minimum wins."""
    n = inst.num_vars
    if n > 20:
        raise ValueError("brute-force ML limited to 2K <= 20")
    codes = torch.arange(2**n, dtype=torch.int64)
    spins = torch.where(((codes[:, None] >> torch.arange(n)) & 1) > 0, 1.0, -1.0)
    e = MimoEnv(inst, "cpu").obj(spins)
    return spins[int(torch.argmin(e))].numpy().astype(np.float64)
