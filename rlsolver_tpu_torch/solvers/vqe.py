"""Variational quantum eigensolver baseline on a statevector (counterpart of
`rlsolver_tpu/solvers/vqe.py`; RLSolver `methods/quantum.py:10-106`, qiskit's
SamplingVQE with a TwoLocal(ry, cz) ansatz and SPSA, demo scale).

A TwoLocal(ry, cz) circuit on |0..0> keeps every amplitude real (RY is a
real rotation, CZ a +-1 diagonal), so the state is an f32 vector [2^n]:
each RY layer is a batch of 2 x 2 rotations, each CZ chain a sign mask,
and a diagonal Hamiltonian's energy one dot product. Qubit k is bit k of
the basis index (the least significant first); n <= 16.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device


def basis_bits(n: int, device=None) -> torch.Tensor:
    """Bit table int8 [2^n, n] (on `device`, by default `cuda`): row x is x
    in binary, qubit 0 first."""
    dev = resolve_device(device)
    codes = torch.arange(2**n, device=dev)
    return ((codes[:, None] >> torch.arange(n, device=dev)) & 1).to(torch.int8)


def maxcut_diagonal(graph: Graph, device=None) -> torch.Tensor:
    """The cut of every basis state, f32 [2^n] (the diagonal Hamiltonian),
    on `device` (by default `cuda`)."""
    bits = basis_bits(graph.num_nodes, device)
    e0, e1, w = graph.edge_arrays()
    diff = bits[:, torch.from_numpy(e0).long().to(bits.device)] != bits[:, torch.from_numpy(e1).long().to(bits.device)]
    return (diff.float() * torch.from_numpy(w).to(bits.device)[None, :]).sum(dim=1)


def apply_ry_layer(state: torch.Tensor, thetas: torch.Tensor, n: int) -> torch.Tensor:
    """RY(theta_k) on every qubit k of a real state [2^n]."""
    for k in range(n):
        st = state.reshape(2 ** (n - k - 1), 2, 2**k)
        c, s = torch.cos(thetas[k] / 2.0), torch.sin(thetas[k] / 2.0)
        a, b = st[:, 0, :], st[:, 1, :]
        state = torch.stack([c * a - s * b, s * a + c * b], dim=1).reshape(-1)
    return state


def cz_chain_mask(n: int, device=None) -> torch.Tensor:
    """(-1)^(number of adjacent 11 pairs) of every basis state: CZ on the
    linear chain (k, k + 1), TwoLocal's linear entanglement; on `device`
    (by default `cuda`)."""
    bits = basis_bits(n, device).long()
    pairs = (bits[:, :-1] * bits[:, 1:]).sum(dim=1)
    return torch.where(pairs % 2 == 0, 1.0, -1.0)


def two_local_state(params: torch.Tensor, n: int, reps: int, cz_mask: torch.Tensor) -> torch.Tensor:
    """TwoLocal(ry, cz, reps): reps + 1 RY layers with CZ chains between."""
    state = torch.zeros(2**n, device=params.device)
    state[0] = 1.0
    thetas = params.reshape(reps + 1, n)
    for r in range(reps):
        state = apply_ry_layer(state, thetas[r], n) * cz_mask
    return apply_ry_layer(state, thetas[reps], n)


@dataclasses.dataclass
class VQEConfig:
    reps: int = 2
    num_iters: int = 300
    # SPSA's schedule (Spall's constants, qiskit SPSA's defaults)
    a: float = 0.2
    c: float = 0.2
    alpha: float = 0.602
    gamma: float = 0.101
    seed: int = 0


class SPSADraws(NamedTuple):
    """The draws of a run: the initial parameters, uniform in [-0.1, 0.1)
    [P], and each iteration's perturbation signs, +-1 [I, P]."""

    init: torch.Tensor
    delta: torch.Tensor


def spsa_schedule(cfg: VQEConfig, k: int) -> Tuple[float, float]:
    """(a_k, c_k) = (a / (k + 11)^alpha, c / (k + 1)^gamma) in f32, the
    powers numpy's float32 ones (the C library's powf, as XLA's)."""
    f32 = np.float32
    ak = f32(cfg.a) / np.power(f32(k) + f32(1.0) + f32(10.0), f32(cfg.alpha))
    ck = f32(cfg.c) / np.power(f32(k) + f32(1.0), f32(cfg.gamma))
    return float(ak), float(ck)


def vqe_minimize_diagonal(diag: torch.Tensor, num_qubits: int, cfg: VQEConfig = VQEConfig(),
                          draws: Optional[SPSADraws] = None) -> Tuple[np.ndarray, float, List[float]]:
    """SPSA-minimize <psi(theta)| diag |psi(theta)> on diag's device.
    Returns (the most probable basis state's bits [n], its diagonal value,
    the energy history: (E+ + E-) / 2 each iteration). The draws come from
    a generator seeded with cfg.seed unless `draws` gives them."""
    n, dev = num_qubits, diag.device
    cz_mask = cz_chain_mask(n, dev)
    num_params = (cfg.reps + 1) * n

    def energy(params):
        state = two_local_state(params, n, cfg.reps, cz_mask)
        return torch.dot(state * state, diag)

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    if draws is None:
        params = torch.rand(num_params, generator=gen, device=dev) * 0.2 - 0.1
    else:
        params = draws.init.to(dev)
    history = []
    for it in range(cfg.num_iters):
        ak, ck = spsa_schedule(cfg, it)
        if draws is None:
            delta = torch.where(torch.rand(num_params, generator=gen, device=dev) < 0.5, 1.0, -1.0)
        else:
            delta = draws.delta[it].to(dev)
        e_plus, e_minus = energy(params + ck * delta), energy(params - ck * delta)
        ghat = (e_plus - e_minus) / (2.0 * ck) * delta
        params = params - ak * ghat
        history.append((e_plus + e_minus) / 2.0)
    probs = two_local_state(params, n, cfg.reps, cz_mask) ** 2
    best = int(torch.argmax(probs))
    bits = np.asarray((best >> np.arange(n)) & 1, np.int8)
    return bits, float(diag[best]), [float(h) for h in history]


def vqe_maxcut(graph: Graph, cfg: VQEConfig = VQEConfig(), device=None,
               draws: Optional[SPSADraws] = None) -> Tuple[np.ndarray, float, List[float]]:
    """Maxcut by VQE (`quantum.py`): maximize the cut = minimize its
    negation, on `cuda` unless `device="cpu"`. Returns (bits, cut, energy
    history)."""
    if graph.num_nodes > 16:
        raise ValueError("statevector VQE limited to 16 qubits")
    diag = maxcut_diagonal(graph, device)
    bits, value, history = vqe_minimize_diagonal(-diag, graph.num_nodes, cfg, draws)
    return bits, -value, [-h for h in history]
