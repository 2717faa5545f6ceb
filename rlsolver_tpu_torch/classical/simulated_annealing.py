"""Batched simulated annealing over single-bit flips for maxcut (counterpart
of `rlsolver_tpu/classical/simulated_annealing.py:anneal_maxcut`).

`num_chains` chains anneal in lockstep under a geometric temperature decay:
each step every chain proposes one uniform random flip and accepts it by
the Metropolis rule (always when it gains); the flip gains follow by
rank-1 updates. JAX's `lax.scan` is a Python loop. The temperatures are
JAX's: `init * decay ** arange(T)` is an f32 power of an f32 base, which
XLA computes as the C library's `powf`; numpy's scalar float32 power is
that function, so the schedule is built on the host, value for value."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops


@dataclasses.dataclass
class SAConfig:
    num_chains: int = 256
    num_steps: int = 2000
    init_temperature: float = 4.0
    final_temperature: float = 1e-2
    seed: int = 0


class AnnealDraws(NamedTuple):
    """A run's randomness: the start bits [B, N], each step's proposed node
    [T, B] and its acceptance uniform [T, B]."""

    xs0: torch.Tensor
    nodes: torch.Tensor
    u: torch.Tensor


def temperatures(cfg: SAConfig) -> np.ndarray:
    """f32 [T]: init * decay ** t, each power a float32 `powf`."""
    decay = np.float32((cfg.final_temperature / cfg.init_temperature) ** (1.0 / cfg.num_steps))
    powers = np.array([decay ** np.float32(t) for t in range(cfg.num_steps)], np.float32)
    return np.float32(cfg.init_temperature) * powers


def anneal_chains(cg: cut_ops.CutGraph, xs: torch.Tensor, nodes: torch.Tensor, u: torch.Tensor,
                  temps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The annealing loop from start bits xs [B, N], one step per row of
    nodes / u [T, B] at temps [T] -> (best signs [B, N], best cuts [B])."""
    s = cut_ops.signs_from_bits(xs)
    gains = cut_ops.flip_gains_dense(xs, cg)
    vs = cut_ops.cut_dense(xs, cg)
    best_s, best_vs = s.clone(), vs
    rows = torch.arange(xs.shape[0], device=xs.device)
    for t in range(nodes.shape[0]):
        v = nodes[t]
        g = gains[rows, v]
        accept = (u[t] < torch.exp(torch.clamp(g / temps[t], max=0.0))) | (g > 0)
        s_a = s[rows, v]
        gains = gains + -2.0 * (s_a * accept)[:, None] * s * cg.adj[v]
        gains[rows, v] = torch.where(accept, -g, g)
        s[rows, v] = torch.where(accept, -s_a, s_a)
        vs = vs + torch.where(accept, g, 0.0)
        better = vs > best_vs
        best_vs = torch.where(better, vs, best_vs)
        best_s = torch.where(better[:, None], s, best_s)
    return best_s, best_vs


def anneal_maxcut(graph: Graph, cfg: SAConfig = SAConfig(), device=None,
                  draws: Optional[AnnealDraws] = None) -> Tuple[np.ndarray, float]:
    """Returns (best bits [n], best cut). `draws` replaces the generator's."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    n, b, steps = graph.num_nodes, cfg.num_chains, cfg.num_steps
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        draws = AnnealDraws(torch.rand(b, n, generator=gen, device=dev) < 0.5,
                            torch.randint(0, n, (steps, b), generator=gen, device=dev),
                            torch.rand(steps, b, generator=gen, device=dev))
    best_s, best_vs = anneal_chains(cg, torch.as_tensor(draws.xs0, device=dev).bool(),
                                    torch.as_tensor(draws.nodes, device=dev).long(),
                                    torch.as_tensor(draws.u, device=dev).float(),
                                    torch.from_numpy(temperatures(cfg)).to(dev))
    i = int(torch.argmax(best_vs))
    return (best_s[i] > 0).cpu().numpy(), float(best_vs[i])
