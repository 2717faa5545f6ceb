"""Batched random walk for maxcut (counterpart of
`rlsolver_tpu/classical/random_walk.py`): every chain flips one uniform
random node a step and keeps the best solution it has seen. JAX's
`lax.scan` is a Python loop; the flip gains follow by rank-1 updates."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops


class WalkDraws(NamedTuple):
    """A run's randomness: the start bits [B, N] and each step's node [T, B]."""

    xs0: torch.Tensor
    nodes: torch.Tensor


def random_walk_maxcut(graph: Graph, num_chains: int = 256, num_steps: int = 2000, seed: int = 0, device=None,
                       draws: Optional[WalkDraws] = None) -> Tuple[np.ndarray, float]:
    """Returns (best bits, best cut). `draws` replaces the generator's."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    n, b = graph.num_nodes, num_chains
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = WalkDraws(torch.rand(b, n, generator=gen, device=dev) < 0.5,
                          torch.randint(0, n, (num_steps, b), generator=gen, device=dev))
    xs = torch.as_tensor(draws.xs0, device=dev).bool()
    nodes_all = torch.as_tensor(draws.nodes, device=dev).long()
    s = cut_ops.signs_from_bits(xs)
    gains = cut_ops.flip_gains_dense(xs, cg)
    vs = cut_ops.cut_dense(xs, cg)
    best_s, best_vs = s.clone(), vs
    rows = torch.arange(b, device=dev)
    for t in range(num_steps):
        nodes = nodes_all[t]
        g = gains[rows, nodes]
        s_a = s[rows, nodes]
        gains = gains - 2.0 * s_a[:, None] * s * cg.adj[nodes]
        gains[rows, nodes] = -g
        s[rows, nodes] = -s_a
        vs = vs + g
        better = vs > best_vs
        best_vs = torch.where(better, vs, best_vs)
        best_s = torch.where(better[:, None], s, best_s)
    i = int(torch.argmax(best_vs))
    return (best_s[i] > 0).cpu().numpy(), float(best_vs[i])
