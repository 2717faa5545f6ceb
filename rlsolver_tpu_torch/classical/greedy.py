"""Greedy baselines (counterpart of `rlsolver_tpu/classical/greedy.py`;
RLSolver's `methods/greedy.py:33-336`).

`greedy_maxcut`: steepest-ascent 1-flip greedy for maxcut, batched over
starts.
Each step every start takes its best single flip while that flip gains;
the gains follow by a rank-1 update of the flipped node's adjacency row.
JAX's `lax.while_loop` becomes a Python loop whose steps carry a device
mask `do` (the starts that still improve), and the loop's condition is
read on the host once every CHECK_EVERY steps: a step where `do` is
false everywhere changes nothing, so the result is the JAX package's.

The greedy heuristics of the other problems (`greedy_mis`, `greedy_mvc`,
`greedy_set_cover`, `greedy_graph_partitioning`) are sequential host numpy,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops

CHECK_EVERY = 16  # steps between host reads of the loop's condition


def greedy_maxcut(graph: Graph, num_starts: int = 1, generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[np.ndarray, float]:
    """Start 0 is all zeros (the reference's deterministic start); the rest
    are uniform random bits from `generator` (seeded 0 if None). Returns
    (best bits, best cut)."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xs = torch.rand(num_starts, graph.num_nodes, generator=generator, device=dev) < 0.5
    xs[0] = False
    s = cut_ops.signs_from_bits(xs)
    gains = cut_ops.flip_gains_dense(xs, cg)
    vs = cut_ops.cut_dense(xs, cg)
    rows = torch.arange(num_starts, device=dev)
    while bool((gains.max(dim=1).values > 0).any()):
        for _ in range(CHECK_EVERY):
            best = torch.argmax(gains, dim=1)
            g = gains[rows, best]
            do = g > 0  # only the starts that still improve
            s_b = s[rows, best]
            gains = gains + -2.0 * (s_b * do)[:, None] * s * cg.adj[best]
            gains[rows, best] = torch.where(do, -g, g)
            s[rows, best] = torch.where(do, -s_b, s_b)
            vs = vs + torch.where(do, g, 0.0)
    b = int(torch.argmax(vs))
    return (s[b] > 0).cpu().numpy(), float(vs[b])


def greedy_mis(graph: Graph) -> Tuple[np.ndarray, float]:
    """Min-degree greedy independent set (RLSolver's `greedy_MIS`,
    `greedy.py:164-220`): take the alive node of least degree, drop its
    neighbours, lower their neighbours' degrees."""
    nbrs, _, deg = graph.padded_neighbors()
    alive = np.ones(graph.num_nodes, bool)
    chosen = np.zeros(graph.num_nodes, bool)
    deg = deg.astype(np.int64).copy()
    while alive.any():
        cand = np.where(alive)[0]
        v = cand[np.argmin(deg[cand])]
        chosen[v] = True
        alive[v] = False
        for u in nbrs[v]:
            if u < graph.num_nodes and alive[u]:
                alive[u] = False
                for w in nbrs[u]:
                    if w < graph.num_nodes:
                        deg[w] -= 1
    return chosen, float(chosen.sum())


def greedy_mvc(graph: Graph) -> Tuple[np.ndarray, float]:
    """Max-degree greedy vertex cover (RLSolver's `greedy_MVC`,
    `greedy.py:126-162`): take the node that covers most uncovered edges."""
    n0, n1, _ = graph.edge_arrays()
    uncovered = np.ones(graph.num_edges, bool)
    chosen = np.zeros(graph.num_nodes, bool)
    while uncovered.any():
        cnt = np.zeros(graph.num_nodes, np.int64)
        np.add.at(cnt, n0[uncovered], 1)
        np.add.at(cnt, n1[uncovered], 1)
        v = int(cnt.argmax())
        chosen[v] = True
        uncovered &= ~((n0 == v) | (n1 == v))
    return chosen, -float(chosen.sum())


def greedy_set_cover(instance) -> Tuple[np.ndarray, float]:
    """Largest-marginal-cover greedy (RLSolver's `greedy_set_cover`,
    `greedy.py:222-260`). Returns (bits [num_sets], -#sets)."""
    member = instance.membership_matrix()  # [S, I]
    covered = np.zeros(instance.num_items, bool)
    chosen = np.zeros(instance.num_sets, bool)
    while not covered.all():
        marginal = (member & ~covered[None, :]).sum(axis=1)
        marginal[chosen] = -1
        s = int(marginal.argmax())
        if marginal[s] <= 0:
            break  # uncoverable items
        chosen[s] = True
        covered |= member[s]
    return chosen, -float(chosen.sum())


def greedy_graph_partitioning(graph: Graph) -> Tuple[np.ndarray, float]:
    """Balanced partition by greedy swaps (RLSolver's
    `greedy_graph_partitioning`, `greedy.py:80-124`): from the half/half
    split, swap the best pair (one node of each side) while it lowers the
    cut, at most n times."""
    from rlsolver_tpu_torch.problems.objectives import obj_graph_partitioning

    n = graph.num_nodes
    x = np.zeros(n, np.int64)
    x[n // 2 :] = 1
    adj = graph.adjacency_dense().astype(np.float64)
    s = 2.0 * x - 1.0
    gains = s * (adj @ s)  # the cut's change when one node flips alone
    for _ in range(n):
        # swapping i (side 0) and j (side 1) changes the cut by g_i + g_j + 2 A_ij
        i = int(np.argmin(np.where(x == 0, gains, np.inf)))
        j = int(np.argmin(np.where(x == 1, gains, np.inf)))
        if gains[i] + gains[j] + 2 * adj[i, j] >= 0:
            break
        s[i], s[j] = -s[i], -s[j]
        x[i], x[j] = 1 - x[i], 1 - x[j]
        gains = s * (adj @ s)
    return x.astype(bool), obj_graph_partitioning(x, graph)
