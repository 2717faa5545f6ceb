"""Graph-coloring heuristics (counterpart of `rlsolver_tpu/classical/coloring.py`;
RLSolver's `methods_problem_specific/graph_coloring/`): first-fit greedy,
Welsh-Powell, DSATUR and recursive largest-first. Each is a sequential
ordering, so host numpy, as in the JAX package. All return (colors [n]
int32 in 0..k-1, k)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph


def _color_order(graph: Graph, order) -> Tuple[np.ndarray, int]:
    """First-fit coloring along `order`."""
    nbrs, _, deg = graph.padded_neighbors()
    colors = np.full(graph.num_nodes, -1, np.int32)
    for v in order:
        used = {int(colors[nbrs[v, k]]) for k in range(deg[v]) if colors[nbrs[v, k]] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors, int(colors.max(initial=-1)) + 1


def greedy_coloring(graph: Graph) -> Tuple[np.ndarray, int]:
    """First-fit in natural node order (`graph_coloring/greedy.py`)."""
    return _color_order(graph, range(graph.num_nodes))


def welsh_powell(graph: Graph) -> Tuple[np.ndarray, int]:
    """First-fit in descending-degree order (`welsh_powell.py`)."""
    return _color_order(graph, np.argsort(-graph.degrees(), kind="stable"))


def dsatur(graph: Graph) -> Tuple[np.ndarray, int]:
    """DSATUR (`degree_of_saturation.py`): color next the uncolored node
    with the most distinct neighbour colors, ties by degree, then by the
    lowest index."""
    n = graph.num_nodes
    nbrs, _, deg = graph.padded_neighbors()
    colors = np.full(n, -1, np.int32)
    sat = [set() for _ in range(n)]
    for _ in range(n):
        best, best_key = -1, (-1, -1)
        for v in range(n):
            if colors[v] >= 0:
                continue
            key = (len(sat[v]), int(deg[v]))
            if key > best_key:
                best, best_key = v, key
        c = 0
        while c in sat[best]:
            c += 1
        colors[best] = c
        for k in range(deg[best]):
            sat[int(nbrs[best, k])].add(c)
    return colors, int(colors.max(initial=-1)) + 1


def recursive_largest_first(graph: Graph) -> Tuple[np.ndarray, int]:
    """RLF (`recursive_largest_first.py`): one maximal independent set per
    color, preferring nodes with many uncolored neighbours outside the
    candidates."""
    n = graph.num_nodes
    adj = graph.adjacency_dense() > 0
    colors = np.full(n, -1, np.int32)
    color = 0
    uncolored = np.ones(n, bool)
    while uncolored.any():
        candidates = uncolored.copy()
        in_class = np.zeros(n, bool)
        while candidates.any():
            score = (adj[:, uncolored & ~candidates]).sum(axis=1)
            score = np.where(candidates, score, -1)
            v = int(score.argmax())
            in_class[v] = True
            candidates[v] = False
            candidates &= ~adj[v]
        colors[in_class] = color
        uncolored &= ~in_class
        color += 1
    return colors, color


def is_proper_coloring(graph: Graph, colors: np.ndarray) -> bool:
    """No edge joins two nodes of one color, and every color is >= 0."""
    a, b = graph.edges[:, 0], graph.edges[:, 1]
    return bool((colors[a] != colors[b]).all()) and colors.min(initial=0) >= 0
