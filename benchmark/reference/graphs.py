"""The benchmark's instance generators: frozen copies of networkx's
`gnm_random_graph` and `barabasi_albert_graph`, draw for draw on Python's
`random.Random(seed)` stream, so that Gset G22's stand-in and the BA
distribution's `BA_<n>_ID<k>` instances come out edge for edge as the
repository's published tables have them.

Both the program (through its `Graph`) and the plain reference are handed
the edges made here. Edges are (i, j) with i < j, sorted, weight 1.
"""

from __future__ import annotations

import random
from typing import Dict, List, Set, Tuple

import numpy as np


class _AdjDict:
    """Insertion-ordered adjacency, as networkx keeps it."""

    def __init__(self, nodes=()):
        self.adj: Dict[int, Dict[int, None]] = {v: {} for v in nodes}

    def add_edge(self, u: int, v: int) -> None:
        self.adj.setdefault(u, {})
        self.adj.setdefault(v, {})
        self.adj[u][v] = None
        self.adj[v][u] = None

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.adj.get(u, {})

    def edges(self) -> List[Tuple[int, int]]:
        return [(u, v) for u, nbrs in self.adj.items() for v in nbrs if u < v]


def _random_subset(seq: List[int], m: int, rng: random.Random) -> Set[int]:
    targets: Set[int] = set()
    while len(targets) < m:
        targets.add(rng.choice(seq))
    return targets


def gnm_edges(n: int, m: int, seed: int) -> np.ndarray:
    """networkx's `gnm_random_graph(n, m, seed)` (m < n (n - 1) / 2): int64 [m, 2]."""
    rng = random.Random(seed)
    g = _AdjDict(range(n))
    nodes = list(range(n))
    count = 0
    while count < m:
        u, v = rng.choice(nodes), rng.choice(nodes)
        if u == v or g.has_edge(u, v):
            continue
        g.add_edge(u, v)
        count += 1
    return _sorted(g.edges())


def ba_edges(n: int, m: int, seed: int) -> np.ndarray:
    """networkx's `barabasi_albert_graph(n, m, seed)`: int64 [E, 2]."""
    rng = random.Random(seed)
    g = _AdjDict(range(m + 1))
    for leaf in range(1, m + 1):
        g.add_edge(0, leaf)
    repeated = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets = _random_subset(repeated, m, rng)
        for t in targets:
            g.add_edge(source, t)
        repeated.extend(targets)
        repeated.extend([source] * m)
    return _sorted(g.edges())


def _sorted(edges) -> np.ndarray:
    e = np.asarray(sorted((min(a, b), max(a, b)) for a, b in edges), dtype=np.int64)
    return e.reshape(-1, 2)


def make_edges(spec: dict, instance_seed: int = None) -> np.ndarray:
    """The edges of a configuration's `graph` block: {"generator": "gnm",
    "num_nodes", "num_edges", "seed"} or {"generator": "ba", "num_nodes",
    "m"} with the instance's seed."""
    gen = spec["generator"]
    if gen == "gnm":
        return gnm_edges(spec["num_nodes"], spec["num_edges"], spec["seed"])
    if gen == "ba":
        return ba_edges(spec["num_nodes"], spec["m"], instance_seed)
    raise ValueError(f"unknown generator {gen!r}")


def adjacency(edges: np.ndarray, n: int) -> np.ndarray:
    """Dense symmetric unit adjacency f32 [n, n]."""
    a = np.zeros((n, n), np.float32)
    a[edges[:, 0], edges[:, 1]] = 1.0
    a[edges[:, 1], edges[:, 0]] = 1.0
    return a


def cut_of(bits: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Exact cut of bits [B, n] (or [n]) on unit edges, int64."""
    b = np.asarray(bits, bool)
    return (b[..., edges[:, 0]] != b[..., edges[:, 1]]).sum(axis=-1).astype(np.int64)
