"""Seeded synthetic instances (counterpart of `rlsolver_tpu/core/generate.py`).

The JAX package draws its instances with networkx; the machine that runs the
port has no networkx, so this module re-implements the four networkx
generators it uses, draw for draw on the same `random.Random(seed)` stream:

  BA: barabasi_albert_graph(n, m=4)          (star seed graph, preferential
      attachment through `_random_subset`)
  ER: erdos_renyi_graph(n, p=0.15)           (one `random()` per node pair)
  PL: powerlaw_cluster_graph(n, m=4, p=0.05) (Holme-Kim triangles)
  G(n, m): gnm_random_graph                  (two `choice` calls per try)

Same seeds give the same edge sets as networkx (tested). The name
"BA_100_ID7" means: seed 7, BA, 100 nodes. All weights are 1.
"""

from __future__ import annotations

import itertools
import random
import re
from typing import Dict, List, Optional, Set

import numpy as np

from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.graph import Graph

_NAME_RE = re.compile(r"^(BA|ER|PL)_(\d+)(?:_ID(\d+))?$")


def _rng(seed: Optional[int]) -> random.Random:
    return random.Random(seed) if seed is not None else random.Random()


def _random_subset(seq: List[int], m: int, rng: random.Random) -> Set[int]:
    """m distinct elements of seq, drawn with `choice` until m are found.
    Returned as a set: its iteration and `pop` order are part of the
    generators' output."""
    targets: Set[int] = set()
    while len(targets) < m:
        targets.add(rng.choice(seq))
    return targets


class _AdjDict:
    """Insertion-ordered adjacency, in the order networkx keeps it: the
    powerlaw generator reads a node's neighbours in that order."""

    def __init__(self, nodes=()):
        self.adj: Dict[int, Dict[int, None]] = {v: {} for v in nodes}

    def add_edge(self, u: int, v: int) -> None:
        self.adj.setdefault(u, {})
        self.adj.setdefault(v, {})
        self.adj[u][v] = None
        self.adj[v][u] = None

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.adj.get(u, {})

    def edges(self):
        return [(u, v) for u, nbrs in self.adj.items() for v in nbrs if u < v]


def _barabasi_albert(n: int, m: int, rng: random.Random) -> _AdjDict:
    g = _AdjDict(range(m + 1))
    for leaf in range(1, m + 1):  # star graph on m + 1 nodes
        g.add_edge(0, leaf)
    repeated = [0] * m + list(range(1, m + 1))  # node v repeated deg(v) times
    for source in range(m + 1, n):
        targets = _random_subset(repeated, m, rng)
        for t in targets:
            g.add_edge(source, t)
        repeated.extend(targets)
        repeated.extend([source] * m)
    return g


def _erdos_renyi(n: int, p: float, rng: random.Random) -> _AdjDict:
    g = _AdjDict(range(n))
    for u, v in itertools.combinations(range(n), 2):
        if rng.random() < p:
            g.add_edge(u, v)
    return g


def _powerlaw_cluster(n: int, m: int, p: float, rng: random.Random) -> _AdjDict:
    g = _AdjDict(range(m))
    repeated = list(range(m))
    for source in range(m, n):
        possible = _random_subset(repeated, m, rng)
        target = possible.pop()
        g.add_edge(source, target)
        repeated.append(target)
        count = 1
        while count < m:
            if rng.random() < p:
                hood = [
                    nbr for nbr in g.adj[target]
                    if not g.has_edge(source, nbr) and nbr != source
                ]
                if hood:
                    nbr = rng.choice(hood)
                    g.add_edge(source, nbr)
                    repeated.append(nbr)
                    count += 1
                    continue
            target = possible.pop()
            g.add_edge(source, target)
            repeated.append(target)
            count += 1
        repeated.extend([source] * m)
    return g


def gnm_edges(n: int, m: int, seed: int) -> List[tuple]:
    """Edges of networkx's `gnm_random_graph(n, m, seed)` for m < n(n-1)/2."""
    rng = random.Random(seed)
    g = _AdjDict(range(n))
    nodes = list(range(n))
    count = 0
    while count < m:
        u = rng.choice(nodes)
        v = rng.choice(nodes)
        if u == v or g.has_edge(u, v):
            continue
        g.add_edge(u, v)
        count += 1
    return g.edges()


def generate_graph(
    graph_type: GraphType, num_nodes: int, seed: Optional[int] = None, name: str = ""
) -> Graph:
    rng = _rng(seed)
    if graph_type == GraphType.BA:
        g = _barabasi_albert(num_nodes, 4, rng)
    elif graph_type == GraphType.ER:
        g = _erdos_renyi(num_nodes, 0.15, rng)
    elif graph_type == GraphType.PL:
        g = _powerlaw_cluster(num_nodes, 4, 0.05, rng)
    else:
        raise ValueError(f"unknown graph type {graph_type}")
    if not name:
        name = f"{graph_type.value}_{num_nodes}" + (f"_ID{seed}" if seed is not None else "")
    return Graph.from_edge_list(num_nodes, [(a, b, 1.0) for a, b in g.edges()], name=name)


def graph_from_name(name: str) -> Graph:
    """Resolve names like 'BA_100_ID7' to a seeded synthetic instance."""
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(f"not a synthetic graph name: {name!r}")
    seed = int(m.group(3)) if m.group(3) is not None else None
    return generate_graph(GraphType(m.group(1)), int(m.group(2)), seed=seed, name=name)


def build_g22_like() -> Graph:
    """Seeded stand-in for Gset G22 (2000 nodes, 19990 unit-weight edges):
    the G(n, m) graph that `bench.py` draws with
    `nx.gnm_random_graph(2000, 19990, seed=22)`."""
    edges = gnm_edges(2000, 19990, seed=22)
    return Graph.from_edge_list(2000, [(a, b, 1.0) for a, b in edges], name="G22like")


def build_weighted_gnm(n: int, m: int, seed: int, name: str) -> Graph:
    """The G(n, m) graph of `gnm_edges(n, m, seed)` with integer weights
    drawn uniformly from +-{1..7} by `numpy.random.default_rng(seed)` (the
    weight range the JAX package sized its bit-plane kernels for: 3 planes,
    signed), one magnitude and one sign per edge in edge order."""
    edges = gnm_edges(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 8, size=len(edges)) * rng.choice((-1, 1), size=len(edges))
    return Graph.from_edge_list(n, [(a, b, float(x)) for (a, b), x in zip(edges, w)], name=name)


def build_w22_like() -> Graph:
    """Integer-weighted stand-in at G22's size: the G22-like topology
    (2000 nodes, 19990 edges, seed 22) with weights in +-{1..7}."""
    return build_weighted_gnm(2000, 19990, 22, "W22like")


def build_d2000_like() -> Graph:
    """A dense integer-weighted check graph: G(2000, 199900), 10% of all
    pairs (about 200 neighbours a node), weights in +-{1..7}."""
    return build_weighted_gnm(2000, 199900, 2000, "D2000like")


def build_complete_f32(n: int = 2000, seed: int = 2000) -> Graph:
    """The complete graph on n nodes, every pair in `numpy.triu_indices`
    order, each weight uniform in [0.5, 1.5) from
    `numpy.random.default_rng(seed)`, rounded to f32."""
    i, j = np.triu_indices(n, k=1)
    w = np.random.default_rng(seed).uniform(0.5, 1.5, size=i.size).astype(np.float32)
    return Graph(n, np.stack([i, j], axis=1).astype(np.int32), w, f"K{n}")


def build_f22_like() -> Graph:
    """Non-integer-weighted stand-in at G22's size: the G22-like topology
    (2000 nodes, 19990 edges, seed 22) with each edge's weight uniform in
    [0.5, 1.5), drawn in edge order by `numpy.random.default_rng(22)` and
    rounded to f32. No packed kernel takes it: its 1-flip sweep is K10."""
    edges = gnm_edges(2000, 19990, seed=22)
    w = np.random.default_rng(22).uniform(0.5, 1.5, size=len(edges)).astype(np.float32)
    return Graph.from_edge_list(2000, [(a, b, float(x)) for (a, b), x in zip(edges, w)], name="F22like")


def build_w70_like() -> Graph:
    """Integer-weighted stand-in at G70's size: the G70-like topology of the
    JAX package's instance-wise runs (10000 nodes, 9999 edges, seed 70) with
    weights in +-{1..7}."""
    return build_weighted_gnm(10000, 9999, 70, "W70like")


def generate_knapsack(num_items: int, seed: Optional[int] = None, max_weight: int = 50, max_profit: int = 250):
    """A random knapsack (numpy's `default_rng(seed)`, as the JAX package):
    integer weights and profits, capacity floor(30% of the total weight)."""
    from rlsolver_tpu_torch.core.io import KnapsackInstance

    rng = np.random.default_rng(seed)
    weights = rng.integers(1, max_weight + 1, num_items).astype(np.float32)
    profits = rng.integers(1, max_profit + 1, num_items).astype(np.float32)
    capacity = float(np.floor(0.3 * weights.sum()))
    return KnapsackInstance(seed or 0, capacity, weights, profits)


def generate_tsp_coords(batch: int, num_nodes: int, low: float = 0.0, high: float = 1.0, mode: str = "uniform",
                        seed: Optional[int] = None) -> np.ndarray:
    """Random TSP coordinates [batch, n, 2] float64 from numpy's
    `default_rng(seed)`, as the JAX package draws them (RLSolver's
    `util_generate.py:33-43`): uniform in [low, high), or Gaussian rescaled
    onto [low, high]."""
    rng = np.random.default_rng(seed)
    if mode == "uniform":
        return rng.uniform(low, high, size=(batch, num_nodes, 2))
    if mode == "gaussian":
        c = rng.normal(0.0, 1.0, size=(batch, num_nodes, 2))
        return np.interp(c, (c.min(), c.max()), (low, high))
    raise ValueError(f"unknown mode {mode}")
