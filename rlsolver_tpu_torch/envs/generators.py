"""Graph generators for the ECO-DQN train/validate/select protocol
(counterpart of `rlsolver_tpu/envs/generators.py`; the same graphs for the
same seeds).

Generators return `Graph` objects and are explicitly seeded, so runs are
reproducible and resumable; edge-weight perturbation is symmetric Gaussian
noise masked to existing edges.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.core.graph import Graph


class RandomGraphGenerator:
    """Fresh random instance per call (`RandomER/BAGraphGenerator`,
    `util_envs.py:132-210`)."""

    def __init__(self, graph_type: GraphType, num_nodes: int, seed: int = 0):
        self.graph_type = graph_type
        self.num_nodes = num_nodes
        self._rng = np.random.default_rng(seed)

    def get(self) -> Graph:
        return generate_graph(
            self.graph_type, self.num_nodes, seed=int(self._rng.integers(2**31))
        )

    def __call__(self, i: int = 0) -> Graph:
        return self.get()


class SingleGraphGenerator:
    """Always the same instance (`util_envs.py:211-239`)."""

    def __init__(self, graph: Graph):
        self.graph = graph

    def get(self) -> Graph:
        return self.graph

    def __call__(self, i: int = 0) -> Graph:
        return self.graph


class ValidationGraphGenerator:
    """Fixed seeded validation set (`util_envs.py:240-261`; the reference
    seeds every instance identically with VALIDATION_SEED — here each of the
    `num_graphs` instances gets a distinct deterministic seed derived from
    it, which is the evidently intended behavior)."""

    def __init__(
        self,
        graph_type: GraphType,
        num_nodes: int,
        num_graphs: int = 8,
        seed: int = 10,  # VALIDATION_SEED, ECO_S2V/config.py:37
    ):
        self.graphs: List[Graph] = [
            generate_graph(graph_type, num_nodes, seed=seed + 1000 * i)
            for i in range(num_graphs)
        ]

    def get(self) -> List[Graph]:
        return list(self.graphs)

    def __call__(self, i: int) -> Graph:
        return self.graphs[i % len(self.graphs)]


class SetGraphGenerator:
    """Cycle (ordered) or sample (unordered) a fixed instance list
    (`util_envs.py:262-300`)."""

    def __init__(self, graphs: Sequence[Graph], ordered: bool = False, seed: int = 0):
        if len({g.num_nodes for g in graphs}) != 1:
            raise ValueError("all graphs in SetGraphGenerator must share num_nodes")
        self.graphs = list(graphs)
        self.ordered = ordered
        self._i = 0
        self._rng = np.random.default_rng(seed)

    def get(self) -> Graph:
        if self.ordered:
            g = self.graphs[self._i]
            self._i = (self._i + 1) % len(self.graphs)
            return g
        return self.graphs[int(self._rng.integers(len(self.graphs)))]

    def __call__(self, i: int = 0) -> Graph:
        return self.get()


class PerturbedGraphGenerator:
    """Base instance(s) + symmetric Gaussian edge-weight noise masked to
    existing edges (`util_envs.py:301-353`)."""

    def __init__(
        self,
        graphs: Sequence[Graph],
        perturb_mean: float = 0.0,
        perturb_std: float = 0.01,
        ordered: bool = False,
        seed: int = 0,
    ):
        if len({g.num_nodes for g in graphs}) != 1:
            raise ValueError("all graphs must share num_nodes")
        self.graphs = list(graphs)
        self.perturb_mean = perturb_mean
        self.perturb_std = perturb_std
        self.ordered = ordered
        self._i = 0
        self._rng = np.random.default_rng(seed)

    def get(self) -> Graph:
        if self.ordered:
            base = self.graphs[self._i]
            self._i = (self._i + 1) % len(self.graphs)
        else:
            base = self.graphs[int(self._rng.integers(len(self.graphs)))]
        m = base.adjacency_dense().astype(float)
        noise = self._rng.normal(self.perturb_mean, self.perturb_std, size=m.shape)
        noise[m == 0] = 0.0  # only perturb existing edges
        noise = np.tril(noise) + np.triu(noise.T, 1)  # symmetric
        m = m + noise
        n = m.shape[0]
        iu = np.triu_indices(n, k=1)
        edges = [
            (int(i), int(j), float(m[i, j]))
            for i, j in zip(*iu)
            if m[i, j] != 0.0
        ]
        return Graph.from_edge_list(n, edges, name=f"{base.name}_perturbed")

    def __call__(self, i: int = 0) -> Graph:
        return self.get()
