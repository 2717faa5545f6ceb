"""Host-side graph container (counterpart of `rlsolver_tpu/core/graph.py`).

Graphs are lists of (n0, n1, w) edges, 0-indexed, stored once with n0 < n1.
Everything here is numpy; tensors are made where the graph is used.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

EdgeList = Sequence[Tuple[int, int, float]]


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted graph. Edges are stored once (n0 < n1)."""

    num_nodes: int
    edges: np.ndarray  # [m, 2] int32, 0-indexed, edges[i, 0] < edges[i, 1]
    weights: np.ndarray  # [m] float32
    name: str = ""

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())

    @property
    def density(self) -> float:
        n = self.num_nodes
        return 0.0 if n < 2 else 2.0 * self.num_edges / (n * (n - 1))

    @staticmethod
    def from_edge_list(num_nodes: int, edge_list: EdgeList, name: str = "") -> "Graph":
        """Build from (n0, n1, w) triples; a repeated edge keeps its last weight."""
        if len(edge_list) == 0:
            return Graph(num_nodes, np.zeros((0, 2), np.int32), np.zeros((0,), np.float32), name)
        arr = np.asarray([(min(a, b), max(a, b), w) for a, b, w in edge_list], dtype=np.float64)
        ends = arr[:, :2].astype(np.int64)
        key = ends[:, 0] * num_nodes + ends[:, 1]
        last = {}
        for i, k in enumerate(key.tolist()):
            last[k] = i
        keep = np.asarray(sorted(last.values(), key=lambda i: (ends[i, 0], ends[i, 1])), dtype=np.int64)
        edges = ends[keep].astype(np.int32)
        weights = arr[keep, 2].astype(np.float32)
        if (edges[:, 0] == edges[:, 1]).any():
            raise ValueError("self-loops are not supported")
        if edges.min() < 0 or edges.max() >= num_nodes:
            raise ValueError("edge endpoint out of range")
        return Graph(num_nodes, edges, weights, name)

    def to_edge_list(self) -> List[Tuple[int, int, float]]:
        return [(int(a), int(b), float(w)) for (a, b), w in zip(self.edges, self.weights)]

    def adjacency_dense(self, dtype=np.float32) -> np.ndarray:
        """Symmetric dense adjacency [n, n]; A[i, j] = w(i, j), 0 if no edge."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)
        i, j = self.edges[:, 0], self.edges[:, 1]
        a[i, j] = self.weights
        a[j, i] = self.weights
        return a.astype(dtype)

    def degrees(self) -> np.ndarray:
        """Unweighted degree per node, int32."""
        deg = np.zeros(self.num_nodes, np.int32)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def weighted_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, np.float32)
        np.add.at(deg, self.edges[:, 0], self.weights)
        np.add.at(deg, self.edges[:, 1], self.weights)
        return deg

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(n0, n1, w) flat arrays, each edge once."""
        return (
            self.edges[:, 0].astype(np.int32),
            self.edges[:, 1].astype(np.int32),
            self.weights.astype(np.float32),
        )

    def padded_neighbors(self, pad_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nbrs [n, max_deg], nbr_w [n, max_deg], deg [n]). Padding slots
        point at node `num_nodes` (a sentinel column the consumer appends)
        with weight 0."""
        deg = self.degrees()
        max_deg = int(deg.max(initial=0))
        max_deg = max(1, -(-max_deg // pad_multiple) * pad_multiple)
        nbrs = np.full((self.num_nodes, max_deg), self.num_nodes, np.int32)
        nbr_w = np.zeros((self.num_nodes, max_deg), np.float32)
        fill = np.zeros(self.num_nodes, np.int32)
        for (a, b), w in zip(self.edges, self.weights):
            nbrs[a, fill[a]] = b
            nbr_w[a, fill[a]] = w
            fill[a] += 1
            nbrs[b, fill[b]] = a
            nbr_w[b, fill[b]] = w
            fill[b] += 1
        return nbrs, nbr_w, deg

    def degree_sorted_nodes(self, descending: bool = True) -> np.ndarray:
        """Node order of the degree-ordered sweeps. The sort is stable: the
        sweep order, and so every sweep result, depends on the tie order."""
        deg = self.weighted_degrees()
        order = np.argsort(-deg if descending else deg, kind="stable")
        return order.astype(np.int32)

    def greedy_coloring(self) -> Tuple[np.ndarray, int]:
        """Greedy node coloring, largest weighted degree first: each node
        takes the least color none of its colored neighbours has. Nodes of
        one color share no edge, so a sweep may update a class at once; the
        classes fix the colored sweep's update order. Returns (color [n]
        int32, num_colors)."""
        order = self.degree_sorted_nodes(descending=True)
        nbrs, _, deg = self.padded_neighbors()
        color = np.full(self.num_nodes, -1, np.int32)
        for v in order:
            used = {int(c) for c in color[nbrs[v, : deg[v]]] if c >= 0}
            c = 0
            while c in used:
                c += 1
            color[v] = c
        return color, int(color.max(initial=-1)) + 1
