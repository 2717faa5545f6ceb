"""Gset/syn graph files (counterpart of `rlsolver_tpu/core/io.py`).

Format: first non-comment line "N M", then M lines "n0 n1 w" with 1-indexed
nodes; lines containing "//" are comments. Also the knapsack and set-cover
instance containers that the batched objectives read (`ops/objectives.py`);
their file readers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph


def read_graph(filename: str) -> Graph:
    """Read a gset/syn txt graph (1-indexed nodes -> 0-indexed)."""
    num_nodes = None
    edges: List[Tuple[int, int, float]] = []
    with open(filename, "r") as f:
        for line in f:
            if "//" in line or not line.strip():
                continue
            parts = line.split()
            if num_nodes is None:
                num_nodes = int(parts[0])
                continue
            n0, n1 = int(parts[0]) - 1, int(parts[1]) - 1
            w = float(parts[2]) if len(parts) > 2 else 1.0
            edges.append((n0, n1, w))
    if num_nodes is None:
        raise ValueError(f"empty graph file: {filename}")
    name = os.path.splitext(os.path.basename(filename))[0]
    return Graph.from_edge_list(num_nodes, edges, name=name)


def list_graph_files(directory: str, prefixes: Sequence[str]) -> List[str]:
    """All .txt files in `directory` whose basename starts with any prefix."""
    out = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".txt") and any(fn.startswith(p) for p in prefixes):
            out.append(os.path.join(directory, fn))
    return out


@dataclasses.dataclass(frozen=True)
class KnapsackInstance:
    instance_id: int
    capacity: float
    weights: np.ndarray  # [n] float32
    profits: np.ndarray  # [n] float32

    @property
    def num_items(self) -> int:
        return int(self.weights.shape[0])


@dataclasses.dataclass(frozen=True)
class SetCoverInstance:
    num_items: int
    subsets: Tuple[Tuple[int, ...], ...]  # 1-indexed item ids as in the files

    @property
    def num_sets(self) -> int:
        return len(self.subsets)

    def membership_matrix(self) -> np.ndarray:
        """[num_sets, num_items] bool; item ids mapped to 0-indexed."""
        m = np.zeros((self.num_sets, self.num_items), bool)
        for si, items in enumerate(self.subsets):
            for it in items:
                m[si, it - 1] = True
        return m
