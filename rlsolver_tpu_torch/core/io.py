"""Gset/syn graph files (counterpart of `rlsolver_tpu/core/io.py`).

Format: first non-comment line "N M", then M lines "n0 n1 w" with 1-indexed
nodes; lines containing "//" are comments. Also the knapsack, set-cover and
multi-knapsack instances and their readers (RLSolver's
`util_read_data.py:245-344` formats), and TSP coordinate files
('<index> <x> <y>' lines) with their distance matrix.
"""

from __future__ import annotations

import dataclasses
import os
import re
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


def write_graph(graph: Graph, filename: str) -> None:
    """Write in the gset txt format (1-indexed, integer weights as integers)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write(f"{graph.num_nodes} {graph.num_edges}\n")
        for (a, b), w in zip(graph.edges, graph.weights):
            wtxt = str(int(w)) if float(w).is_integer() else repr(float(w))
            f.write(f"{int(a) + 1} {int(b) + 1} {wtxt}\n")


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


def read_knapsack(filename: str) -> KnapsackInstance:
    """`id n capacity` then n pairs `weight profit`."""
    with open(filename, "r") as f:
        parts = f.read().split()
    instance_id, num_items, capacity = int(parts[0]), int(parts[1]), float(parts[2])
    vals = np.asarray([float(p) for p in parts[3:]], np.float32)
    weights, profits = vals[0::2], vals[1::2]
    if weights.shape[0] != num_items or profits.shape[0] != num_items:
        raise ValueError(f"knapsack item count mismatch in {filename}")
    return KnapsackInstance(instance_id, capacity, weights, profits)


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


def read_set_cover(filename: str) -> SetCoverInstance:
    """`num_items num_sets`, then one line of 1-indexed item ids per set."""
    with open(filename, "r") as f:
        first = f.readline().split()
        num_items, num_sets = int(first[0]), int(first[1])
        subsets = []
        for line in f:
            if line.strip():
                subsets.append(tuple(int(x) for x in line.split()))
    if len(subsets) != num_sets:
        raise ValueError(f"set-cover subset count mismatch in {filename}")
    return SetCoverInstance(num_items, tuple(subsets))


@dataclasses.dataclass(frozen=True)
class MultiKnapsackInstance:
    optimal_obj: float
    profits: np.ndarray  # [n]
    constraints: np.ndarray  # [m, n]
    rhs: np.ndarray  # [m]


def read_multiknapsack(filename: str) -> MultiKnapsackInstance:
    """The two layouts of RLSolver's instances (`util_read_data.py:245-311`
    and the mknap2 family):

      3-token header: `n m optimal / profits[n] / m rows[n] / rhs[m]`
      2-token header: `m n / profits[n] / rhs[m] / m rows[n] / optimal`
    """
    with open(filename, "r") as f:
        first = f.readline().split()
        tokens = f.read().split()
    it = iter(tokens)

    def take(count: int) -> list:
        return [float(next(it)) for _ in range(count)]

    if len(first) >= 3:
        n_vars, m_cons, optimal = int(first[0]), int(first[1]), float(first[2])
        profits = take(n_vars)
        cons = [take(n_vars) for _ in range(m_cons)]
        rhs = take(m_cons)
    else:
        m_cons, n_vars = int(first[0]), int(first[1])
        profits = take(n_vars)
        rhs = take(m_cons)
        cons = [take(n_vars) for _ in range(m_cons)]
        optimal = float(next(it))
    return MultiKnapsackInstance(optimal, np.asarray(profits, np.float32), np.asarray(cons, np.float32),
                                 np.asarray(rhs, np.float32))


def read_tsp_coords(filename: str) -> np.ndarray:
    """Parse '<index> <x> <y>' coordinate lines; returns [n, 2] float64 (a
    fresh block restarts at index 1, and a line with EOF ends the file)."""
    coords: List[Tuple[float, float]] = []
    prev = 0
    with open(filename, "r") as f:
        for line in f:
            if "EOF" in line:
                break
            parts = line.split()
            if len(parts) == 3 and re.fullmatch(r"\d+", parts[0]):
                idx = int(parts[0])
                if idx == 1 and prev not in (0, 1):
                    coords = []  # restart on a fresh 1-indexed block
                coords.append((float(parts[1]), float(parts[2])))
                prev = idx
    return np.asarray(coords, np.float64)


def tsp_distance_matrix(coords: np.ndarray) -> np.ndarray:
    """Euclidean distances [n, n] float64 between the rows of coords."""
    d = coords[:, None, :] - coords[None, :, :]
    return np.sqrt((d * d).sum(-1))
