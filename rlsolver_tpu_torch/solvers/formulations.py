"""QUBO formulations for the exact solvers (counterpart of
`rlsolver_tpu/solvers/formulations.py`, numpy only; RLSolver's Gurobi
adapter switches between a MILP and a QUBO form per problem,
`methods/gurobi.py:272-652`). Each is a solver-agnostic matrix

    objective(x) = x^T Q x + const,   x in {0, 1}^n   (MAXIMIZE)

that tests hold against the host objectives (`problems/objectives.py`).

Penalty weights follow the standard Lucas (2014) QUBO encodings; for MIS /
MVC / partitioning a penalty strictly larger than the max objective change
per violated constraint makes the encodings exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph


def qubo_maxcut(graph: Graph) -> Tuple[np.ndarray, float]:
    """cut(x) = sum_e w_e (x_i + x_j - 2 x_i x_j)  (`gurobi.py:331-336`)."""
    n = graph.num_nodes
    n0, n1, w = graph.edge_arrays()
    q = np.zeros((n, n))
    for i, j, wij in zip(n0, n1, w):
        q[i, i] += wij
        q[j, j] += wij
        q[i, j] -= wij
        q[j, i] -= wij
    return q, 0.0


def qubo_mis(graph: Graph, penalty: float = 2.0) -> Tuple[np.ndarray, float]:
    """MIS: maximize sum x - P * sum_e x_i x_j (P > 1 exact)."""
    n = graph.num_nodes
    n0, n1, _ = graph.edge_arrays()
    q = np.zeros((n, n))
    np.fill_diagonal(q, 1.0)
    for i, j in zip(n0, n1):
        q[i, j] -= penalty / 2.0
        q[j, i] -= penalty / 2.0
    return q, 0.0


def qubo_mvc(graph: Graph, penalty: float = 2.0) -> Tuple[np.ndarray, float]:
    """MVC: maximize -(sum x) - P * sum_e (1-x_i)(1-x_j); P > 1 exact.
    (1-x_i)(1-x_j) = 1 - x_i - x_j + x_i x_j."""
    n = graph.num_nodes
    n0, n1, _ = graph.edge_arrays()
    q = np.zeros((n, n))
    np.fill_diagonal(q, -1.0)
    const = 0.0
    for i, j in zip(n0, n1):
        const -= penalty
        q[i, i] += penalty
        q[j, j] += penalty
        q[i, j] -= penalty / 2.0
        q[j, i] -= penalty / 2.0
    return q, const


def qubo_graph_partitioning(
    graph: Graph, penalty: float | None = None
) -> Tuple[np.ndarray, float]:
    """Balanced min-cut as penalty QUBO (`gurobi.py:348-354`): maximize
    -cut(x) - P (sum x - n/2)^2. Default P = max weighted degree + 1 (a
    1-node move changes the cut by at most max wdeg)."""
    n = graph.num_nodes
    if penalty is None:
        penalty = float(graph.weighted_degrees().max()) + 1.0
    q_cut, _ = qubo_maxcut(graph)
    q = -q_cut
    # -P (S - n/2)^2 = -P S^2 + P n S - P n^2/4 with S = sum x; for binary x,
    # S^2 = x^T J x (J = all-ones, diagonal uses x_i^2 = x_i) and the linear
    # term P n S lives on the diagonal.
    q -= penalty * np.ones((n, n))
    np.fill_diagonal(q, np.diag(q) + penalty * n)
    const = -penalty * (n ** 2) / 4.0
    return q, const


def qubo_number_partitioning(weights: np.ndarray) -> Tuple[np.ndarray, float]:
    """Minimize (sum_i w_i (2x_i - 1))^2: maximize the negative.
    diff = 2 w.x*2... expand (2S_x - W)^2 with S_x = sum w_i x_i, W = sum w:
    4 S_x^2 - 4 W S_x + W^2."""
    w = np.asarray(weights, float)
    n = len(w)
    big_w = w.sum()
    q = -4.0 * np.outer(w, w)
    np.fill_diagonal(q, np.diag(q) + 4.0 * big_w * w)
    const = -(big_w ** 2)
    return q, const


def qubo_value(x: np.ndarray, q: np.ndarray, const: float) -> float:
    """Evaluate x^T Q x + const for binary x."""
    x = np.asarray(x, float)
    return float(x @ q @ x + const)
