"""Host-side objectives (counterpart of `rlsolver_tpu/problems/objectives.py`:
`obj_maxcut` and `obj_maximum_independent_set`): the golden twins that the
CLI re-scores every returned solution with. Infeasible solutions score -inf."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph

INF = float("inf")
Labels = Union[Sequence[int], np.ndarray]


def obj_maxcut(solution: Labels, graph: Graph) -> float:
    """Sum of the weights of the edges whose endpoints differ. 0/1 labels."""
    x = np.asarray(solution).astype(np.int64)
    n0, n1, w = graph.edge_arrays()
    return float(w[x[n0] != x[n1]].sum())


def obj_maximum_independent_set(solution: Labels, graph: Graph) -> float:
    """The number of chosen nodes; -inf if an edge joins two of them."""
    x = np.asarray(solution).astype(np.int64)
    n0, n1, _ = graph.edge_arrays()
    if graph.num_edges and np.any((x[n0] == 1) & (x[n1] == 1)):
        return -INF
    return float((x == 1).sum())
