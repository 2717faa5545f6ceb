"""Host-side objectives (counterpart of `rlsolver_tpu/problems/objectives.py`;
RLSolver's `util_obj.py:31-178`): the golden twins that the CLI re-scores
every returned solution with. Every objective is maximized, and an
infeasible solution scores -inf:

  maxcut                   +sum of the cut edges' weights
  graph_partitioning       -cut; -inf unless exactly n/2 nodes have label 0
  minimum_vertex_cover     -(#selected); -inf unless every edge is covered
  maximum_independent_set  +#selected; -inf if an edge lies inside the set
  set_cover                -(#selected sets); -inf unless every item is covered
  graph_coloring           -(#distinct colors); -inf if an edge is monochromatic
  knapsack                 +sum of profits; -inf over the capacity
  number_partitioning      -|sum(S) - sum(~S)|
  tsp                      -(tour length)

All take 0/1 (or color, or tour) numpy label vectors."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.io import KnapsackInstance, SetCoverInstance

INF = float("inf")
Labels = Union[Sequence[int], np.ndarray]


def _bits(solution: Labels) -> np.ndarray:
    return np.asarray(solution).astype(np.int64)


def obj_maxcut(solution: Labels, graph: Graph) -> float:
    """Sum of the weights of the edges whose endpoints differ. 0/1 labels."""
    x = _bits(solution)
    n0, n1, w = graph.edge_arrays()
    return float(w[x[n0] != x[n1]].sum())


def obj_graph_partitioning(solution: Labels, graph: Graph) -> float:
    x = _bits(solution)
    if (x == 0).sum() * 2 != graph.num_nodes:
        return -INF
    return -obj_maxcut(solution, graph)


def obj_minimum_vertex_cover(solution: Labels, graph: Graph) -> float:
    x = _bits(solution)
    n0, n1, _ = graph.edge_arrays()
    if graph.num_edges and not np.all((x[n0] == 1) | (x[n1] == 1)):
        return -INF
    return -float((x == 1).sum())


def obj_maximum_independent_set(solution: Labels, graph: Graph) -> float:
    """The number of chosen nodes; -inf if an edge joins two of them."""
    x = _bits(solution)
    n0, n1, _ = graph.edge_arrays()
    if graph.num_edges and np.any((x[n0] == 1) & (x[n1] == 1)):
        return -INF
    return float((x == 1).sum())


def _covered(x: np.ndarray, instance: SetCoverInstance) -> np.ndarray:
    if not (x == 1).any():
        return np.zeros(instance.num_items, bool)
    return instance.membership_matrix()[x == 1].any(axis=0)


def obj_set_cover(solution: Labels, instance: SetCoverInstance) -> float:
    x = _bits(solution)
    if not _covered(x, instance).all():
        return -INF
    return -float((x == 1).sum())


def obj_set_cover_ratio(solution: Labels, instance: SetCoverInstance) -> float:
    """The share of the items covered."""
    return float(_covered(_bits(solution), instance).sum()) / float(instance.num_items)


def obj_graph_coloring(solution: Labels, graph: Graph) -> float:
    x = _bits(solution)
    n0, n1, _ = graph.edge_arrays()
    if graph.num_edges and np.any(x[n0] == x[n1]):
        return -INF
    return -float(len(np.unique(x)))


def obj_knapsack(solution: Labels, instance: KnapsackInstance) -> float:
    x = _bits(solution)
    if float((instance.weights * x).sum()) > instance.capacity:
        return -INF
    return float((instance.profits * x).sum())


def obj_number_partitioning(solution: Labels, numbers: Sequence[float]) -> float:
    x = _bits(solution)
    a = np.asarray(numbers, np.float64)
    return -abs(float((a * x).sum() - (a * (1 - x)).sum()))


def obj_tsp(tour: Labels, dist: np.ndarray) -> float:
    """Negative length of the closed tour `tour` (a permutation) over dist."""
    t = np.asarray(tour, np.int64)
    return -float(dist[t, np.roll(t, -1)].sum())
