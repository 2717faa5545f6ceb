"""Batched device objectives for bit-vector problems (counterpart of
`rlsolver_tpu/ops/objectives.py`).

Each function scores a [B, N] batch of 0/1 solutions and is the batched
twin of a host objective. Feasibility comes in two forms:

  * exact:     infeasible -> -inf;
  * penalized: infeasible -> objective - penalty * violation count, the form
    the annealers and samplers need for a usable search gradient.

The arithmetic follows the JAX package: int8 endpoint gathers, f32 sums, so
integer data give the same values exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device

NEG_INF = float("-inf")


class EdgeArrays(NamedTuple):
    n0: torch.Tensor  # [m] int64
    n1: torch.Tensor  # [m] int64
    w: torch.Tensor  # [m] f32

    @staticmethod
    def build(graph: Graph, device=None) -> "EdgeArrays":
        dev = resolve_device(device)
        n0, n1, w = graph.edge_arrays()
        return EdgeArrays(torch.from_numpy(n0).long().to(dev), torch.from_numpy(n1).long().to(dev),
                          torch.from_numpy(w).to(dev))


def _endpoints(xs: torch.Tensor, e: EdgeArrays):
    xb = xs.to(torch.int8)
    return xb[..., e.n0], xb[..., e.n1]


def _exact_or_penalized(value, violation, penalty: Optional[float]):
    if penalty is None:
        return torch.where(violation == 0, value, torch.full_like(value, NEG_INF))
    return value - penalty * violation


def obj_maxcut(xs: torch.Tensor, e: EdgeArrays) -> torch.Tensor:
    a, b = _endpoints(xs, e)
    return ((a ^ b).to(torch.float32) * e.w).sum(dim=-1)


def obj_graph_partitioning(xs: torch.Tensor, e: EdgeArrays, num_nodes: int,
                           penalty: Optional[float] = None) -> torch.Tensor:
    """-cut over balanced halves; the violation is |#zeros - n/2|."""
    cut = obj_maxcut(xs, e)
    zeros = (num_nodes - xs.to(torch.int32).sum(dim=-1)).to(torch.float32)
    return _exact_or_penalized(-cut, torch.abs(zeros - num_nodes / 2.0), penalty)


def obj_minimum_vertex_cover(xs: torch.Tensor, e: EdgeArrays, penalty: Optional[float] = None) -> torch.Tensor:
    a, b = _endpoints(xs, e)
    uncovered = ((1 - a) & (1 - b)).to(torch.float32).sum(dim=-1)
    return _exact_or_penalized(-xs.to(torch.float32).sum(dim=-1), uncovered, penalty)


def obj_maximum_independent_set(xs: torch.Tensor, e: EdgeArrays, penalty: Optional[float] = None) -> torch.Tensor:
    a, b = _endpoints(xs, e)
    violations = (a & b).to(torch.float32).sum(dim=-1)
    return _exact_or_penalized(xs.to(torch.float32).sum(dim=-1), violations, penalty)


def obj_set_cover(xs: torch.Tensor, membership: torch.Tensor, penalty: Optional[float] = None) -> torch.Tensor:
    """xs: [B, num_sets]; membership: [num_sets, num_items] bool or 0/1."""
    cover_counts = xs.to(torch.float32) @ membership.to(torch.float32)  # [B, num_items]
    uncovered = (cover_counts == 0).to(torch.float32).sum(dim=-1)
    return _exact_or_penalized(-xs.to(torch.float32).sum(dim=-1), uncovered, penalty)


def obj_knapsack(xs: torch.Tensor, weights: torch.Tensor, profits: torch.Tensor, capacity: float,
                 penalty: Optional[float] = None) -> torch.Tensor:
    x = xs.to(torch.float32)
    over = torch.clamp(x @ weights - capacity, min=0.0)
    return _exact_or_penalized(x @ profits, over, penalty)


def obj_number_partitioning(xs: torch.Tensor, numbers: torch.Tensor) -> torch.Tensor:
    a = numbers.to(torch.float32)
    x = xs.to(torch.float32)
    return -torch.abs(x @ a - (1 - x) @ a)


def obj_graph_coloring(labels: torch.Tensor, e: EdgeArrays, num_colors: int,
                       penalty: Optional[float] = None) -> torch.Tensor:
    """labels: int [B, N], a color per node; objective = -#used colors."""
    conflicts = (labels[..., e.n0] == labels[..., e.n1]).to(torch.float32).sum(dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), num_colors).to(torch.float32)  # [B, N, C]
    used = (onehot.sum(dim=-2) > 0).to(torch.float32).sum(dim=-1)
    return _exact_or_penalized(-used, conflicts, penalty)


def obj_tsp(tours: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """tours: int [B, N] permutations; dist: [N, N]. Returns -tour length."""
    nxt = torch.roll(tours, -1, dims=1)
    return -dist[tours.long(), nxt.long()].sum(dim=1)
