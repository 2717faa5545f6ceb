"""Exact MILP baselines through scipy's HiGHS (counterpart of
`rlsolver_tpu/solvers/milp.py`; host side, CPU). The formulations follow
RLSolver's Gurobi adapters (`methods/gurobi.py:272-652`):

  * maxcut: XOR linearization, y_ij >= x_i - x_j, y_ij >= x_j - x_i,
    y_ij <= x_i + x_j, y_ij <= 2 - x_i - x_j, maximize sum w_ij y_ij;
  * MIS: x_i + x_j <= 1 per edge, maximize sum x;
  * MVC: x_i + x_j >= 1 per edge, minimize sum x;
  * set cover: sum over the sets covering an item >= 1, minimize sum x;
  * knapsack: sum w x <= cap, maximize sum p x;
  * multi-knapsack: C x <= rhs, maximize p.x;
  * graph partitioning: the maxcut rows minimized with sum x = n/2.

Each solve has a time limit and returns the objective, HiGHS's best bound
and the solution. The bound proves optimality only where it meets the
objective; HiGHS's search differs between scipy versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.io import KnapsackInstance, SetCoverInstance


@dataclasses.dataclass
class MilpResult:
    obj: float
    bound: float
    solution: np.ndarray
    status: str


@dataclasses.dataclass
class MilpFormulation:
    """Backend-independent binary MILP: optimize c.x s.t. lo <= A x <= hi."""

    c: np.ndarray  # [nv]
    a: "sparse.csr_matrix"  # [nc, nv]
    lo: np.ndarray  # [nc]
    hi: np.ndarray  # [nc]
    maximize: bool
    n_report: Optional[int] = None  # report solution[:n_report]
    negate_obj: bool = False  # report -obj (reference partitioning output)

    @property
    def num_vars(self) -> int:
        return self.c.shape[0]


def _solve_formulation(f: MilpFormulation, time_limit: float) -> MilpResult:
    res = _solve(
        f.c,
        [LinearConstraint(f.a, f.lo, f.hi)],
        np.ones(f.num_vars),
        Bounds(0, 1),
        time_limit,
        f.maximize,
    )
    if f.n_report is not None and res.solution.size:
        res.solution = res.solution[: f.n_report]
    if f.negate_obj and res.solution.size:
        res.obj = -res.obj
    return res


def _solve(c, constraints, integrality, bounds, time_limit, maximize):
    """scipy.optimize.milp minimizes; flip sign for maximization."""
    sign = -1.0 if maximize else 1.0
    res = milp(
        c=sign * np.asarray(c, float),
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit, "presolve": True},
    )
    if res.x is None:
        return MilpResult(float("nan"), float("nan"), np.array([]), res.message)
    obj = sign * res.fun
    bound = sign * res.mip_dual_bound if res.mip_dual_bound is not None else obj
    return MilpResult(float(obj), float(bound), np.round(res.x).astype(int), res.message)


def build_maxcut(graph: Graph) -> MilpFormulation:
    n, m = graph.num_nodes, graph.num_edges
    n0, n1, w = graph.edge_arrays()
    nv = n + m  # x nodes, y edges
    c = np.concatenate([np.zeros(n), w.astype(float)])
    rows, cols, vals, lo, hi = [], [], [], [], []

    def add_row(r, entries, lo_v, hi_v):
        for col, val in entries:
            rows.append(r)
            cols.append(col)
            vals.append(val)
        lo.append(lo_v)
        hi.append(hi_v)

    r = 0
    for e in range(m):
        i, j, y = int(n0[e]), int(n1[e]), n + e
        add_row(r, [(y, 1), (i, -1), (j, 1)], 0, np.inf); r += 1  # y >= x_i - x_j
        add_row(r, [(y, 1), (i, 1), (j, -1)], 0, np.inf); r += 1  # y >= x_j - x_i
        add_row(r, [(y, 1), (i, -1), (j, -1)], -np.inf, 0); r += 1  # y <= x_i + x_j
        add_row(r, [(y, 1), (i, 1), (j, 1)], -np.inf, 2); r += 1  # y <= 2 - x_i - x_j
    a = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    return MilpFormulation(c, a, np.asarray(lo, float), np.asarray(hi, float),
                           maximize=True, n_report=n)


def solve_maxcut(graph: Graph, time_limit: float = 60.0) -> MilpResult:
    return _solve_formulation(build_maxcut(graph), time_limit)


def build_mis(graph: Graph) -> MilpFormulation:
    n = graph.num_nodes
    n0, n1, _ = graph.edge_arrays()
    m = graph.num_edges
    a = sparse.csr_matrix(
        (np.ones(2 * m), (np.repeat(np.arange(m), 2), np.stack([n0, n1], 1).ravel())),
        shape=(m, n),
    )
    return MilpFormulation(np.ones(n), a, np.full(m, -np.inf), np.ones(m), True)


def solve_mis(graph: Graph, time_limit: float = 60.0) -> MilpResult:
    return _solve_formulation(build_mis(graph), time_limit)


def build_mvc(graph: Graph) -> MilpFormulation:
    n = graph.num_nodes
    n0, n1, _ = graph.edge_arrays()
    m = graph.num_edges
    a = sparse.csr_matrix(
        (np.ones(2 * m), (np.repeat(np.arange(m), 2), np.stack([n0, n1], 1).ravel())),
        shape=(m, n),
    )
    return MilpFormulation(np.ones(n), a, np.ones(m), np.full(m, np.inf), False)


def solve_mvc(graph: Graph, time_limit: float = 60.0) -> MilpResult:
    return _solve_formulation(build_mvc(graph), time_limit)


def build_set_cover(inst: SetCoverInstance) -> MilpFormulation:
    member = inst.membership_matrix().astype(float)  # [S, I]
    ni = inst.num_items
    return MilpFormulation(
        np.ones(inst.num_sets), sparse.csr_matrix(member.T),
        np.ones(ni), np.full(ni, np.inf), False,
    )


def solve_set_cover(inst: SetCoverInstance, time_limit: float = 60.0) -> MilpResult:
    return _solve_formulation(build_set_cover(inst), time_limit)


def build_knapsack(inst: KnapsackInstance) -> MilpFormulation:
    return MilpFormulation(
        np.asarray(inst.profits, float),
        sparse.csr_matrix(inst.weights[None, :].astype(float)),
        np.asarray([-np.inf]), np.asarray([float(inst.capacity)]), True,
    )


def solve_knapsack(inst: KnapsackInstance, time_limit: float = 60.0) -> MilpResult:
    return _solve_formulation(build_knapsack(inst), time_limit)


def solve_multiknapsack(inst, time_limit: float = 60.0) -> MilpResult:
    """Multi-dimensional knapsack (`read_multiknapsack_data` instances,
    `util_read_data.py:245-311`): max p.x s.t. C x <= rhs, x binary."""
    return _solve_formulation(build_multiknapsack(inst), time_limit)


def build_multiknapsack(inst) -> MilpFormulation:
    nc = inst.rhs.shape[0]
    return MilpFormulation(
        np.asarray(inst.profits, float),
        sparse.csr_matrix(inst.constraints.astype(float)),
        np.full(nc, -np.inf), np.asarray(inst.rhs, float), True,
    )


def build_graph_partitioning(graph: Graph) -> MilpFormulation:
    """Minimize cut subject to |side 1| == n/2 (n must be even)."""
    n, m = graph.num_nodes, graph.num_edges
    if n % 2:
        raise ValueError("graph partitioning needs an even node count")
    n0, n1, w = graph.edge_arrays()
    nv = n + m
    c = np.concatenate([np.zeros(n), w.astype(float)])
    rows, cols, vals, lo, hi = [], [], [], [], []
    r = 0
    for e in range(m):
        i, j, y = int(n0[e]), int(n1[e]), n + e
        for entries, lo_v, hi_v in [
            ([(y, 1), (i, -1), (j, 1)], 0, np.inf),  # y >= x_i - x_j
            ([(y, 1), (i, 1), (j, -1)], 0, np.inf),  # y >= x_j - x_i
        ]:
            for col, val in entries:
                rows.append(r), cols.append(col), vals.append(val)
            lo.append(lo_v)
            hi.append(hi_v)
            r += 1
    # balance row
    for i in range(n):
        rows.append(r), cols.append(i), vals.append(1)
    lo.append(n / 2)
    hi.append(n / 2)
    r += 1
    a = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    return MilpFormulation(c, a, np.asarray(lo, float), np.asarray(hi, float),
                           maximize=False, n_report=n, negate_obj=True)


def solve_graph_partitioning(graph: Graph, time_limit: float = 60.0) -> MilpResult:
    """The reported objective is minus the cut of the reported partition.
    HiGHS's own objective is the sum of the edge variables y, which the
    formulation bounds only from below (y >= |x_i - x_j|): a solve stopped
    by its time limit may return an incumbent whose y overstate the cut of
    its x, and so an objective the solution does not score."""
    res = _solve_formulation(build_graph_partitioning(graph), time_limit)
    if res.solution.size:
        n0, n1, w = graph.edge_arrays()
        res.obj = -float(w[res.solution[n0] != res.solution[n1]].sum())
    return res
