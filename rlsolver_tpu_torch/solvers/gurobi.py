"""Gurobi adapter (optional; import-gated on gurobipy; counterpart of the JAX
package's `solvers/gurobi.py`).

Mirrors the reference's Gurobi solver code (`rlsolver/methods/gurobi.py:272-652`):
per-problem MILP or QUBO formulation selected by `formulation`, a wall-clock
time limit, and objective/bound/gap extraction. The reference's published
"obj bound" columns come from exactly this setup with a 3600 s limit and the
QUBO formulation (`methods/config.py:78-83`).

If gurobipy is unavailable, use `rlsolver_tpu_torch.solvers.milp` (HiGHS via
scipy), which needs no license.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph

try:
    import gurobipy as gp
    from gurobipy import GRB

    HAS_GUROBI = True
except ImportError:  # pragma: no cover - exercised only without gurobi
    gp = None
    GRB = None
    HAS_GUROBI = False


@dataclasses.dataclass
class GurobiResult:
    obj: float
    bound: float
    gap: float
    solution: np.ndarray
    status: int


def _require():
    if not HAS_GUROBI:
        raise ImportError(
            "gurobipy is not installed; use rlsolver_tpu_torch.solvers.milp (HiGHS) instead"
        )


def solve_qubo(
    q: np.ndarray, const: float = 0.0, time_limit: float = 3600.0
) -> GurobiResult:
    """Generic QUBO: maximize x^T Q x + const over binary x. The Q matrices
    come from `solvers/formulations.py` (shared with the license-free tests
    and the HiGHS adapter), mirroring the reference's QUBO formulation
    switch (`gurobi.py:331-336`, `config.py:82`)."""
    _require()
    n = q.shape[0]
    model = gp.Model("qubo")
    model.Params.TimeLimit = time_limit
    model.Params.OutputFlag = 0
    x = model.addVars(n, vtype=GRB.BINARY, name="x")
    obj = gp.quicksum(
        float(q[i, j]) * x[i] * x[j]
        for i in range(n)
        for j in range(n)
        if q[i, j] != 0.0
    )
    model.setObjective(obj + float(const), GRB.MAXIMIZE)
    model.optimize()
    sol = (
        np.array([int(round(x[i].X)) for i in range(n)])
        if model.SolCount
        else np.array([])
    )
    return GurobiResult(
        obj=model.ObjVal if model.SolCount else float("nan"),
        bound=model.ObjBound,
        gap=model.MIPGap if model.SolCount else float("inf"),
        solution=sol,
        status=model.Status,
    )


def solve_problem_qubo(
    problem: str, graph: Graph, time_limit: float = 3600.0
) -> GurobiResult:
    """Per-problem QUBO dispatch over the shared formulation builders
    (reference breadth: `gurobi.py:301-413`)."""
    from rlsolver_tpu_torch.solvers import formulations as F

    builders = {
        "maxcut": F.qubo_maxcut,
        "mis": F.qubo_mis,
        "mvc": F.qubo_mvc,
        "graph_partitioning": F.qubo_graph_partitioning,
    }
    if problem not in builders:
        raise ValueError(f"no QUBO formulation for {problem!r}")
    q, const = builders[problem](graph)
    return solve_qubo(q, const, time_limit)


def solve_maxcut(
    graph: Graph, time_limit: float = 3600.0, formulation: str = "qubo"
) -> GurobiResult:
    """formulation: 'qubo' (default, reference `gurobi.py:331-336`) or
    'milp' (XOR linearization, `gurobi.py:449-456`)."""
    _require()
    n = graph.num_nodes
    n0, n1, w = graph.edge_arrays()
    model = gp.Model("maxcut")
    model.Params.TimeLimit = time_limit
    model.Params.OutputFlag = 0
    x = model.addVars(n, vtype=GRB.BINARY, name="x")
    if formulation == "qubo":
        obj = gp.quicksum(
            float(w[e]) * (x[int(n0[e])] + x[int(n1[e])] - 2 * x[int(n0[e])] * x[int(n1[e])])
            for e in range(graph.num_edges)
        )
        model.setObjective(obj, GRB.MAXIMIZE)
    else:
        y = model.addVars(graph.num_edges, vtype=GRB.BINARY, name="y")
        for e in range(graph.num_edges):
            i, j = int(n0[e]), int(n1[e])
            model.addConstr(y[e] <= x[i] + x[j])
            model.addConstr(y[e] <= 2 - x[i] - x[j])
        model.setObjective(
            gp.quicksum(float(w[e]) * y[e] for e in range(graph.num_edges)), GRB.MAXIMIZE
        )
    model.optimize()
    sol = np.array([int(round(x[i].X)) for i in range(n)]) if model.SolCount else np.array([])
    return GurobiResult(
        obj=model.ObjVal if model.SolCount else float("nan"),
        bound=model.ObjBound,
        gap=model.MIPGap if model.SolCount else float("inf"),
        solution=sol,
        status=model.Status,
    )
