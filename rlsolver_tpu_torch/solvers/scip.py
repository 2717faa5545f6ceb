"""SCIP adapter (optional, host-side; counterpart of the JAX package's
`solvers/scip.py`).

Reference counterpart: `rlsolver/methods/scip.py:75-137` — the same MILP
formulations as the Gurobi path, solved through pyscipopt, over the full
problem set (maxcut, MIS, MVC, graph partitioning, set cover, knapsack,
multiknapsack).

The formulations are NOT rebuilt here: `solve_formulation` consumes the
backend-independent `MilpFormulation` objects from
`rlsolver_tpu_torch.solvers.milp` — the exact matrices the out-of-the-box
HiGHS path solves and the test suite exercises — so the gated adapter
shares all formulation code with the tested path. pyscipopt is an
optional dependency; when absent these entry points raise an informative
ImportError and `solvers.milp` provides the same capability.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.io import KnapsackInstance, SetCoverInstance
from rlsolver_tpu_torch.solvers import milp as _milp

try:  # pragma: no cover - optional dependency
    import pyscipopt as scip

    HAS_SCIP = True
except ImportError:
    scip = None
    HAS_SCIP = False


@dataclasses.dataclass
class ScipResult:
    obj: float
    bound: float
    gap: float
    solution: np.ndarray
    status: str


def _require():
    if not HAS_SCIP:
        raise ImportError(
            "pyscipopt is not installed; use rlsolver_tpu_torch.solvers.milp (HiGHS) instead"
        )


def solve_formulation(
    f: "_milp.MilpFormulation", time_limit: float = 3600.0, name: str = "milp"
) -> ScipResult:
    """Solve a shared `MilpFormulation` with SCIP: binary vars, row
    constraints lo <= A x <= hi, time limit, bound/gap extraction
    (reference `scip.py:75-137` capability surface)."""
    _require()
    model = scip.Model(name)
    model.setParam("limits/time", time_limit)
    model.hideOutput()
    nv = f.num_vars
    xs = [model.addVar(vtype="B", name=f"x{i}") for i in range(nv)]
    a = f.a.tocsr()
    for r in range(a.shape[0]):
        row = a.getrow(r)
        expr = sum(
            float(v) * xs[int(c)] for c, v in zip(row.indices, row.data)
        )
        lo, hi = float(f.lo[r]), float(f.hi[r])
        if lo == hi:
            model.addCons(expr == lo)
        else:
            if np.isfinite(lo):
                model.addCons(expr >= lo)
            if np.isfinite(hi):
                model.addCons(expr <= hi)
    model.setObjective(
        sum(float(c) * x for c, x in zip(f.c, xs) if c != 0.0),
        "maximize" if f.maximize else "minimize",
    )
    model.optimize()
    sol = model.getBestSol()
    values = np.asarray([round(sol[x]) for x in xs], np.int64)
    if f.n_report is not None:
        values = values[: f.n_report]
    obj = float(model.getObjVal())
    if f.negate_obj:
        obj = -obj
    return ScipResult(
        obj,
        float(model.getDualbound()),
        float(model.getGap()),
        values,
        model.getStatus(),
    )


def solve_maxcut(graph: Graph, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(_milp.build_maxcut(graph), time_limit, "maxcut")


def solve_mis(graph: Graph, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(_milp.build_mis(graph), time_limit, "mis")


def solve_mvc(graph: Graph, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(_milp.build_mvc(graph), time_limit, "mvc")


def solve_graph_partitioning(graph: Graph, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(
        _milp.build_graph_partitioning(graph), time_limit, "graph_partitioning"
    )


def solve_set_cover(inst: SetCoverInstance, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(_milp.build_set_cover(inst), time_limit, "set_cover")


def solve_knapsack(inst: KnapsackInstance, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(_milp.build_knapsack(inst), time_limit, "knapsack")


def solve_multiknapsack(inst, time_limit: float = 3600.0) -> ScipResult:
    return solve_formulation(
        _milp.build_multiknapsack(inst), time_limit, "multiknapsack"
    )
