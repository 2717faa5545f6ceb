"""VRPTW column generation: Solomon instances, ESPPRC labeling, CG master
(counterpart of the JAX package's `solvers/vrptw.py`; numpy and scipy on
the host).

Reference counterpart: `rlsolver/methods_problem_specific/VRPTW/` —
`column_generation.py` (361 LoC, set-covering master over routes solved
with Gurobi, initial one-customer-per-vehicle routes, reduced cost =
sum(dist) - sum(duals) along the path), `ESPPRC1/2.py` (unidirectional
elementary shortest path with resource constraints via label extension),
`Customer/Vehicle` containers, Solomon instance data.

Here the master LP is scipy linprog (no Gurobi); the pricing is a labeling
algorithm with (cost, time, load, visited-set) dominance — host-side python
by nature (sequential label pools). Final integer solution via scipy.milp
over the generated route pool.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, linprog, milp


@dataclasses.dataclass(frozen=True)
class VrptwInstance:
    """Node 0 is the depot. Arrays are over nodes [n+1]."""

    coords: np.ndarray  # [n+1, 2]
    demand: np.ndarray  # [n+1]; demand[0] = 0
    tw_start: np.ndarray  # [n+1] earliest service start
    tw_end: np.ndarray  # [n+1] latest service start
    service: np.ndarray  # [n+1] service duration
    capacity: float

    @property
    def num_customers(self) -> int:
        return int(self.coords.shape[0]) - 1

    def dist(self) -> np.ndarray:
        d = self.coords[:, None, :] - self.coords[None, :, :]
        return np.sqrt((d**2).sum(-1))

    @staticmethod
    def random(n: int = 12, seed: int = 0, horizon: float = 200.0):
        rng = np.random.RandomState(seed)
        coords = rng.uniform(0, 50, (n + 1, 2))
        demand = np.concatenate([[0.0], rng.uniform(1, 10, n)])
        centers = rng.uniform(20, horizon - 40, n)
        width = rng.uniform(20, 60, n)
        tw_start = np.concatenate([[0.0], np.maximum(0, centers - width / 2)])
        tw_end = np.concatenate([[horizon], centers + width / 2])
        service = np.concatenate([[0.0], np.full(n, 5.0)])
        return VrptwInstance(coords, demand, tw_start, tw_end, service, capacity=30.0)

    @staticmethod
    def from_solomon(path: str, num_customers: Optional[int] = None):
        """Parse a Solomon-format txt (VEHICLE/CUSTOMER sections)."""
        with open(path) as f:
            lines = f.readlines()
        capacity = None
        rows = []
        mode = None
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VEHICLE":
                mode = "vehicle"
                continue
            if parts[0] == "CUSTOMER":
                mode = "customer"
                continue
            if mode == "vehicle" and len(parts) == 2 and parts[0].isdigit():
                capacity = float(parts[1])
            if mode == "customer" and len(parts) == 7 and parts[0].isdigit():
                rows.append([float(x) for x in parts])
        arr = np.asarray(rows)
        if num_customers is not None:
            arr = arr[: num_customers + 1]
        return VrptwInstance(
            coords=arr[:, 1:3],
            demand=arr[:, 3],
            tw_start=arr[:, 4],
            tw_end=arr[:, 5],
            service=arr[:, 6],
            capacity=capacity or 200.0,
        )


@dataclasses.dataclass
class Label:
    """ESPPRC label at a node: accumulated (rcost, time, load, visited)."""

    node: int
    rcost: float
    time: float
    load: float
    visited: frozenset
    path: Tuple[int, ...]


def route_cost(inst: VrptwInstance, route: Sequence[int]) -> float:
    d = inst.dist()
    full = [0, *route, 0]
    return float(sum(d[full[i], full[i + 1]] for i in range(len(full) - 1)))


def route_feasible(inst: VrptwInstance, route: Sequence[int]) -> bool:
    d = inst.dist()
    t, load, prev = 0.0, 0.0, 0
    for c in route:
        t = max(t + d[prev, c], inst.tw_start[c])
        if t > inst.tw_end[c] + 1e-9:
            return False
        load += inst.demand[c]
        if load > inst.capacity + 1e-9:
            return False
        t += inst.service[c]
        prev = c
    return True


def esspprc_pricing(
    inst: VrptwInstance,
    duals: np.ndarray,
    max_labels_per_node: int = 200,
) -> List[Tuple[List[int], float]]:
    """Unidirectional ESPPRC labeling (`ESPPRC1_unidirectional` capability).

    Arc reduced cost = dist(i, j) - dual_i (dual of the visited customer i,
    depot dual 0). Returns negative-reduced-cost routes (customer lists)
    sorted most-negative first. Dominance: same node, <= on (rcost, time,
    load) and visited-subset.
    """
    n = inst.num_customers
    d = inst.dist()
    labels: Dict[int, List[Label]] = {i: [] for i in range(n + 2)}
    start = Label(0, 0.0, 0.0, 0.0, frozenset(), ())
    pool = [start]
    done: List[Label] = []

    def dominated(a: Label, b: Label) -> bool:
        return (
            b.rcost <= a.rcost + 1e-12
            and b.time <= a.time + 1e-12
            and b.load <= a.load + 1e-12
            and b.visited <= a.visited
            and (b.rcost < a.rcost or b.time < a.time or b.load < a.load or b.visited < a.visited)
        )

    while pool:
        lab = pool.pop()
        for j in range(1, n + 1):
            if j in lab.visited or j == lab.node:
                continue
            t = max(lab.time + d[lab.node, j], inst.tw_start[j])
            if t > inst.tw_end[j] + 1e-9:
                continue
            load = lab.load + inst.demand[j]
            if load > inst.capacity + 1e-9:
                continue
            rcost = lab.rcost + d[lab.node, j] - duals[j]
            new = Label(
                j, rcost, t + inst.service[j], load,
                lab.visited | {j}, lab.path + (j,),
            )
            bucket = labels[j]
            if any(dominated(new, o) for o in bucket):
                continue
            bucket[:] = [o for o in bucket if not dominated(o, new)]
            if len(bucket) >= max_labels_per_node:
                continue
            bucket.append(new)
            pool.append(new)
            # close the route back to the depot
            done.append(
                Label(0, rcost + d[j, 0], 0.0, load, new.visited, new.path)
            )

    routes = [(list(l.path), l.rcost) for l in done if l.rcost < -1e-9]
    routes.sort(key=lambda t: t[1])
    # deduplicate
    seen, out = set(), []
    for r, rc in routes:
        key = tuple(r)
        if key not in seen:
            seen.add(key)
            out.append((r, rc))
    return out


@dataclasses.dataclass
class VrptwCGResult:
    routes: List[List[int]]
    lp_value: float
    int_value: float
    selected: List[List[int]]
    num_iterations: int
    history: List[float]


def solve_vrptw(
    inst: VrptwInstance, max_iters: int = 50, columns_per_iter: int = 5
) -> VrptwCGResult:
    """Column generation on the set-covering master
    (`column_generation.py` flow: init single-customer routes, iterate
    master-LP duals -> ESPPRC -> add columns, finish with an ILP)."""
    n = inst.num_customers
    routes: List[List[int]] = [[c] for c in range(1, n + 1)]
    costs = [route_cost(inst, r) for r in routes]
    history = []
    it = 0
    for it in range(max_iters):
        a = np.zeros((n, len(routes)))
        for j, r in enumerate(routes):
            for c in r:
                a[c - 1, j] = 1.0
        res = linprog(
            c=np.asarray(costs),
            A_ub=-a,
            b_ub=-np.ones(n),
            bounds=(0, None),
            method="highs",
        )
        history.append(float(res.fun))
        duals = np.concatenate([[0.0], -np.asarray(res.ineqlin.marginals)])
        new = esspprc_pricing(inst, duals)[:columns_per_iter]
        fresh = [r for r, rc in new if r not in routes]
        if not fresh:
            break
        for r in fresh:
            routes.append(r)
            costs.append(route_cost(inst, r))

    a = np.zeros((n, len(routes)))
    for j, r in enumerate(routes):
        for c in r:
            a[c - 1, j] = 1.0
    res_int = milp(
        c=np.asarray(costs),
        constraints=LinearConstraint(a, lb=np.ones(n), ub=np.inf),
        integrality=np.ones(len(routes)),
        bounds=Bounds(0, 1),
    )
    x = np.rint(res_int.x).astype(bool)
    return VrptwCGResult(
        routes=routes,
        lp_value=history[-1],
        int_value=float(res_int.fun),
        selected=[r for r, keep in zip(routes, x) if keep],
        num_iterations=it + 1,
        history=history,
    )
