"""Column generation for cutting stock + RL-pricing hook (counterpart of the
JAX package's `solvers/column_generation.py`; numpy and scipy on the host).

Reference counterpart: `rlsolver/methods_RLOR/RL_column_generation/` —
cutting-stock column generation with an RL pricing policy (`env_CSP.py`
425 LoC gym env, GNN `model.py`, `training.py`). The classic loop:

  master LP:  min sum_p x_p  s.t.  sum_p a_ip x_p >= d_i,  x >= 0
  pricing:    knapsack  max sum_i dual_i * a_i  s.t.  sum_i w_i a_i <= W
  add column while reduced cost 1 - dual.a < 0; final integer solution by
  rounding up / solving the restricted master as an ILP.

The pricing knapsack is a vectorized bounded-knapsack DP on the host and the
master LP is scipy linprog: both are tiny and sit in a host loop.
`PricingPolicy` is the RL hook: it chooses among candidate columns (the
env's action space); the default `best_reduced_cost` policy reproduces
exact CG.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.optimize import linprog


@dataclasses.dataclass(frozen=True)
class CuttingStockInstance:
    """Cut `demands[i]` pieces of size `sizes[i]` from rolls of `roll_width`."""

    roll_width: float
    sizes: np.ndarray  # [n] item sizes
    demands: np.ndarray  # [n] int demands

    @property
    def num_items(self) -> int:
        return int(self.sizes.shape[0])

    @staticmethod
    def random(n: int = 10, roll_width: float = 100.0, seed: int = 0):
        rng = np.random.RandomState(seed)
        sizes = rng.randint(15, 60, n).astype(np.float64)
        demands = rng.randint(5, 40, n)
        return CuttingStockInstance(roll_width, sizes, demands)


def bounded_knapsack_pricing(
    sizes: np.ndarray, capacity: float, duals: np.ndarray, max_per_item: np.ndarray
) -> Tuple[np.ndarray, float]:
    """max duals . a  s.t. sizes . a <= capacity, 0 <= a_i <= max_per_item.

    DP over integer capacities with item multiplicities (bounded knapsack
    via binary splitting into 0/1 items), backtracked on the host.
    """
    cap = int(math.floor(capacity))
    # binary-split bounded items into 0/1 items
    unit_sizes, unit_vals, owners = [], [], []
    for i, (s, d, m) in enumerate(zip(sizes, duals, max_per_item)):
        count = int(m)
        k = 1
        while count > 0:
            take = min(k, count)
            unit_sizes.append(int(round(s)) * take)
            unit_vals.append(float(d) * take)
            owners.append((i, take))
            count -= take
            k *= 2
    if not unit_sizes:
        return np.zeros(len(sizes), np.int64), 0.0

    # vectorized host DP (one row per 0/1 unit item). The pricing problem is
    # tiny (cap ~ 100, tens of unit items) and sits inside a host-side LP
    # loop, so numpy beats accelerator dispatch overhead by ~100x here.
    tables = np.zeros((len(unit_sizes) + 1, cap + 1), np.float64)
    for j, (iw, ip) in enumerate(zip(unit_sizes, unit_vals)):
        prev = tables[j]
        new = prev.copy()
        if iw <= cap:
            shifted = prev[: cap + 1 - iw] + ip
            np.maximum(new[iw:], shifted, out=new[iw:])
        tables[j + 1] = new

    a = np.zeros(len(sizes), np.int64)
    ccur = cap
    for j in range(len(unit_sizes) - 1, -1, -1):
        if tables[j + 1, ccur] > tables[j, ccur] + 1e-9:
            i, take = owners[j]
            a[i] += take
            ccur -= unit_sizes[j]
    return a, float(tables[-1, cap])


PricingPolicy = Callable[[np.ndarray, List[np.ndarray]], int]


def best_reduced_cost(duals: np.ndarray, candidates: List[np.ndarray]) -> int:
    """Default policy: pick the candidate column with the most negative
    reduced cost 1 - duals . a (exact CG behavior)."""
    rc = [1.0 - float(duals @ a) for a in candidates]
    return int(np.argmin(rc))


@dataclasses.dataclass
class CGResult:
    columns: np.ndarray  # [num_cols, n] patterns
    lp_value: float
    int_value: float
    int_counts: np.ndarray  # rolls used per column
    num_iterations: int
    history: List[float]


def solve_cutting_stock(
    inst: CuttingStockInstance,
    policy: PricingPolicy = best_reduced_cost,
    max_iters: int = 200,
    num_candidates: int = 1,
    tol: float = 1e-6,
) -> CGResult:
    """Column generation with the given pricing policy.

    `num_candidates > 1` builds a candidate pool (the optimal pricing column
    plus single-item diversification columns) and lets the policy choose —
    the RL action space of the reference env.
    """
    n = inst.num_items
    # initial columns: one size per roll
    per = np.maximum(1, np.floor(inst.roll_width / inst.sizes)).astype(np.int64)
    cols: List[np.ndarray] = [
        np.eye(n, dtype=np.int64)[i] * per[i] for i in range(n)
    ]
    history = []
    it = 0
    for it in range(max_iters):
        a_mat = np.stack(cols, axis=1)  # [n, num_cols]
        res = linprog(
            c=np.ones(a_mat.shape[1]),
            A_ub=-a_mat,
            b_ub=-inst.demands.astype(np.float64),
            bounds=(0, None),
            method="highs",
        )
        duals = -np.asarray(res.ineqlin.marginals)  # >= 0
        history.append(float(res.fun))

        max_per = np.floor(inst.roll_width / inst.sizes).astype(np.int64)
        best_a, best_v = bounded_knapsack_pricing(
            inst.sizes, inst.roll_width, duals, max_per
        )
        if 1.0 - best_v >= -tol:
            break  # no negative reduced cost: LP optimal
        candidates = [best_a]
        if num_candidates > 1:
            # distinct near-optimal columns: re-price with one high-dual item
            # excluded (a K-best-flavored pool; every candidate is still a
            # feasible pattern, and the policy chooses — the RL action space
            # of the reference's pricing env, `RL_column_generation/env_CSP.py`)
            order = np.argsort(-duals)
            for i in order[: num_candidates - 1]:
                capped = max_per.copy()
                capped[i] = 0
                alt_a, alt_v = bounded_knapsack_pricing(
                    inst.sizes, inst.roll_width, duals, capped
                )
                if 1.0 - alt_v < -tol and not any(
                    (alt_a == c).all() for c in candidates
                ):
                    candidates.append(alt_a)
        choice = policy(duals, candidates)
        chosen = candidates[choice]
        if any((chosen == c).all() for c in cols):
            cols.append(best_a)  # policy picked a duplicate: fall back
        else:
            cols.append(chosen)

    # integer solution: solve the restricted master as an ILP
    a_mat = np.stack(cols, axis=1)
    from scipy.optimize import milp, LinearConstraint, Bounds

    res_int = milp(
        c=np.ones(a_mat.shape[1]),
        constraints=LinearConstraint(a_mat, lb=inst.demands, ub=np.inf),
        integrality=np.ones(a_mat.shape[1]),
        bounds=Bounds(0, np.inf),
    )
    counts = np.rint(res_int.x).astype(np.int64)
    return CGResult(
        columns=np.stack(cols),
        lp_value=history[-1],
        int_value=float(res_int.fun),
        int_counts=counts,
        num_iterations=it + 1,
        history=history,
    )


def first_fit_decreasing(inst: CuttingStockInstance) -> int:
    """FFD upper bound (rolls used) for sanity comparisons."""
    pieces = np.repeat(inst.sizes, inst.demands)
    pieces = np.sort(pieces)[::-1]
    rolls: List[float] = []
    for p in pieces:
        for i in range(len(rolls)):
            if rolls[i] + p <= inst.roll_width:
                rolls[i] += p
                break
        else:
            rolls.append(p)
    return len(rolls)
