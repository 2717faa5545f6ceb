"""Learn-to-cut: a cutting-plane environment over binary ILPs (counterpart
of the JAX package's `solvers/cutting.py`; numpy and scipy on the host).

Reference counterpart: `rlsolver/methods_RLOR/RL_cutting/` — PPO on a
Gurobi-backed cutting-plane gym (`env/solverutils.py` 435 LoC,
`run_PPO.py`, `run_policy_grad.py`): state = current LP relaxation, action
= which candidate cut to add, reward = dual-bound improvement.

Gurobi/tableau access is unavailable here, so candidate cuts are **cover
inequalities** separated from knapsack-type rows (a classic exact
separation: for row a.x <= b and LP point x*, a minimal cover C with
sum_{i in C} a_i > b and sum_{i in C} (1 - x*_i) < 1 yields the violated
cut sum_{i in C} x_i <= |C| - 1). The env exposes per-cut features and a
pluggable policy — `max_violation_policy` is the classical baseline, and
any scorer (e.g. a trained net) drops in (the RL hook).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.optimize import linprog

from rlsolver_tpu_torch.solvers.branching import BinaryILP


@dataclasses.dataclass
class Cut:
    """sum_{i in cover} x_i <= rhs."""

    cover: np.ndarray  # variable indices
    rhs: float
    violation: float
    source_row: int


def separate_cover_cuts(
    ilp: BinaryILP, x: np.ndarray, max_cuts: int = 20
) -> List[Cut]:
    """Exact greedy cover-cut separation over knapsack-type rows
    (rows with all-nonnegative coefficients and positive rhs)."""
    cuts: List[Cut] = []
    for r in range(ilp.a.shape[0]):
        row, rhs = ilp.a[r], ilp.b[r]
        if rhs <= 0 or (row < 0).any():
            continue
        pos = np.where(row > 1e-12)[0]
        if len(pos) < 2:
            continue
        # greedy min sum(1 - x*) cover: sort by (1 - x*) / a
        order = pos[np.argsort((1.0 - x[pos]) / row[pos])]
        total, cover = 0.0, []
        for i in order:
            cover.append(i)
            total += row[i]
            if total > rhs + 1e-9:
                break
        else:
            continue  # row cannot be violated
        cover_arr = np.asarray(cover)
        slack = float((1.0 - x[cover_arr]).sum())
        if slack < 1.0 - 1e-6:
            cuts.append(
                Cut(cover_arr, float(len(cover) - 1), 1.0 - slack, r)
            )
    cuts.sort(key=lambda c: -c.violation)
    return cuts[:max_cuts]


def cut_features(ilp: BinaryILP, x: np.ndarray, cuts: List[Cut]) -> np.ndarray:
    """Per-cut features [violation, sparsity, obj-parallelism, rhs/size]."""
    cn = np.linalg.norm(ilp.c) + 1e-9
    feats = []
    for cut in cuts:
        coef = np.zeros(ilp.num_vars)
        coef[cut.cover] = 1.0
        feats.append(
            [
                cut.violation,
                len(cut.cover) / ilp.num_vars,
                float(ilp.c @ coef) / (cn * (np.linalg.norm(coef) + 1e-9)),
                cut.rhs / max(1, len(cut.cover)),
            ]
        )
    return np.asarray(feats, np.float32)


CutPolicy = Callable[[np.ndarray, List[Cut]], int]


def max_violation_policy(feats: np.ndarray, cuts: List[Cut]) -> int:
    return 0  # cuts arrive violation-sorted


class CuttingPlaneEnv:
    """Gym-style loop: reset -> (features, cuts); step(action) adds the
    chosen cut, re-solves the LP, returns bound improvement as reward."""

    def __init__(self, ilp: BinaryILP, max_cuts: int = 20):
        self.ilp = ilp
        self.max_cuts = max_cuts
        self.extra_rows: List[np.ndarray] = []
        self.extra_rhs: List[float] = []
        self.x: Optional[np.ndarray] = None
        self.bound: float = np.inf

    def _solve(self) -> Tuple[np.ndarray, float]:
        a = self.ilp.a
        b = self.ilp.b
        if self.extra_rows:
            a = np.vstack([a, np.stack(self.extra_rows)])
            b = np.concatenate([b, np.asarray(self.extra_rhs)])
        res = linprog(
            c=-self.ilp.c, A_ub=a, b_ub=b, bounds=(0, 1), method="highs"
        )
        return np.asarray(res.x), -float(res.fun)

    def reset(self):
        self.extra_rows, self.extra_rhs = [], []
        self.x, self.bound = self._solve()
        cuts = separate_cover_cuts(self.ilp, self.x, self.max_cuts)
        return cut_features(self.ilp, self.x, cuts), cuts

    def step(self, cuts: List[Cut], action: int):
        cut = cuts[action]
        coef = np.zeros(self.ilp.num_vars)
        coef[cut.cover] = 1.0
        self.extra_rows.append(coef)
        self.extra_rhs.append(cut.rhs)
        self.x, new_bound = self._solve()
        reward = self.bound - new_bound  # dual-bound tightening
        self.bound = new_bound
        new_cuts = separate_cover_cuts(self.ilp, self.x, self.max_cuts)
        done = not new_cuts
        return cut_features(self.ilp, self.x, new_cuts), new_cuts, reward, done


def cutting_plane_loop(
    ilp: BinaryILP,
    policy: CutPolicy = max_violation_policy,
    max_rounds: int = 50,
) -> Tuple[float, float, int]:
    """Run the cutting loop; returns (root bound, final bound, cuts added).

    The bound is monotonically non-increasing (each cut is valid for the
    integer hull and removes the current fractional point)."""
    env = CuttingPlaneEnv(ilp)
    feats, cuts = env.reset()
    root = env.bound
    added = 0
    for _ in range(max_rounds):
        if not cuts:
            break
        action = policy(feats, cuts)
        feats, cuts, reward, done = env.step(cuts, action)
        added += 1
        if done:
            break
    return root, env.bound, added
