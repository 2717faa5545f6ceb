"""Learn-to-branch: B&B for binary ILPs and strong-branching imitation
(counterpart of the JAX package's `solvers/branching.py`; RLSolver's
`methods_RLOR/RL_branching/` pipeline without SCIP).

A best-bound branch-and-bound over scipy-linprog (HiGHS) relaxations plays
the solver, strong branching plays the oracle, and `BranchNet`, an MLP on
the card, scores candidate variables from Khalil-style features. The LPs
stay on the host; the net scores each node's candidates in one device call.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import linprog
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense
from rlsolver_tpu_torch.optim import ClippedAdam


# ------------------------------------------------------------- instances
@dataclasses.dataclass(frozen=True)
class BinaryILP:
    """max c.x  s.t.  A x <= b,  x in {0,1}^n."""

    c: np.ndarray  # [n]
    a: np.ndarray  # [m, n]
    b: np.ndarray  # [m]
    name: str = ""

    @property
    def num_vars(self) -> int:
        return int(self.c.shape[0])


def generate_set_cover(n_items: int = 20, n_sets: int = 12, seed: int = 0, density: float = 0.5) -> BinaryILP:
    """Min-cost set cover as max(-cost); near-unicost costs and dense
    membership give fractional LP roots."""
    rng = np.random.RandomState(seed)
    membership = rng.rand(n_items, n_sets) < density
    for i in range(n_items):  # every item coverable
        if not membership[i].any():
            membership[i, rng.randint(n_sets)] = True
    cost = np.ones(n_sets) + rng.uniform(0, 0.05, n_sets)
    # cover: sum_j m_ij x_j >= 1  ->  -m x <= -1
    return BinaryILP(-cost, -membership.astype(np.float64), -np.ones(n_items), "setcover")


def generate_indset(graph, seed: int = 0) -> BinaryILP:
    """Max independent set: x_i + x_j <= 1 per edge."""
    n, m = graph.num_nodes, graph.num_edges
    a = np.zeros((m, n))
    for e, (i, j) in enumerate(graph.edges):
        a[e, i] = 1.0
        a[e, j] = 1.0
    return BinaryILP(np.ones(n), a, np.ones(m), "indset")


def generate_cauctions(n_items: int = 15, n_bids: int = 20, seed: int = 0) -> BinaryILP:
    """Combinatorial auctions: bids over item bundles, items sold once."""
    rng = np.random.RandomState(seed)
    bundles = rng.rand(n_items, n_bids) < 0.25
    for j in range(n_bids):
        if not bundles[:, j].any():
            bundles[rng.randint(n_items), j] = True
    value = bundles.sum(axis=0) * rng.uniform(0.8, 1.2, n_bids)
    return BinaryILP(value, bundles.astype(np.float64), np.ones(n_items), "cauctions")


def generate_facility(n_customers: int = 8, n_facilities: int = 5, seed: int = 0) -> BinaryILP:
    """Uncapacitated facility location (binarized assignment form)."""
    rng = np.random.RandomState(seed)
    open_cost = rng.uniform(5, 15, n_facilities)
    serve_cost = rng.uniform(1, 8, (n_customers, n_facilities))
    n = n_facilities + n_customers * n_facilities  # y_f, x_cf
    c = np.concatenate([-open_cost, -serve_cost.reshape(-1)])
    rows, rhs = [], []
    for cu in range(n_customers):
        # each customer served exactly once (as two inequalities)
        row = np.zeros(n)
        row[n_facilities + cu * n_facilities: n_facilities + (cu + 1) * n_facilities] = 1.0
        rows += [row, -row]
        rhs += [1.0, -1.0]
        for f in range(n_facilities):  # x_cf <= y_f
            row = np.zeros(n)
            row[n_facilities + cu * n_facilities + f] = 1.0
            row[f] = -1.0
            rows.append(row)
            rhs.append(0.0)
    return BinaryILP(c, np.stack(rows), np.asarray(rhs), "facility")


# --------------------------------------------------------------- features
NUM_FEATURES = 6


def branching_features(c: np.ndarray, a: np.ndarray, x_lp: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Per-candidate features [frac distance, obj coef (normed), column
    density, column norm, up-frac, down-frac], f32 [len(cand), 6]."""
    cn = np.abs(c).max() + 1e-9
    frac = x_lp[cand]
    density = (a[:, cand] != 0).mean(axis=0)
    colnorm = np.abs(a[:, cand]).sum(axis=0) / (np.abs(a).sum() + 1e-9)
    return np.stack([0.5 - np.abs(frac - 0.5), c[cand] / cn, density, colnorm, 1.0 - frac, frac],
                    axis=1).astype(np.float32)


# ----------------------------------------------------------------- solver
class _Node(NamedTuple):
    neg_bound: float
    tie: int
    fixed0: frozenset
    fixed1: frozenset


def _solve_lp(ilp: BinaryILP, fixed0, fixed1):
    bounds = [(0, 0) if i in fixed0 else (1, 1) if i in fixed1 else (0, 1) for i in range(ilp.num_vars)]
    res = linprog(c=-ilp.c, A_ub=ilp.a, b_ub=ilp.b, bounds=bounds, method="highs")
    if not res.success:
        return None, -np.inf
    return np.asarray(res.x), -float(res.fun)


BranchPolicy = Callable[[np.ndarray, np.ndarray], int]
# (features [k, F], candidate indices [k]) -> position in candidates


def most_fractional_policy(features: np.ndarray, cand: np.ndarray) -> int:
    return int(np.argmax(features[:, 0]))


def strong_branching_score(ilp, fixed0, fixed1, bound, cand) -> np.ndarray:
    """Product-rule strong branching: score = dec_down * dec_up."""
    scores = np.zeros(len(cand))
    for k, i in enumerate(cand):
        _, up = _solve_lp(ilp, fixed0, fixed1 | {i})
        _, down = _solve_lp(ilp, fixed0 | {i}, fixed1)
        scores[k] = max(1e-6, bound - up) * max(1e-6, bound - down)
    return scores


@dataclasses.dataclass
class SolveStats:
    objective: float
    solution: np.ndarray
    num_nodes: int
    samples: List[Tuple[np.ndarray, int]]  # (features, chosen position)


def branch_and_bound(ilp: BinaryILP, policy: Optional[BranchPolicy] = None, use_strong: bool = False,
                     collect_samples: bool = False, max_nodes: int = 2000, max_candidates: int = 8) -> SolveStats:
    """Best-bound B&B. `use_strong=True` branches by strong branching (the
    oracle, also the IL teacher when `collect_samples`); otherwise `policy`
    picks among the `max_candidates` most-fractional variables."""
    best_val = -np.inf
    best_x = np.zeros(ilp.num_vars)
    x0, bound0 = _solve_lp(ilp, frozenset(), frozenset())
    if x0 is None:
        return SolveStats(-np.inf, best_x, 0, [])
    heap = [_Node(-bound0, 0, frozenset(), frozenset())]
    tie, nodes = 1, 0
    samples: List[Tuple[np.ndarray, int]] = []
    while heap and nodes < max_nodes:
        node = heapq.heappop(heap)
        if -node.neg_bound <= best_val + 1e-9:
            continue
        x, bound = _solve_lp(ilp, node.fixed0, node.fixed1)
        nodes += 1
        if x is None or bound <= best_val + 1e-9:
            continue
        frac_mask = (x > 1e-6) & (x < 1 - 1e-6)
        if not frac_mask.any():
            xi = np.rint(x)
            val = float(ilp.c @ xi)
            if (ilp.a @ xi <= ilp.b + 1e-6).all() and val > best_val:
                best_val, best_x = val, xi
            continue
        frac_idx = np.where(frac_mask)[0]
        order = np.argsort(-(0.5 - np.abs(x[frac_idx] - 0.5)))
        cand = frac_idx[order[:max_candidates]]
        feats = branching_features(ilp.c, ilp.a, x, cand)
        if use_strong:
            pos = int(np.argmax(strong_branching_score(ilp, node.fixed0, node.fixed1, bound, cand)))
            if collect_samples:
                samples.append((feats, pos))
        elif policy is not None:
            pos = policy(feats, cand)
        else:
            pos = most_fractional_policy(feats, cand)
        i = int(cand[pos])
        for child_f0, child_f1 in ((node.fixed0 | {i}, node.fixed1), (node.fixed0, node.fixed1 | {i})):
            heapq.heappush(heap, _Node(-bound, tie, child_f0, child_f1))
            tie += 1
    return SolveStats(best_val, best_x, nodes, samples)


# --------------------------------------------------------------- IL policy
def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log_softmax over candidates with padded slots at -1e9."""
    return torch.log_softmax(torch.where(mask, logits, torch.full_like(logits, -1e9)), dim=1)


class ScoreMLP(nn.Module):
    """Dense_0 -> act -> Dense_1 -> act -> Dense_2 -> [..] (one score per
    row), flax's names and [in, out] kernels, initialised as flax does from
    a seeded CPU generator. BranchNet's net (relu) and ScorePolicy's (tanh)."""

    def __init__(self, num_features: int, hidden: int, seed: int, activation: Callable = torch.relu):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(num_features, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, 1, gen)
        self.activation = activation

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.activation(self.Dense_1(self.activation(self.Dense_0(feats))))
        return self.Dense_2(x)[..., 0]


class BranchNet:
    """MLP scoring branching candidates (the IL policy, `model.py`), on the
    card unless `device="cpu"`."""

    def __init__(self, hidden: int = 64, seed: int = 0, pad_candidates: int = 8, device=None):
        self.device = resolve_device(device)
        self.net = ScoreMLP(NUM_FEATURES, hidden, seed, torch.relu).to(self.device)
        self.pad_candidates = pad_candidates

    def train_il(self, samples: List[Tuple[np.ndarray, int]], epochs: int = 200, lr: float = 1e-3) -> List[float]:
        """Cross-entropy imitation of the strong-branching choice
        (`04_train_il.py`), samples padded to one candidate count, Adam."""
        k = max(s[0].shape[0] for s in samples)
        feats = np.zeros((len(samples), k, NUM_FEATURES), np.float32)
        mask = np.zeros((len(samples), k), bool)
        labels = np.zeros(len(samples), np.int64)
        for s, (f, pos) in enumerate(samples):
            feats[s, : f.shape[0]] = f
            mask[s, : f.shape[0]] = True
            labels[s] = pos
        feats_t, mask_t, labels_t = (torch.from_numpy(v).to(self.device) for v in (feats, mask, labels))
        opt = ClippedAdam(self.net.parameters(), lr, max_norm=None)
        rows = torch.arange(len(samples), device=self.device)
        losses = []
        for _ in range(epochs):
            opt.zero_grad()
            loss = -masked_log_softmax(self.net(feats_t), mask_t)[rows, labels_t].mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).tolist()

    def policy(self) -> BranchPolicy:
        """The learned branching rule: one scoring call on the card per node,
        over the node's candidates padded (or cut) to `pad_candidates`."""
        pad = self.pad_candidates

        def choose(feats: np.ndarray, cand: np.ndarray) -> int:
            k = feats.shape[0]
            padded = np.zeros((pad, NUM_FEATURES), np.float32)
            padded[: min(k, pad)] = feats[:pad]
            with torch.no_grad():
                scores = self.net(torch.from_numpy(padded).to(self.device)).cpu().numpy()
            scores[k:] = -np.inf
            return int(np.argmax(scores))

        return choose
