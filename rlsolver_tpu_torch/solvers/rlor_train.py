"""RL trainers for the three RL+OR pipelines (counterpart of the JAX
package's `solvers/rlor_train.py`):

  * learn-to-cut by policy gradient (RLSolver `methods_RLOR/RL_cutting/
    run_policy_grad.py`, `run_PPO.py`);
  * RL branching (`RL_branching/04_train_rl.py`, after the IL net of
    `04_train_il.py`);
  * RL pricing for column generation (`RL_column_generation/model.py`,
    `training.py`).

All three share one scaffold: `ScorePolicy`, a small tanh MLP on the card,
scores a variable-length candidate list (cuts, branching variables, pricing
columns); actions are drawn on the host from the masked softmax with a
numpy `Generator`, and REINFORCE with a moving baseline pushes the scorer
toward decisions that tighten bounds faster, shrink trees or cut pricing
iterations. The environments are LP-bound and stay on the host, as in the
reference; each decision is one scoring call on the card, each update one
fixed-shape step (optax's Adam as `optim.ClippedAdam(max_norm=None)`).

`train_cut_policy` and `train_pricing_policy` also take `init_from` (a
`ScorePolicy` whose parameters they start from), as
`train_branch_policy_rl` does, and every trainer takes `device`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.solvers.branching import (
    BinaryILP,
    ScoreMLP,
    branch_and_bound,
    generate_set_cover,
    masked_log_softmax,
)
from rlsolver_tpu_torch.solvers.column_generation import CuttingStockInstance, solve_cutting_stock
from rlsolver_tpu_torch.solvers.cutting import CuttingPlaneEnv


# ------------------------------------------------------------ shared scaffold
class ScorePolicy:
    """MLP scorer over candidate feature rows with masked-softmax sampling.

    `params` reads a copy of the net's state dict and writes one into it, so
    that a snapshot (`best = net.params`) is not changed by later updates."""

    def __init__(self, num_features: int, hidden: int = 32, seed: int = 0, max_candidates: int = 24,
                 lr: float = 3e-3, device=None):
        self.device = resolve_device(device)
        self.net = ScoreMLP(num_features, hidden, seed, torch.tanh).to(self.device)
        self.num_features = num_features
        self.max_candidates = max_candidates
        self.lr = lr
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """A fresh Adam(lr) over the net (optax's `opt.init`)."""
        self.opt = ClippedAdam(self.net.parameters(), self.lr, max_norm=None)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    @params.setter
    def params(self, state: Dict[str, torch.Tensor]) -> None:
        self.net.load_state_dict(state)

    def _pad(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        k = min(feats.shape[0], self.max_candidates)
        out = np.zeros((self.max_candidates, self.num_features), np.float32)
        mask = np.zeros(self.max_candidates, bool)
        out[:k], mask[:k] = feats[:k], True
        return out, mask

    def scores(self, feats: np.ndarray) -> np.ndarray:
        padded, mask = self._pad(feats)
        with torch.no_grad():
            s = self.net(torch.from_numpy(padded).to(self.device)).cpu().numpy()
        s[~mask] = -np.inf
        return s[: feats.shape[0]]

    def sample(self, feats: np.ndarray, rng: np.random.Generator, temperature: float = 1.0) -> int:
        s = self.scores(feats) / temperature
        s = s - s.max()
        p = np.exp(s)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def greedy(self, feats: np.ndarray) -> int:
        return int(np.argmax(self.scores(feats)))

    def _batch(self, rows: Sequence[Tuple[np.ndarray, int]]):
        feats = np.zeros((len(rows), self.max_candidates, self.num_features), np.float32)
        mask = np.zeros((len(rows), self.max_candidates), bool)
        labels = np.zeros(len(rows), np.int64)
        for s, (f, pos) in enumerate(rows):
            feats[s], mask[s] = self._pad(f)
            labels[s] = min(pos, self.max_candidates - 1)
        return (torch.from_numpy(v).to(self.device) for v in (feats, mask, labels))

    def _chosen_logp(self, feats, mask, labels) -> torch.Tensor:
        logp = masked_log_softmax(self.net(feats), mask)
        return logp[torch.arange(labels.shape[0], device=self.device), labels]

    def imitate(self, samples: Sequence[Tuple[np.ndarray, int]], epochs: int = 150) -> List[float]:
        """Cross-entropy pretraining on (features, expert action) pairs (the IL
        stage, `04_train_il.py`), with its own Adam(1e-3) whatever `lr` is, so
        that RL fine-tuning starts from the imitation solution."""
        feats, mask, labels = self._batch(samples)
        opt = ClippedAdam(self.net.parameters(), 1e-3, max_norm=None)
        losses = []
        for _ in range(epochs):
            opt.zero_grad()
            loss = -self._chosen_logp(feats, mask, labels).mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).tolist()

    def reinforce(self, steps: Sequence[Tuple[np.ndarray, int, float]]) -> float:
        """steps: (features [K, F], action, advantage). One Adam step."""
        if not steps:
            return 0.0
        feats, mask, actions = self._batch([(f, a) for f, a, _ in steps])
        adv = torch.tensor([g for _, _, g in steps], dtype=torch.float32, device=self.device)
        self.opt.zero_grad()
        loss = -(self._chosen_logp(feats, mask, actions) * adv).mean()
        loss.backward()
        self.opt.step()
        return float(loss.detach())


# --------------------------------------------------------------- learn-to-cut
def multi_knapsack_ilp(seed: int, n: int = 14, m: int = 3) -> BinaryILP:
    """Seeded multi-row knapsack family (fractional LP roots, many covers)."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(1, 10, (m, n))
    p = w.mean(axis=0) + rng.uniform(0, 2, n)
    cap = 0.5 * w.sum(axis=1)
    return BinaryILP(p, w, cap, f"mknap_{seed}")


def deceptive_knapsack_ilp(seed: int, n_a: int = 8, n_b: int = 8) -> BinaryILP:
    """Two-block family where max-violation is suboptimal: block A (low
    profit, tight capacity) yields the highest-violation covers but cutting
    it barely moves the LP bound; block B (high profit) yields
    lower-violation covers with real bound impact."""
    rng = np.random.RandomState(seed)
    wa = rng.uniform(1, 3, n_a)
    pa = rng.uniform(0.05, 0.15, n_a)
    wb = rng.uniform(4, 10, n_b)
    pb = wb * rng.uniform(0.9, 1.1, n_b)
    a = np.stack([np.concatenate([wa, np.zeros(n_b)]), np.concatenate([np.zeros(n_a), wb])])
    b = np.asarray([0.55 * wa.sum(), 0.5 * wb.sum()])
    return BinaryILP(np.concatenate([pa, pb]), a, b, f"dec_{seed}")


def eval_cut_policy(policy: Callable, seeds: Sequence[int], rounds: int = 8,
                    instance_fn: Callable[[int], BinaryILP] = multi_knapsack_ilp, **ilp_kw) -> float:
    """Mean LP bound after `rounds` cuts (lower = tighter = better)."""
    total = 0.0
    for s in seeds:
        env = CuttingPlaneEnv(instance_fn(s, **ilp_kw))
        feats, cuts = env.reset()
        for _ in range(rounds):
            if not cuts:
                break
            feats, cuts, _, done = env.step(cuts, policy(feats, cuts))
            if done:
                break
        total += env.bound
    return total / len(seeds)


def train_cut_policy(num_updates: int = 40, episodes_per_update: int = 8, rounds: int = 8, seed: int = 0,
                     train_seeds: Sequence[int] = tuple(range(100, 140)),
                     instance_fn: Callable[[int], BinaryILP] = multi_knapsack_ilp, verbose: bool = False,
                     init_from: Optional[ScorePolicy] = None, device=None) -> ScorePolicy:
    """REINFORCE cut-selector (`run_policy_grad.py` / `run_PPO.py`): reward =
    per-step dual-bound tightening, reward-to-go credit, moving-average
    baseline."""
    net = ScorePolicy(num_features=4, seed=seed, device=device)
    if init_from is not None:
        net.params = init_from.params
    rng = np.random.default_rng(seed)
    baseline = 0.0
    for u in range(num_updates):
        steps: List[Tuple[np.ndarray, int, float]] = []
        returns = []
        for _ in range(episodes_per_update):
            env = CuttingPlaneEnv(instance_fn(int(rng.choice(train_seeds))))
            feats, cuts = env.reset()
            traj: List[Tuple[np.ndarray, int]] = []
            rewards: List[float] = []
            for _ in range(rounds):
                if not cuts:
                    break
                a = net.sample(feats, rng)
                traj.append((feats, a))
                feats, cuts, r, done = env.step(cuts, a)
                rewards.append(r)
                if done:
                    break
            togo = np.cumsum(rewards[::-1])[::-1]
            returns.append(float(togo[0]) if len(togo) else 0.0)
            steps += [(f, a, float(g)) for (f, a), g in zip(traj, togo)]
        mean_ret = float(np.mean(returns))
        baseline = mean_ret if u == 0 else 0.9 * baseline + 0.1 * mean_ret
        loss = net.reinforce([(f, a, g - baseline) for f, a, g in steps])
        if verbose and u % 10 == 0:
            print(f"cut update {u}: return {mean_ret:.3f} loss {loss:.4f}")
    return net


# --------------------------------------------------------------- RL branching
def train_branch_policy_rl(instances: Optional[Sequence[BinaryILP]] = None, num_updates: int = 30,
                           episodes_per_update: int = 4, seed: int = 0, max_nodes: int = 400,
                           temperature: float = 0.7, init_from: Optional[ScorePolicy] = None, lr: float = 3e-3,
                           hidden: int = 64, validation: Optional[Sequence[BinaryILP]] = None,
                           verbose: bool = False, device=None) -> ScorePolicy:
    """Policy-gradient branching-variable selector (`04_train_rl.py`): an
    episode is a full B&B run; reward = -(nodes expanded); per-instance
    running baselines; `init_from` an IL-pretrained net to fine-tune; the
    greedy validation node count picks the kept parameters."""
    if instances is None:
        instances = [generate_set_cover(12, 20, seed=s) for s in range(6)]
    net = ScorePolicy(num_features=6, seed=seed, max_candidates=8, lr=lr, hidden=hidden, device=device)
    if init_from is not None:
        net.params = init_from.params
        net.reset_optimizer()
    best_params, best_nodes = net.params, None
    val_set = validation if validation is not None else instances

    def greedy_nodes():
        total = 0.0
        for ilp in val_set:
            total += np.log(max(1, branch_and_bound(ilp, policy=lambda f, c: net.greedy(f),
                                                    max_nodes=max_nodes).num_nodes))
        return float(np.exp(total / len(val_set)))

    rng = np.random.default_rng(seed)
    baselines: Dict[int, float] = {}
    for u in range(num_updates):
        steps: List[Tuple[np.ndarray, int, float]] = []
        node_counts = []
        for _ in range(episodes_per_update):
            idx = int(rng.integers(len(instances)))
            traj: List[Tuple[np.ndarray, int]] = []

            def stochastic_policy(feats, cand):
                a = net.sample(feats, rng, temperature)
                traj.append((feats, a))
                return a

            stats = branch_and_bound(instances[idx], policy=stochastic_policy, max_nodes=max_nodes)
            node_counts.append(stats.num_nodes)
            b = baselines.get(idx, float(stats.num_nodes))
            baselines[idx] = 0.8 * b + 0.2 * stats.num_nodes
            adv = (b - stats.num_nodes) / max(1.0, b)  # fewer nodes -> positive
            steps += [(f, a, adv) for f, a in traj]
        loss = net.reinforce(steps)
        if u % 5 == 0 or u == num_updates - 1:
            g = greedy_nodes()  # validation-based checkpoint selection
            if best_nodes is None or g < best_nodes:
                best_nodes, best_params = g, net.params
            if verbose:
                print(f"branch update {u}: nodes {np.mean(node_counts):.1f} greedy geomean {g:.2f} loss {loss:.4f}")
    net.params = best_params
    return net


def eval_branch_policy(policy, instances: Sequence[BinaryILP], max_nodes: int = 2000) -> Tuple[float, float]:
    """(geometric-mean nodes, mean objective) over instances (`05_evaluate.py`)."""
    nodes, objs = [], []
    for ilp in instances:
        stats = branch_and_bound(ilp, policy=policy, max_nodes=max_nodes)
        nodes.append(max(1, stats.num_nodes))
        objs.append(stats.objective)
    return float(np.exp(np.mean(np.log(nodes)))), float(np.mean(objs))


# ------------------------------------------------------------ RL pricing (CG)
def _pricing_features(inst: CuttingStockInstance, duals: np.ndarray, candidates: List[np.ndarray]) -> np.ndarray:
    """[reduced cost, fill ratio, distinct items, dual mass] per candidate."""
    out = []
    dsum = duals.sum() + 1e-9
    for a in candidates:
        out.append([1.0 - float(duals @ a), float(a @ inst.sizes) / inst.roll_width,
                    float((a > 0).sum()) / inst.num_items, float(duals @ (a > 0)) / dsum])
    return np.asarray(out, np.float32)


def train_pricing_policy(num_updates: int = 30, episodes_per_update: int = 6, seed: int = 0,
                         num_candidates: int = 4, train_sizes: Sequence[int] = (8, 10, 12),
                         validation: Optional[Sequence[CuttingStockInstance]] = None, lr: float = 1e-3,
                         verbose: bool = False, init_from: Optional[ScorePolicy] = None,
                         device=None) -> ScorePolicy:
    """Learned pricing scorer for cutting-stock CG (`model.py`,
    `training.py`): an episode is a full CG solve; reward = -(pricing
    iterations). The net is warm-started to imitate exact pricing, then
    REINFORCE explores the candidate pool; checkpoints are selected by
    greedy validation iterations (never worse than the imitation start)."""
    net = ScorePolicy(num_features=4, seed=seed, max_candidates=num_candidates, lr=lr, device=device)
    if init_from is not None:
        net.params = init_from.params
    rng = np.random.default_rng(seed)
    baselines: Dict[Tuple[int, int], float] = {}

    # imitation warm start: label = candidate 0 (the exact pricing column)
    warm = []
    for s in range(8):
        inst = CuttingStockInstance.random(int(rng.choice(train_sizes)), seed=1000 + s)

        def record(duals, candidates, _inst=inst):
            warm.append((_pricing_features(_inst, duals, candidates), 0))
            return 0

        solve_cutting_stock(inst, policy=record, num_candidates=num_candidates)
    net.imitate(warm, epochs=200)

    if validation is None:
        validation = [CuttingStockInstance.random(10, seed=900 + v) for v in range(6)]

    def greedy_iters():
        total = 0
        for inst in validation:
            def p(duals, candidates, _inst=inst):
                return net.greedy(_pricing_features(_inst, duals, candidates))

            total += solve_cutting_stock(inst, policy=p, num_candidates=num_candidates).num_iterations
        return total / len(validation)

    best_params, best_iters = net.params, greedy_iters()
    for u in range(num_updates):
        steps: List[Tuple[np.ndarray, int, float]] = []
        iters = []
        for _ in range(episodes_per_update):
            n = int(rng.choice(train_sizes))
            s = int(rng.integers(50))
            inst = CuttingStockInstance.random(n, seed=s)
            traj: List[Tuple[np.ndarray, int]] = []

            def rl_policy(duals, candidates):
                feats = _pricing_features(inst, duals, candidates)
                a = net.sample(feats, rng)
                traj.append((feats, a))
                return a

            res = solve_cutting_stock(inst, policy=rl_policy, num_candidates=num_candidates)
            iters.append(res.num_iterations)
            b = baselines.get((n, s), float(res.num_iterations))
            baselines[(n, s)] = 0.8 * b + 0.2 * res.num_iterations
            adv = (b - res.num_iterations) / max(1.0, b)
            steps += [(f, a, adv) for f, a in traj]
        loss = net.reinforce(steps)
        if u % 5 == 0 or u == num_updates - 1:
            g = greedy_iters()
            if g < best_iters:
                best_iters, best_params = g, net.params
            if verbose:
                print(f"pricing update {u}: iters {np.mean(iters):.1f} greedy-val {g:.2f} loss {loss:.4f}")
    net.params = best_params
    return net


def eval_pricing_policy(policy, instances: Sequence[CuttingStockInstance],
                        num_candidates: int = 4) -> Tuple[float, float]:
    """(mean pricing iterations, mean integer value) over instances."""
    iters, vals = [], []
    for inst in instances:
        res = solve_cutting_stock(inst, policy=policy, num_candidates=num_candidates)
        iters.append(res.num_iterations)
        vals.append(res.int_value)
    return float(np.mean(iters)), float(np.mean(vals))
