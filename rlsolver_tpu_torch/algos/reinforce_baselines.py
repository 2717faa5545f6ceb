"""REINFORCE baselines and a generic constructive-policy trainer
(counterpart of `rlsolver_tpu/algos/reinforce_baselines.py`; the rl4co
baseline zoo vendored in RLSolver,
`methods/ECO_S2V/rl4co/models/rl/reinforce/baselines.py:18-292`).

  NoBaseline, SharedBaseline (POMO: the mean over the starts),
  ExponentialBaseline (EMA of the mean reward, beta 0.8; MeanBaseline is
  its alias), WarmupBaseline (a convex ramp from its own exponential
  baseline into the wrapped one), CriticBaseline (a learned value of the
  instance, MSE-trained by Adam beside the policy), RolloutBaseline (greedy
  rollouts of a frozen policy copy, replaced by the candidate when a
  one-sided paired t-test on a held-out set is significant at `bl_alpha`).

A baseline's `eval(state, rewards, nodes) -> (values, state)` runs in the
training step; `epoch_update(state, model)` is the host epoch callback (the
rollout baseline's t-test). The state is a `BaselineState` (its counters on
the host, its EMAs as device scalars). `train_reinforce` drives any policy
through an adapter (`sample_instances`, `make_model`, `rollout`):
`TSPAdapter` (the AM attention policy, rewards = minus tour lengths) or
`S2VMaxcutAdapter` (the constructive S2V maxcut policy, rewards = cuts).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlsolver_tpu_torch.algos.am_pomo import rollout_pomo
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
from rlsolver_tpu_torch.models.transformer import Dense
from rlsolver_tpu_torch.optim import ClippedAdam


@dataclasses.dataclass
class BaselineState:
    """Every baseline kind's state (the leaves a kind does not use stay
    empty). WarmupBaseline keeps its own EMA and ramp counter beside the
    wrapped baseline's (`baselines.py:92-136`)."""

    ema: Optional[torch.Tensor] = None
    steps: int = 0
    critic: Optional[nn.Module] = None
    critic_opt: Optional[ClippedAdam] = None
    frozen: Optional[nn.Module] = None  # the rollout baseline's policy copy
    frozen_mean: float = 0.0  # its mean greedy reward on the held-out set
    warmup_ema: Optional[torch.Tensor] = None
    warmup_steps: int = 0
    swaps: int = 0  # times the rollout baseline took the candidate


class CriticNet(nn.Module):
    """Mean-pooled instance encoder -> scalar value (rl4co CriticNetwork):
    Dense_0, relu, mean over cities, Dense_1, relu, Dense_2."""

    def __init__(self, in_features: int = 2, hidden: int = 128, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(in_features, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, 1, gen)

    def forward(self, nodes: torch.Tensor) -> torch.Tensor:  # [B, N, F] -> [B]
        x = torch.relu(self.Dense_0(nodes)).mean(dim=1)
        return self.Dense_2(torch.relu(self.Dense_1(x)))[..., 0]


class Baseline:
    """Functional baseline; subclasses override init / eval / epoch_update."""

    name = "no"

    def init(self, model, sample_nodes) -> BaselineState:
        return BaselineState()

    def eval(self, state: BaselineState, rewards: torch.Tensor,
             nodes: torch.Tensor) -> Tuple[torch.Tensor, BaselineState]:
        """rewards [B] or [B, P] -> (baseline values shaped like rewards, state)."""
        return torch.zeros_like(rewards), state

    def epoch_update(self, state: BaselineState, model) -> BaselineState:
        return state


class NoBaseline(Baseline):
    pass


class SharedBaseline(Baseline):
    """POMO: the mean over the starts (`baselines.py:56-60`)."""

    name = "shared"

    def eval(self, state, rewards, nodes):
        if rewards.ndim < 2:
            raise ValueError("shared baseline needs [batch, pomo] rewards")
        return rewards.mean(dim=1, keepdim=True), state


def _ema(ema: Optional[torch.Tensor], steps: int, beta: float, m: torch.Tensor) -> torch.Tensor:
    return m if steps == 0 else beta * ema + (1.0 - beta) * m


class ExponentialBaseline(Baseline):
    """v <- beta v + (1 - beta) mean(reward), v = the first mean at first
    (`baselines.py:63-82`)."""

    name = "exponential"

    def __init__(self, beta: float = 0.8):
        self.beta = beta

    def eval(self, state, rewards, nodes):
        v = _ema(state.ema, state.steps, self.beta, rewards.mean())
        return v.expand(rewards.shape), dataclasses.replace(state, ema=v, steps=state.steps + 1)


def MeanBaseline(**kw) -> Baseline:
    """rl4co aliases mean to exponential (`baselines.py:85-89`)."""
    return ExponentialBaseline(**kw)


class WarmupBaseline(Baseline):
    """A convex ramp from an exponential baseline into `inner` over
    `n_steps` updates (`baselines.py:92-136`, the epoch ramp at update
    granularity): alpha = min(steps / n_steps, 1)."""

    name = "warmup"

    def __init__(self, inner: Baseline, n_steps: int = 100, beta: float = 0.8):
        self.inner, self.beta, self.n_steps = inner, beta, n_steps

    def init(self, model, sample_nodes):
        return self.inner.init(model, sample_nodes)

    def eval(self, state, rewards, nodes):
        inner_v, state = self.inner.eval(state, rewards, nodes)
        exp_v = _ema(state.warmup_ema, state.warmup_steps, self.beta, rewards.mean())
        alpha = float(np.clip(np.float32(state.warmup_steps) / np.float32(self.n_steps), 0.0, 1.0))
        state = dataclasses.replace(state, warmup_ema=exp_v, warmup_steps=state.warmup_steps + 1)
        return alpha * inner_v + (1.0 - alpha) * exp_v, state

    def epoch_update(self, state, model):
        return self.inner.epoch_update(state, model)


class CriticBaseline(Baseline):
    """A learned value of the instance (`baselines.py:139-158`): evaluated
    without gradient; `update_critic` takes one Adam step on the MSE to the
    mean reward after each policy step."""

    name = "critic"

    def __init__(self, hidden: int = 128, lr: float = 1e-3, seed: int = 0):
        self.hidden, self.lr, self.seed = hidden, lr, seed

    def init(self, model, sample_nodes):
        critic = CriticNet(sample_nodes.shape[-1], self.hidden, self.seed).to(sample_nodes.device)
        return BaselineState(critic=critic, critic_opt=ClippedAdam(critic.parameters(), self.lr, max_norm=None))

    def eval(self, state, rewards, nodes):
        with torch.no_grad():
            v = state.critic(nodes)
        if rewards.ndim == 2:
            v = v[:, None]
        return v.expand(rewards.shape), dataclasses.replace(state, steps=state.steps + 1)

    def update_critic(self, state, rewards, nodes) -> BaselineState:
        target = rewards.detach().mean(dim=tuple(range(1, rewards.ndim))) if rewards.ndim > 1 else rewards.detach()
        loss = torch.mean((state.critic(nodes) - target) ** 2)
        state.critic_opt.zero_grad()
        loss.backward()
        state.critic_opt.step()
        return state


class RolloutBaseline(Baseline):
    """Greedy rollouts of a frozen policy copy (`baselines.py:161-243`):
    eval = the copy's greedy reward on the same instances; the epoch
    callback rolls the candidate and the copy out greedily on the held-out
    `eval_nodes` and adopts the candidate when their paired difference
    passes a one-sided t-test at `bl_alpha`. `adapter` gives the rollout
    (anything with `.rollout(model, instances, greedy=True)`); without one
    the model is an AttentionTSP rolled out from one start."""

    name = "rollout"

    def __init__(self, eval_nodes: torch.Tensor, adapter=None, bl_alpha: float = 0.05):
        self.eval_nodes, self.adapter, self.bl_alpha = eval_nodes, adapter, bl_alpha

    @torch.no_grad()
    def greedy_rewards(self, model, nodes: torch.Tensor) -> torch.Tensor:
        if self.adapter is not None:
            _, _, rewards = self.adapter.rollout(model, nodes, greedy=True)
            return rewards[:, 0] if rewards.ndim == 2 else rewards
        _, _, lengths = rollout_pomo(model, nodes, pomo_size=1, greedy=True)
        return -lengths[:, 0]

    def init(self, model, sample_nodes):
        frozen = copy.deepcopy(model).requires_grad_(False)
        return BaselineState(frozen=frozen, frozen_mean=float(self.greedy_rewards(frozen, self.eval_nodes).mean()))

    def eval(self, state, rewards, nodes):
        v = self.greedy_rewards(state.frozen, nodes)
        if rewards.ndim == 2:
            v = v[:, None]
        return v.expand(rewards.shape), state

    def epoch_update(self, state, model):
        cand = self.greedy_rewards(model, self.eval_nodes).double().cpu().numpy()
        base = self.greedy_rewards(state.frozen, self.eval_nodes).double().cpu().numpy()
        if not rollout_swap(cand - base, self.bl_alpha):
            return state
        return dataclasses.replace(state, frozen=copy.deepcopy(model).requires_grad_(False),
                                   frozen_mean=float(cand.mean()), swaps=state.swaps + 1)


def rollout_swap(diff: np.ndarray, bl_alpha: float) -> bool:
    """The rollout baseline's decision on the paired differences (candidate
    less frozen): a positive mean whose one-sided t-test p-value is below
    `bl_alpha`."""
    if diff.mean() <= 0:
        return False
    n = diff.shape[0]
    t = diff.mean() / max(diff.std(ddof=1) / np.sqrt(n), 1e-12)
    return _t_sf(t, n - 1) < bl_alpha


def _t_sf(t: float, df: int) -> float:
    """Student-t survival function through the regularized incomplete beta
    (Abramowitz-Stegun continued fraction)."""
    x = df / (df + t * t)
    ib = _betainc(df / 2.0, 0.5, x)
    return 0.5 * ib if t > 0 else 1.0 - 0.5 * ib


def _betainc(a: float, b: float, x: float, iters: int = 200) -> float:
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_front = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b) + a * math.log(x) + b * math.log1p(-x)
    # Lentz continued fraction for I_x(a, b)
    f, c, d = 1.0, 1.0, 0.0
    for i in range(iters):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
        c = 1.0 + num / (c if abs(c) > 1e-30 else 1e-30)
        f *= c * d
    val = math.exp(ln_front) / a * (f - 1.0)
    # the symmetry relation outside the convergent region
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    return min(max(val, 0.0), 1.0)


_REGISTRY = {
    "no": lambda **kw: NoBaseline(),
    "shared": lambda **kw: SharedBaseline(),
    "exponential": lambda **kw: ExponentialBaseline(**kw),
    "mean": lambda **kw: MeanBaseline(**kw),
    "critic": lambda **kw: CriticBaseline(**kw),
}


def get_reinforce_baseline(name: str, **kw) -> Baseline:
    """Name -> baseline (`get_reinforce_baseline`, `baselines.py:286-292`):
    `warmup_<name>` wraps `<name>` in a warmup ramp; `rollout` takes the
    held-out `eval_nodes` (and an `adapter`) as keywords."""
    if name == "rollout":
        return RolloutBaseline(**kw)
    if name.startswith("warmup_"):
        return WarmupBaseline(get_reinforce_baseline(name[len("warmup_"):], **kw))
    if name not in _REGISTRY:
        raise ValueError(f"unknown baseline {name!r}; one of {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


# ------------------------------------------------------------------ trainer
@dataclasses.dataclass
class ReinforceConfig:
    num_cities: int = 20
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    batch_size: int = 64
    pomo_size: int = 1  # 1 = plain REINFORCE; > 1 = multistart
    num_steps: int = 100
    epoch_every: int = 20  # the host epoch callback's cadence (rollout t-test)
    lr: float = 1e-4
    ent_coef: float = 0.0  # entropy bonus (0 = rl4co's behaviour)
    seed: int = 0


class TSPAdapter:
    """The AM attention policy over uniform random TSP batches (the rl4co
    AttentionModel through the zoo); rewards are minus the tour lengths."""

    def __init__(self, cfg: ReinforceConfig, instance_sampler: Optional[Callable] = None, device=None):
        self.cfg, self.device, self._sampler = cfg, resolve_device(device), instance_sampler

    def sample_instances(self, gen: Optional[torch.Generator]) -> torch.Tensor:
        if self._sampler is not None:
            return self._sampler(gen)
        return torch.rand(self.cfg.batch_size, self.cfg.num_cities, 2, generator=gen, device=self.device)

    def make_model(self) -> nn.Module:
        return AttentionTSP(self.cfg.embed_dim, self.cfg.num_heads, self.cfg.num_layers, seed=self.cfg.seed,
                            device=self.device)

    def rollout(self, model, nodes, greedy: bool = False, gen: Optional[torch.Generator] = None):
        tours, logp, lengths = rollout_pomo(model, nodes, pomo_size=1 if greedy else self.cfg.pomo_size,
                                            greedy=greedy, gen=gen)
        return tours, logp, -lengths  # rewards [B, P]


class S2VMaxcutAdapter:
    """The constructive S2V maxcut policy through the zoo (RLSolver's
    `ECO_S2V/rl4co/models/zoo/S2V/`): instances are dense adjacencies drawn
    from a pool of `pool_size` seeded graphs (seeds 0..pool_size-1), the
    policy moves `horizon` nodes to side 1, and the reward is the cut."""

    def __init__(self, cfg: ReinforceConfig, num_nodes: int = 64, graph_type=None, horizon: Optional[int] = None,
                 pool_size: int = 64, device=None):
        from rlsolver_tpu_torch.config import GraphType

        self.cfg, self.device = cfg, resolve_device(device)
        self.num_nodes, self.graph_type = num_nodes, graph_type or GraphType.BA
        self.horizon, self.pool_size = horizon or num_nodes // 2, pool_size
        self._adj_pool: Optional[torch.Tensor] = None

    def pool(self) -> torch.Tensor:
        if self._adj_pool is None:
            from rlsolver_tpu_torch.core.generate import generate_graph

            adjs = [generate_graph(self.graph_type, self.num_nodes, seed=s).adjacency_dense()
                    for s in range(self.pool_size)]
            self._adj_pool = torch.from_numpy(np.stack(adjs)).to(self.device)
        return self._adj_pool

    def sample_instances(self, gen: Optional[torch.Generator]) -> torch.Tensor:
        ids = torch.randint(0, self.pool_size, (self.cfg.batch_size,), generator=gen, device=self.device)
        return self.pool()[ids]

    def make_model(self) -> nn.Module:
        from rlsolver_tpu_torch.models.s2v_policy import S2VConstructivePolicy

        return S2VConstructivePolicy(self.cfg.embed_dim, self.cfg.num_layers, seed=self.cfg.seed).to(self.device)

    def rollout(self, model, adj, greedy: bool = False, gen: Optional[torch.Generator] = None):
        from rlsolver_tpu_torch.models.s2v_policy import rollout_s2v_maxcut

        return rollout_s2v_maxcut(model, adj, gen=gen, horizon=self.horizon, greedy=greedy)  # (xs, logp [B], cuts [B])


def train_reinforce(baseline: Baseline, cfg: ReinforceConfig = ReinforceConfig(),
                    instance_sampler: Optional[Callable] = None, adapter=None, device=None,
                    timings: Optional[List[float]] = None) -> Tuple[nn.Module, Dict[str, list], BaselineState]:
    """REINFORCE with a baseline on any constructive-policy adapter (rl4co
    `REINFORCE.shared_step`): the loss is -mean((reward - baseline) logp)
    (less `ent_coef` times the mean -logp), clipped to global norm 1, then
    Adam; a critic baseline (unwrapped) takes its own step after each; every
    `epoch_every` steps the epoch callback runs. Default adapter: the AM/TSP
    policy. Returns (the trained policy, the history's mean rewards,
    `mean_length` = -reward and losses, the final baseline state)."""
    import time

    adapter = adapter or TSPAdapter(cfg, instance_sampler, device=device)
    dev = adapter.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    model = adapter.make_model()
    opt = ClippedAdam(model.parameters(), cfg.lr, max_norm=1.0)
    bl_state = baseline.init(model, adapter.sample_instances(gen))
    is_critic = isinstance(baseline, CriticBaseline)  # as in the JAX package: a wrapped critic is not trained
    history: Dict[str, list] = {"mean_length": [], "mean_reward": [], "loss": []}
    for i in range(cfg.num_steps):
        t0 = time.time()
        nodes = adapter.sample_instances(gen)
        _, logp, rewards = adapter.rollout(model, nodes, gen=gen)
        bl, bl_state = baseline.eval(bl_state, rewards.detach(), nodes)
        advantage = (rewards - bl).detach()
        loss = -torch.mean(advantage * logp)
        if cfg.ent_coef:
            loss = loss - cfg.ent_coef * torch.mean(-logp)  # -logp: a per-trajectory entropy estimate
        opt.zero_grad()
        loss.backward()
        opt.step()
        if is_critic:
            bl_state = baseline.update_critic(bl_state, rewards, nodes)
        mean_r = float(rewards.mean())
        history["mean_reward"].append(mean_r)
        history["mean_length"].append(-mean_r)
        history["loss"].append(float(loss.detach()))
        if cfg.epoch_every and (i + 1) % cfg.epoch_every == 0:
            bl_state = baseline.epoch_update(bl_state, model)
        if timings is not None:
            timings.append(time.time() - t0)
    return model, history, bl_state
