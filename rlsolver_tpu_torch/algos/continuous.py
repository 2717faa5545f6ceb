"""Continuous-control agents DDPG, TD3 and SAC, and EmbedDQN (counterpart of
the JAX package's `algos/continuous.py`; ElegantRL's `AgentDDPG`,
`AgentTD3`, `AgentSAC` and `AgentEmbedDQN`).

One off-policy skeleton: a replay ring on the card (`Replay`), the networks
as modules with flax's names and [in, out] kernels (so that a flax tree
converts by joining its keys, `convert.flax_state_dict`), one update step
per agent that writes the state's modules and Adam moments in place
(optax's `adam` as `optim.ClippedAdam(max_norm=None)`, which counts a
missing gradient as zero: TD3's delayed actor step feeds Adam zeros, as the
JAX package does), Polyak target updates (`soft_update`). The caller's loop
does the exploration.

Every draw comes from the agent's `torch.Generator` unless the caller
injects it (`OffPolicyDraws`, `act(..., noise=)`, `replay_sample(...,
idx=)`, `EmbedDQNAgent.act(..., draws=)`): JAX's threefry draws are not
Philox's, so the CPU tests pass JAX's draws in.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense
from rlsolver_tpu_torch.optim import ClippedAdam


# ----------------------------------------------------------- replay buffer
class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor


class Replay(NamedTuple):
    """A ring of `capacity` transitions on the card; `ptr` and `size` are
    host ints."""

    data: Transition
    ptr: int
    size: int

    @staticmethod
    def create(capacity: int, obs_dim: int, act_dim: int, device=None) -> "Replay":
        dev = resolve_device(device)
        z = lambda *shape: torch.zeros(shape, device=dev)
        data = Transition(z(capacity, obs_dim), z(capacity, act_dim), z(capacity), z(capacity, obs_dim), z(capacity))
        return Replay(data, 0, 0)


def replay_add(buf: Replay, tr: Transition) -> Replay:
    """Writes one transition (a 0-d reward) or a batch of K (rewards [K]) in
    place at `ptr`, as K single adds would, and returns the moved ring."""
    cap = buf.data.reward.shape[0]
    if tr.reward.dim() == 0:
        for d, x in zip(buf.data, tr):
            d[buf.ptr] = x
        return Replay(buf.data, (buf.ptr + 1) % cap, min(buf.size + 1, cap))
    k = tr.reward.shape[0]
    keep = min(k, cap)  # of more than `cap` rows, the last `cap` survive
    rows = (buf.ptr + k - keep + torch.arange(keep, device=buf.data.reward.device)) % cap
    for d, x in zip(buf.data, tr):
        d[rows] = x[k - keep:].to(d.dtype)
    return Replay(buf.data, (buf.ptr + k) % cap, min(buf.size + k, cap))


def replay_sample(buf: Replay, batch: int, generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None) -> Transition:
    """`batch` rows drawn uniformly from the filled part (indices from
    `generator` unless `idx` gives them)."""
    dev = buf.data.reward.device
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch,), generator=generator, device=dev)
    idx = idx.to(dev)
    return Transition(*(d[idx] for d in buf.data))


# ------------------------------------------------------------------ models
class MLP(nn.Module):
    """relu(Dense_0) -> relu(Dense_1) -> Dense_2 over the inputs joined on
    the last axis, then tanh * out_scale if `tanh_out`."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 256, out_scale: float = 1.0, tanh_out: bool = False,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = Dense(in_dim, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, out_dim, gen)
        self.out_scale, self.tanh_out = out_scale, tanh_out

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
        x = self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(x)))))
        return torch.tanh(x) * self.out_scale if self.tanh_out else x


Params = Union[nn.Module, Dict[str, torch.Tensor], torch.Tensor]


@torch.no_grad()
def soft_update(target: Params, online: Params, tau: float) -> Params:
    """Polyak averaging t (1 - tau) + o tau (`AgentBase.soft_update`): a
    module's parameters are written in place (and the module returned); a
    dict of tensors or a tensor gives a new one."""
    if isinstance(target, nn.Module):
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_(t * (1.0 - tau) + o * tau)
        return target
    if isinstance(target, dict):
        return {k: soft_update(v, online[k], tau) for k, v in target.items()}
    return target * (1.0 - tau) + online * tau


@dataclasses.dataclass
class OffPolicyConfig:
    obs_dim: int = 4
    act_dim: int = 2
    max_action: float = 1.0
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    batch: int = 128
    capacity: int = 100_000
    # TD3
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    # SAC
    init_alpha: float = 0.1
    seed: int = 0


class _TwinCritic(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.q1 = MLP(obs_dim + act_dim, 1, hidden, gen=gen)
        self.q2 = MLP(obs_dim + act_dim, 1, hidden, gen=gen)

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        return self.q1(obs, act)[..., 0], self.q2(obs, act)[..., 0]


class _GaussianActor(nn.Module):
    """Dense_0, Dense_1 (relu), then the `mu` and `log_std` heads (log_std
    clipped to [-10, 2])."""

    def __init__(self, obs_dim: int, act_dim: int, max_action: float, hidden: int = 256,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = Dense(obs_dim, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.mu = Dense(hidden, act_dim, gen)
        self.log_std = Dense(hidden, act_dim, gen)
        self.max_action = max_action

    def forward(self, obs: torch.Tensor):
        x = torch.relu(self.Dense_1(torch.relu(self.Dense_0(obs))))
        return self.mu(x), torch.clamp(self.log_std(x), -10.0, 2.0)

    def sample(self, obs: torch.Tensor, eps: torch.Tensor):
        """(tanh-squashed action, its log-prob) for unit-normal draws `eps`
        shaped like the action."""
        mu, log_std = self(obs)
        pre = mu + torch.exp(log_std) * eps
        t = torch.tanh(pre)
        logp = (-0.5 * (eps ** 2 + 2.0 * log_std + math.log(2.0 * math.pi)).sum(-1)
                - torch.log(1.0 - t ** 2 + 1e-6).sum(-1))
        return t * self.max_action, logp


@dataclasses.dataclass
class OffPolicyState:
    """The modules and optimizers one update writes in place."""

    actor: nn.Module
    actor_target: nn.Module
    critic: _TwinCritic
    critic_target: _TwinCritic
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    log_alpha: torch.Tensor  # f32 0-d, a leaf that requires grad
    alpha_opt: ClippedAdam
    step: int


class OffPolicyDraws(NamedTuple):
    """An update's unit normals [B, act_dim]: `target` for the critic's
    target (SAC's next-action sample, TD3's smoothing noise; unused by
    DDPG), `actor` for SAC's actor-loss sample."""

    target: Optional[torch.Tensor] = None
    actor: Optional[torch.Tensor] = None


def _grads(loss: torch.Tensor, params) -> None:
    params = list(params)
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g


class OffPolicyAgent:
    """Shared DDPG / TD3 / SAC implementation, selected by `algo`; on the
    card unless `device="cpu"`."""

    def __init__(self, algo: str, cfg: OffPolicyConfig = OffPolicyConfig(), device=None):
        assert algo in ("ddpg", "td3", "sac")
        self.algo, self.cfg = algo, cfg
        self.device = resolve_device(device)
        self.target_entropy = -float(cfg.act_dim)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)

    def init(self) -> OffPolicyState:
        """Fresh networks (flax's initialisers from a CPU generator seeded
        with `cfg.seed`), their targets as copies, zeroed Adams."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        if self.algo == "sac":
            actor = _GaussianActor(cfg.obs_dim, cfg.act_dim, cfg.max_action, gen=gen)
        else:
            actor = MLP(cfg.obs_dim, cfg.act_dim, out_scale=cfg.max_action, tanh_out=True, gen=gen)
        critic = _TwinCritic(cfg.obs_dim, cfg.act_dim, gen=gen)
        actor, critic = actor.to(self.device), critic.to(self.device)
        log_alpha = torch.tensor(np.log(cfg.init_alpha), dtype=torch.float32, device=self.device).requires_grad_()
        return OffPolicyState(actor, copy.deepcopy(actor), critic, copy.deepcopy(critic),
                              ClippedAdam(actor.parameters(), cfg.lr, max_norm=None),
                              ClippedAdam(critic.parameters(), cfg.lr, max_norm=None),
                              log_alpha, ClippedAdam([log_alpha], cfg.lr, max_norm=None), 0)

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    @torch.no_grad()
    def act(self, state: OffPolicyState, obs: torch.Tensor, generator: Optional[torch.Generator] = None,
            explore_std: float = 0.1, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SAC: an action sampled with `noise` (unit normals), else drawn
        from `generator`, else from a fresh generator seeded 0 (the JAX
        package's PRNGKey(0)). DDPG/TD3: the deterministic action, plus
        `noise` (or `generator`'s normals) x explore_std x max_action and
        clipped, when either is given and explore_std > 0."""
        shape = (obs.shape[0], self.cfg.act_dim)
        if self.algo == "sac":
            if noise is None:
                gen = generator if generator is not None else torch.Generator(self.device).manual_seed(0)
                noise = torch.randn(shape, generator=gen, device=self.device)
            return state.actor.sample(obs, noise.to(self.device))[0]
        a = state.actor(obs)
        if (noise is not None or generator is not None) and explore_std > 0:
            if noise is None:
                noise = torch.randn(shape, generator=generator, device=self.device)
            a = torch.clamp(a + noise.to(self.device) * explore_std * self.cfg.max_action,
                            -self.cfg.max_action, self.cfg.max_action)
        return a

    def make_update(self):
        """update(state, batch, draws=None) -> (state, {"critic_loss",
        "actor_loss"} as 0-d tensors): one critic step, one actor step (TD3:
        a zero gradient off its delay), SAC's temperature step, then the
        targets' soft updates."""
        cfg, algo = self.cfg, self.algo

        def critic_targets(state: OffPolicyState, batch: Transition, eps: Optional[torch.Tensor]):
            with torch.no_grad():
                if algo == "sac":
                    next_a, next_logp = state.actor.sample(batch.next_obs, eps)
                    tq1, tq2 = state.critic_target(batch.next_obs, next_a)
                    tq = torch.minimum(tq1, tq2) - torch.exp(state.log_alpha) * next_logp
                else:
                    next_a = state.actor_target(batch.next_obs)
                    if algo == "td3":
                        noise = torch.clamp(eps * cfg.target_noise, -cfg.noise_clip, cfg.noise_clip)
                        next_a = torch.clamp(next_a + noise, -cfg.max_action, cfg.max_action)
                    tq1, tq2 = state.critic_target(batch.next_obs, next_a)
                    tq = torch.minimum(tq1, tq2) if algo == "td3" else tq1
                return batch.reward + cfg.gamma * (1.0 - batch.done) * tq

        def update(state: OffPolicyState, batch: Transition, draws: Optional[OffPolicyDraws] = None):
            draws = draws if draws is not None else OffPolicyDraws()
            shape = (batch.reward.shape[0], cfg.act_dim)
            eps_t, eps_a = draws.target, draws.actor
            if eps_t is None and algo != "ddpg":
                eps_t = self._normal(shape)
            if eps_a is None and algo == "sac":
                eps_a = self._normal(shape)
            y = critic_targets(state, batch, eps_t)

            q1, q2 = state.critic(batch.obs, batch.action)
            closs = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()
            _grads(closs, state.critic.parameters())
            state.critic_opt.step()

            if algo == "sac":
                a, logp = state.actor.sample(batch.obs, eps_a)
                q1, q2 = state.critic(batch.obs, a)
                aloss = (torch.exp(state.log_alpha).detach() * logp - torch.minimum(q1, q2)).mean()
            else:
                q1, _ = state.critic(batch.obs, state.actor(batch.obs))
                aloss = -q1.mean()
            if algo != "td3" or state.step % cfg.policy_delay == 0:
                _grads(aloss, state.actor.parameters())
            else:
                state.actor_opt.zero_grad()  # Adam sees a zero gradient
            state.actor_opt.step()

            if algo == "sac":
                alpha_loss = -(state.log_alpha * (logp.detach() + self.target_entropy)).mean()
                _grads(alpha_loss, [state.log_alpha])
                state.alpha_opt.step()
            soft_update(state.actor_target, state.actor, cfg.tau)
            soft_update(state.critic_target, state.critic, cfg.tau)
            state.step += 1
            return state, {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}

        return update


# ------------------------------------------------------------- EmbedDQN
class QEmbedTwin(nn.Module):
    """ElegantRL's embedded-action Q network (`AgentEmbedDQN.py:106-186`):
    Q(s, a) from the state joined with a learned embedding of the discrete
    action (`Embed_0`, width max(8, sqrt(action_dim)), orthogonal init x
    0.5), with `num_ensembles` heads: [..., num_ensembles]."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 128, num_ensembles: int = 2,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        emb_dim = max(8, int(action_dim ** 0.5))
        self.Embed_0 = nn.Module()
        self.Embed_0.embedding = nn.Parameter(nn.init.orthogonal_(torch.empty(action_dim, emb_dim), 0.5,
                                                                  generator=gen))
        self.Dense_0 = Dense(obs_dim + emb_dim, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, num_ensembles, gen)

    def forward(self, obs: torch.Tensor, action_int: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, self.Embed_0.embedding[action_int]], dim=-1)
        return self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(x)))))


@dataclasses.dataclass
class EmbedDQNConfig:
    obs_dim: int = 4
    action_dim: int = 4
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 1e-3
    batch: int = 128
    capacity: int = 20_000
    explore_rate: float = 0.25  # reference AgentEmbedDQN.explore_rate
    seed: int = 0


@dataclasses.dataclass
class EmbedDQNState:
    params: QEmbedTwin
    target: QEmbedTwin
    opt_state: ClippedAdam
    step: int


class EmbedDraws(NamedTuple):
    """An exploring act's draws: random actions int [B] and one uniform
    (0-d) that decides, for the whole batch, whether they replace the
    greedy ones."""

    rand: torch.Tensor
    u: torch.Tensor


class EmbedDQNAgent:
    """`AgentEmbedDQN` (`AgentEmbedDQN.py:14-71`): epsilon-greedy over the
    all-action Q scores, TD target r + gamma (1 - done) max_a of the target
    net's mean-ensemble Q, MSE of the taken action's heads against it,
    Polyak target updates; on the card unless `device="cpu"`."""

    def __init__(self, cfg: EmbedDQNConfig = EmbedDQNConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)

    def init(self) -> EmbedDQNState:
        gen = torch.Generator().manual_seed(self.cfg.seed)
        net = QEmbedTwin(self.cfg.obs_dim, self.cfg.action_dim, gen=gen).to(self.device)
        return EmbedDQNState(net, copy.deepcopy(net), ClippedAdam(net.parameters(), self.cfg.lr, max_norm=None), 0)

    def q_all(self, net: QEmbedTwin, obs: torch.Tensor) -> torch.Tensor:
        """Mean-ensemble Q for every action: [B, action_dim]."""
        a = self.cfg.action_dim
        acts = torch.arange(a, device=obs.device)
        obs_t = obs[:, None, :].expand(obs.shape[0], a, obs.shape[1])
        return net(obs_t, acts[None, :].expand(obs.shape[0], a)).mean(dim=-1)

    @torch.no_grad()
    def act(self, state: EmbedDQNState, obs: torch.Tensor, explore: bool = True,
            draws: Optional[EmbedDraws] = None) -> torch.Tensor:
        """Epsilon-greedy action ints [B] (`QEmbedBase.get_action`)."""
        greedy = torch.argmax(self.q_all(state.params, obs), dim=1)
        if not explore:
            return greedy
        if draws is None:
            draws = EmbedDraws(torch.randint(0, self.cfg.action_dim, greedy.shape, generator=self.generator,
                                             device=self.device),
                               torch.rand((), generator=self.generator, device=self.device))
        return torch.where(draws.u.to(self.device) < self.cfg.explore_rate, draws.rand.to(self.device), greedy)

    def make_update(self):
        """update(state, batch) -> (state, loss 0-d): one Adam step on the MSE
        of the taken action's heads, then the target's soft update."""
        cfg = self.cfg

        def update(state: EmbedDQNState, batch: Transition):
            action_int = batch.action.long()[:, 0]
            with torch.no_grad():
                next_q = self.q_all(state.target, batch.next_obs).max(dim=1).values
                y = batch.reward + cfg.gamma * (1.0 - batch.done) * next_q
            loss = ((state.params(batch.obs, action_int) - y[:, None]) ** 2).mean()
            _grads(loss, state.params.parameters())
            state.opt_state.step()
            soft_update(state.target, state.params, cfg.tau)
            state.step += 1
            return state, loss.detach()

        return update
