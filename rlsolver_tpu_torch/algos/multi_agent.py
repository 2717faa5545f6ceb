"""Multi-agent RL: VDN, QMIX, MAPPO and MADDPG (counterpart of the JAX
package's `algos/multi_agent.py`; ElegantRL's `AgentVDN`, `AgentQMix`,
`AgentMAPPO`, `AgentMADDPG`).

Agents are a tensor axis: the per-agent Q and actor nets are shared over
the agent axis (VDN, QMIX, MAPPO), and MADDPG's per-agent actors and
critics are stacked modules whose kernels carry a leading agent axis
([n, in, out], applied by one einsum: the JAX package's vmap). Every
module keeps flax's names and [in, out] kernels (`convert.value_mix_state_dict`,
`convert.flax_state_dict`); each update writes the state's modules and Adam
moments in place (`optim.ClippedAdam`; VDN/QMIX clip by global norm 5
first). Draws come from the agent's `torch.Generator` unless injected
(`act(..., draws=)` / `gumbel=`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from rlsolver_tpu_torch.algos.continuous import MLP, _grads, soft_update
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense, lecun_normal
from rlsolver_tpu_torch.ops.sampling import gumbel_noise
from rlsolver_tpu_torch.optim import ClippedAdam


# ------------------------------------------------------------- value mixing
class AgentQNet(nn.Module):
    """Per-agent Q network over the agent's local observation:
    [.., n_agents, obs_dim] -> [.., n_agents, A]."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = Dense(obs_dim, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, num_actions, gen)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(obs)))))


class _SmallDense(Dense):
    """flax `nn.Dense(kernel_init=normal(0.05))`."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator):
        nn.Module.__init__(self)
        self.kernel = nn.Parameter(0.05 * torch.randn(in_features, out_features, generator=gen))
        self.bias = nn.Parameter(torch.zeros(out_features))


class QMixer(nn.Module):
    """Monotonic mixer: weights |hypernet(state)|, ELU hidden (QMIX). The
    hypernet kernels start at N(0, 0.05) so that the mixed Q starts small."""

    def __init__(self, n_agents: int, state_dim: int, embed: int = 32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.n_agents, self.embed = n_agents, embed
        self.hw1 = _SmallDense(state_dim, n_agents * embed, gen)
        self.hb1 = _SmallDense(state_dim, embed, gen)
        self.hw2 = _SmallDense(state_dim, embed, gen)
        self.hb2h = _SmallDense(state_dim, embed, gen)
        self.hb2 = _SmallDense(embed, 1, gen)

    def forward(self, agent_qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """agent_qs [B, n]; state [B, S] -> joint Q [B]."""
        w1 = torch.abs(self.hw1(state)).reshape(-1, self.n_agents, self.embed)
        h = torch.nn.functional.elu(torch.einsum("bn,bne->be", agent_qs, w1) + self.hb1(state))
        w2 = torch.abs(self.hw2(state))
        b2 = self.hb2(torch.relu(self.hb2h(state)))
        return torch.einsum("be,be->b", h, w2) + b2[..., 0]


@dataclasses.dataclass
class MixConfig:
    n_agents: int = 3
    obs_dim: int = 4
    state_dim: int = 12
    num_actions: int = 5
    gamma: float = 0.95
    lr: float = 5e-4
    tau: float = 0.01
    seed: int = 0


class MixParams(nn.Module):
    """{"q": AgentQNet, "mix": QMixer (QMIX only)}, flax's tree as one module."""

    def __init__(self, q: AgentQNet, mix: Optional[QMixer]):
        super().__init__()
        self.q = q
        if mix is not None:
            self.mix = mix


@dataclasses.dataclass
class MixState:
    params: MixParams
    target: MixParams
    opt_state: ClippedAdam


class MixDraws(NamedTuple):
    """An act's draws [B, n]: random actions and whether each replaces the
    greedy one. JAX draws both from one key."""

    rand: torch.Tensor
    explore: torch.Tensor


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    """optax's `huber_loss`: 0.5 min(|e|, d)^2 + d (|e| - min(|e|, d))."""
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad ** 2 + delta * (err - quad)


class ValueMixAgent:
    """VDN (`mixer="sum"`) and QMIX (`mixer="qmix"`): a double-DQN target
    through the mixer, Huber loss (delta 10), clip by global norm 5, Adam,
    soft target updates; on the card unless `device="cpu"`."""

    def __init__(self, mixer: str, cfg: MixConfig = MixConfig(), device=None):
        assert mixer in ("sum", "qmix")
        self.mixer, self.cfg = mixer, cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)

    def init(self) -> MixState:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        q = AgentQNet(cfg.obs_dim, cfg.num_actions, gen=gen)
        mix = QMixer(cfg.n_agents, cfg.state_dim, gen=gen) if self.mixer == "qmix" else None
        params = MixParams(q, mix).to(self.device)
        return MixState(params, copy.deepcopy(params), ClippedAdam(params.parameters(), cfg.lr, max_norm=5.0))

    def q_values(self, params: MixParams, obs: torch.Tensor) -> torch.Tensor:
        return params.q(obs)  # [B, n, A]

    @torch.no_grad()
    def act(self, state: MixState, obs: torch.Tensor, epsilon: float = 0.05,
            draws: Optional[MixDraws] = None) -> torch.Tensor:
        greedy = torch.argmax(self.q_values(state.params, obs), dim=-1)
        if draws is None:
            draws = MixDraws(torch.randint(0, self.cfg.num_actions, greedy.shape, generator=self.generator,
                                           device=self.device),
                             torch.rand(greedy.shape, generator=self.generator, device=self.device) < epsilon)
        return torch.where(draws.explore.to(self.device), draws.rand.to(self.device), greedy)

    def _joint(self, params: MixParams, obs, actions, state_global) -> torch.Tensor:
        chosen = torch.gather(self.q_values(params, obs), -1, actions[..., None])[..., 0]  # [B, n]
        if self.mixer == "sum":
            return chosen.sum(dim=-1)
        return params.mix(chosen, state_global)

    def make_update(self):
        """update(st, obs, actions, reward, next_obs, done, state_g,
        next_state_g) -> (st, loss 0-d)."""
        cfg = self.cfg

        def update(st: MixState, obs, actions, reward, next_obs, done, state_g, next_state_g):
            with torch.no_grad():  # double-DQN target: argmax online, evaluate target
                a_star = torch.argmax(self.q_values(st.params, next_obs), dim=-1)
                y = reward + cfg.gamma * (1.0 - done) * self._joint(st.target, next_obs, a_star, next_state_g)
            loss = huber(self._joint(st.params, obs, actions, state_g), y, 10.0).mean()
            _grads(loss, st.params.parameters())
            st.opt_state.step()
            soft_update(st.target, st.params, cfg.tau)
            return st, loss.detach()

        return update


# ----------------------------------------------------------------- MAPPO
@dataclasses.dataclass
class MappoConfig:
    n_agents: int = 3
    obs_dim: int = 4
    state_dim: int = 12
    num_actions: int = 5
    gamma: float = 0.95
    gae_lambda: float = 0.95
    clip: float = 0.2
    ent_coef: float = 0.01
    lr: float = 5e-4
    seed: int = 0


@dataclasses.dataclass
class MappoState:
    actor: AgentQNet
    critic: MLP
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam


class MappoAgent:
    """A shared-parameter actor over each agent's observation and a
    centralised critic over the global state (MAPPO): clipped ratio of the
    joint log-prob, entropy bonus, normalised advantages; on the card unless
    `device="cpu"`."""

    def __init__(self, cfg: MappoConfig = MappoConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)

    def init(self) -> MappoState:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        actor = AgentQNet(cfg.obs_dim, cfg.num_actions, gen=gen).to(self.device)  # logits head
        critic = MLP(cfg.state_dim, 1, gen=gen).to(self.device)
        return MappoState(actor, critic, ClippedAdam(actor.parameters(), cfg.lr, max_norm=None),
                          ClippedAdam(critic.parameters(), cfg.lr, max_norm=None))

    @torch.no_grad()
    def act(self, st: MappoState, obs: torch.Tensor, gumbel: Optional[torch.Tensor] = None):
        """(actions [B, n], joint log-prob [B]): argmax of logits + Gumbel
        noise (drawn from the agent's generator unless given)."""
        logits = st.actor(obs)
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, self.generator, self.device)
        actions = torch.argmax(logits + gumbel.to(self.device), dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        return actions, torch.gather(logp, -1, actions[..., None])[..., 0].sum(dim=-1)

    @torch.no_grad()
    def value(self, st: MappoState, state_g: torch.Tensor) -> torch.Tensor:
        return st.critic(state_g)[..., 0]

    def make_update(self):
        """update(st, obs, actions, old_logp, adv, returns, state_g) -> (st,
        {"actor_loss", "critic_loss"} as 0-d tensors)."""
        cfg = self.cfg

        def update(st: MappoState, obs, actions, old_logp, adv, returns, state_g):
            adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            logp_all = torch.log_softmax(st.actor(obs), dim=-1)
            logp = torch.gather(logp_all, -1, actions[..., None])[..., 0].sum(dim=-1)
            ratio = torch.exp(logp - old_logp)
            s1 = ratio * adv_n
            s2 = torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_n
            ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
            al = -torch.minimum(s1, s2).mean() - cfg.ent_coef * ent
            cl = ((st.critic(state_g)[..., 0] - returns) ** 2).mean()
            _grads(al, st.actor.parameters())
            _grads(cl, st.critic.parameters())
            st.actor_opt.step()
            st.critic_opt.step()
            return st, {"actor_loss": al.detach(), "critic_loss": cl.detach()}

        return update


# ---------------------------------------------------------------- MADDPG
@dataclasses.dataclass
class MaddpgConfig:
    n_agents: int = 2
    obs_dim: int = 4
    act_dim: int = 2
    max_action: float = 1.0
    gamma: float = 0.95
    tau: float = 0.01
    lr: float = 1e-3
    seed: int = 0


class _StackedDense(nn.Module):
    """n flax Denses stacked: kernel [n, in, out], bias [n, out]."""

    def __init__(self, n: int, in_features: int, out_features: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch.stack([lecun_normal((in_features, out_features), in_features, gen)
                                                for _ in range(n)]))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, B, in] (or [B, in], shared by the n) -> [n, B, out]."""
        eq = "nbi,nio->nbo" if x.dim() == 3 else "bi,nio->nbo"
        return torch.einsum(eq, x, self.kernel) + self.bias[:, None, :]


class StackedMLP(nn.Module):
    """`continuous.MLP` for each of n agents, the agent axis leading every
    kernel (the JAX package's vmapped init and apply)."""

    def __init__(self, n: int, in_dim: int, out_dim: int, hidden: int = 256, out_scale: float = 1.0,
                 tanh_out: bool = False, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = _StackedDense(n, in_dim, hidden, gen)
        self.Dense_1 = _StackedDense(n, hidden, hidden, gen)
        self.Dense_2 = _StackedDense(n, hidden, out_dim, gen)
        self.out_scale, self.tanh_out = out_scale, tanh_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(x)))))
        return torch.tanh(x) * self.out_scale if self.tanh_out else x


@dataclasses.dataclass
class MaddpgState:
    actors: StackedMLP  # per-agent params, leading axis n_agents
    actors_target: StackedMLP
    critics: StackedMLP
    critics_target: StackedMLP
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam


def _joint_feat(obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    b = obs.shape[0]
    return torch.cat([obs.reshape(b, -1), act.reshape(b, -1)], dim=1)


class MaddpgAgent:
    """Per-agent deterministic actors and per-agent centralised critics over
    (all obs, all actions); on the card unless `device="cpu"`."""

    def __init__(self, cfg: MaddpgConfig = MaddpgConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self) -> MaddpgState:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        actors = StackedMLP(cfg.n_agents, cfg.obs_dim, cfg.act_dim, out_scale=cfg.max_action, tanh_out=True,
                            gen=gen).to(self.device)
        critics = StackedMLP(cfg.n_agents, cfg.n_agents * (cfg.obs_dim + cfg.act_dim), 1, gen=gen).to(self.device)
        return MaddpgState(actors, copy.deepcopy(actors), critics, copy.deepcopy(critics),
                           ClippedAdam(actors.parameters(), cfg.lr, max_norm=None),
                           ClippedAdam(critics.parameters(), cfg.lr, max_norm=None))

    @staticmethod
    def _apply_actors(actors: StackedMLP, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n, O] -> actions [B, n, A] (each agent its own actor)."""
        return actors(obs.transpose(0, 1)).transpose(0, 1)

    @torch.no_grad()
    def act(self, st: MaddpgState, obs: torch.Tensor) -> torch.Tensor:
        return self._apply_actors(st.actors, obs)

    def make_update(self):
        """update(st, obs, act, reward, next_obs, done) -> (st, {"critic_loss",
        "actor_loss"}); obs/next_obs [B, n, O], act [B, n, A], reward [B, n]."""
        cfg = self.cfg

        def update(st: MaddpgState, obs, act, reward, next_obs, done):
            with torch.no_grad():
                next_act = self._apply_actors(st.actors_target, next_obs)
                q_next = st.critics_target(_joint_feat(next_obs, next_act))[..., 0].transpose(0, 1)  # [B, n]
                y = reward + cfg.gamma * (1.0 - done[:, None]) * q_next
            q = st.critics(_joint_feat(obs, act))[..., 0].transpose(0, 1)
            cl = ((q - y) ** 2).mean()
            _grads(cl, st.critics.parameters())
            st.critic_opt.step()
            my_act = self._apply_actors(st.actors, obs)
            al = -st.critics(_joint_feat(obs, my_act))[..., 0].mean()
            _grads(al, st.actors.parameters())
            st.actor_opt.step()
            soft_update(st.actors_target, st.actors, cfg.tau)
            soft_update(st.critics_target, st.critics, cfg.tau)
            return st, {"critic_loss": cl.detach(), "actor_loss": al.detach()}

        return update
