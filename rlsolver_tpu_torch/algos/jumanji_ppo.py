"""Jumanji-style A2C/PPO on the vectorized SpinSystemEnv (counterpart of
`rlsolver_tpu/algos/jumanji_ppo.py`).

An MPNN actor-critic (per-node policy logits and a pooled value) is
trained on one instance's vectorized episodes: each iteration rolls out a
fresh episode over the whole horizon, computes GAE, and runs the PPO (or
A2C) update over shuffled minibatches with `optim.ClippedAdam(max_norm=0.5)`,
which is `optax.chain(clip_by_global_norm(0.5), adam(lr))`. Parameters keep
flax's names (`MPNN_0.node_init.kernel`, `Dense_0.kernel`, ...).

Actions are drawn as JAX's `categorical` draws them, the argmax of the
masked logits plus Gumbel noise; every draw comes from a `torch.Generator`
or is injected (`PPODraws`: the reset spins, the Gumbel noise of each
step, each epoch's minibatch permutation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv, SpinSystemParams
from rlsolver_tpu_torch.models.mpnn import MPNN, Dense
from rlsolver_tpu_torch.ops.sampling import gumbel_noise
from rlsolver_tpu_torch.optim import ClippedAdam

MASKED = -1e9  # the logit of a disallowed action


class MPNNActorCritic(nn.Module):
    """MPNN trunk -> per-node logits [B, N] and a pooled value [B]."""

    def __init__(self, num_obs: int = 7, features: int = 32, n_layers: int = 2, seed: int = 0, device=None):
        super().__init__()
        self.MPNN_0 = MPNN(num_obs, features, n_layers, seed=seed, device="cpu")
        gen = torch.Generator().manual_seed(seed + 1)
        self.Dense_0 = Dense(num_obs + 2, features, gen)
        self.Dense_1 = Dense(features, 1, gen)
        self.to(resolve_device(device))

    def forward(self, obs: torch.Tensor, adj: torch.Tensor):
        logits = self.MPNN_0(obs, adj)
        pooled = torch.cat([obs.mean(dim=1), logits.mean(dim=1, keepdim=True), logits.amax(dim=1, keepdim=True)],
                           dim=-1)
        v = self.Dense_1(torch.relu(self.Dense_0(pooled)))[..., 0]
        return logits, v


@dataclasses.dataclass
class SpinPPOConfig:
    algo: str = "ppo"  # "ppo" | "a2c"
    num_iters: int = 40
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    ratio_clip: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    update_epochs: int = 4  # PPO passes over the rollout
    num_minibatches: int = 1  # chunks per epoch of the [T*B] rollout
    features: int = 32
    n_layers: int = 2
    seed: int = 0


class SpinRollout(NamedTuple):
    obs: torch.Tensor  # [T, B, N, obs]
    actions: torch.Tensor  # [T, B]
    logprobs: torch.Tensor  # [T, B]
    rewards: torch.Tensor  # [T, B]
    values: torch.Tensor  # [T, B]
    mask: torch.Tensor  # [T, B, N] allowed actions


class PPODraws(NamedTuple):
    """One iteration's draws: reset spins [B, N], Gumbel noise [T, B, N] and
    minibatch permutations [epochs, T*B]."""

    spins: torch.Tensor
    gumbel: torch.Tensor
    perms: torch.Tensor


@torch.no_grad()
def spin_rollout(net: nn.Module, env: SpinSystemEnv, pe: SpinSystemParams, generator=None,
                 draws: Optional[PPODraws] = None):
    """One episode over the horizon, actions sampled from the policy.
    -> (SpinRollout, last_value [B], best_cut 0-d tensor)."""
    dev = pe.adj.device
    state, obs = env.reset(pe, generator=generator, spins=None if draws is None else draws.spins)
    outs = []
    for t in range(env.max_steps):
        mask = env.allowed_action_mask(state)
        logits, value = net(obs, pe.adj)
        logits = torch.where(mask, logits, MASKED)
        noise = gumbel_noise(logits.shape, generator, dev) if draws is None else draws.gumbel[t].to(dev)
        actions = (noise + logits).argmax(dim=-1)
        logp = torch.log_softmax(logits, dim=-1).gather(1, actions[:, None])[:, 0]
        next_state, next_obs, rew, _ = env.step(pe, state, actions)
        outs.append((obs, actions, logp, rew, value, mask))
        state, obs = next_state, next_obs
    _, last_value = net(obs, pe.adj)
    return SpinRollout(*(torch.stack(x) for x in zip(*outs))), last_value, state.best_score.max()


def gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor, gamma: float,
        gae_lambda: float) -> torch.Tensor:
    """Generalised advantages [T, B] by a reversed loop; the episode ends at
    the horizon, so nothing is bootstrapped past it."""
    t_len = rewards.shape[0]
    advs = torch.empty_like(rewards)
    adv, next_v = torch.zeros_like(last_value), last_value
    for t in reversed(range(t_len)):
        if t == t_len - 1:
            next_v = torch.zeros_like(next_v)  # terminal cut-off
        delta = rewards[t] + gamma * next_v - values[t]
        adv = delta + gamma * gae_lambda * adv
        advs[t] = adv
        next_v = values[t]
    return advs


def ppo_loss(net: nn.Module, adj, obs, mask, actions, old_logp, advs, returns, cfg: SpinPPOConfig) -> torch.Tensor:
    logits, values = net(obs, adj)
    logits = torch.where(mask, logits, MASKED)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, actions[:, None])[:, 0]
    p = torch.softmax(logits, dim=-1)
    entropy = -torch.sum(torch.where(mask, p * logp_all, 0.0), dim=-1).mean()
    a_norm = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
    if cfg.algo == "ppo":
        ratio = torch.exp(torch.clamp(logp - old_logp, -12.0, 12.0))
        pg = -torch.minimum(a_norm * ratio, a_norm * torch.clamp(ratio, 1 - cfg.ratio_clip, 1 + cfg.ratio_clip)).mean()
    else:  # a2c
        pg = -(a_norm * logp).mean()
    v_loss = torch.mean((values - returns) ** 2)
    return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy


def ppo_update(net: nn.Module, optimizer: ClippedAdam, batch: SpinRollout, advs, returns, adj, cfg: SpinPPOConfig,
               generator=None, perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epochs of minibatch updates over one rollout; -> the mean loss."""
    dev = adj.device
    epochs = cfg.update_epochs if cfg.algo == "ppo" else 1
    tb = batch.actions.numel()
    mb = max(1, cfg.num_minibatches)
    mb_size = tb // mb
    flat = dict(obs=batch.obs.reshape((tb,) + batch.obs.shape[2:]), mask=batch.mask.reshape(tb, -1),
                actions=batch.actions.reshape(tb), old_logp=batch.logprobs.reshape(tb), advs=advs.reshape(tb),
                returns=returns.reshape(tb))
    losses = []
    for e in range(epochs):
        perm = torch.randperm(tb, generator=generator, device=dev) if perms is None else perms[e].to(dev)
        for idx in perm[: mb * mb_size].reshape(mb, mb_size):
            optimizer.zero_grad()
            loss = ppo_loss(net, adj, cfg=cfg, **{k: v[idx] for k, v in flat.items()})
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
    return torch.stack(losses).mean()


def train_spin_ppo(
    env: SpinSystemEnv,
    graph: Graph,
    cfg: SpinPPOConfig = SpinPPOConfig(),
    verbose: bool = False,
    device=None,
    params: Optional[Dict[str, torch.Tensor]] = None,
    draws: Optional[Sequence[PPODraws]] = None,
):
    """Train the MPNN actor-critic on one instance's vectorized episodes.
    `params` (a state dict) replaces the seeded initialisation; `draws`
    gives each iteration's draws instead of the generator (seeded with
    `cfg.seed`). Returns (params, history) with history['best_cut'] and
    history['loss'] per iteration."""
    dev = resolve_device(device)
    pe = env.params_from_graph(graph, device=dev)
    net = MPNNActorCritic(env.config.num_observables, cfg.features, cfg.n_layers, seed=cfg.seed, device=dev)
    if params is not None:
        net.load_state_dict(params)
    optimizer = ClippedAdam(list(net.parameters()), cfg.lr, max_norm=0.5)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    history: Dict[str, List[float]] = {"best_cut": [], "loss": []}
    for it in range(cfg.num_iters):
        d = None if draws is None else draws[it]
        batch, last_value, best_cut = spin_rollout(net, env, pe, gen, d)
        advs = gae(batch.rewards, batch.values, last_value, cfg.gamma, cfg.gae_lambda)
        loss = ppo_update(net, optimizer, batch, advs, advs + batch.values, pe.adj, cfg, gen,
                          None if d is None else d.perms)
        history["best_cut"].append(float(best_cut))
        history["loss"].append(float(loss))
        if verbose and it % 10 == 0:
            print(f"iter {it}: best_cut {history['best_cut'][-1]:.1f} loss {history['loss'][-1]:.3f}")
    return {k: v.detach().clone() for k, v in net.state_dict().items()}, history


def make_greedy_evaluator(env: SpinSystemEnv, net: MPNNActorCritic):
    """`eval_fn(params, graph, generator=None, spins=None) -> best cut` of a
    greedy rollout; `params` is a state dict of `net`, the reset drawn from
    `generator` (default: seeded 0) or the injected `spins`. The rollout's
    final env state stays in `eval_fn.last_state`."""

    @torch.no_grad()
    def eval_fn(params, graph: Graph, generator: Optional[torch.Generator] = None, spins=None) -> float:
        dev = next(net.parameters()).device
        pe = env.params_from_graph(graph, device=dev)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        state, obs = env.reset(pe, generator=gen, spins=spins)
        for _ in range(env.max_steps):
            mask = env.allowed_action_mask(state)
            logits, _ = functional_call(net, params, (obs, pe.adj))
            state, obs, _, _ = env.step(pe, state, torch.where(mask, logits, MASKED).argmax(dim=-1))
        eval_fn.last_state = state
        return float(state.best_score.max())

    eval_fn.last_state = None
    return eval_fn


@torch.no_grad()
def evaluate_spin_policy(
    env: SpinSystemEnv,
    graph: Graph,
    params=None,
    net: Optional[MPNNActorCritic] = None,
    epsilon: float = 0.0,
    seed: int = 0,
    cfg: Optional[SpinPPOConfig] = None,
    device=None,
) -> float:
    """Greedy (or epsilon-random) rollout; the best cut over the vectorized
    episode. With `params=None`, the uniform-random policy over the allowed
    actions."""
    dev = resolve_device(device)
    pe = env.params_from_graph(graph, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, obs = env.reset(pe, generator=gen)
    if net is None and params is not None:
        c = cfg or SpinPPOConfig()
        net = MPNNActorCritic(env.config.num_observables, c.features, c.n_layers, device=dev)
    for _ in range(env.max_steps):
        mask = env.allowed_action_mask(state)
        rand = torch.where(mask, gumbel_noise(mask.shape, gen, dev), MASKED).argmax(dim=-1)
        if params is None:
            actions = rand
        else:
            logits, _ = functional_call(net, params, (obs, pe.adj))
            greedy = torch.where(mask, logits, MASKED).argmax(dim=-1)
            explore = torch.rand(greedy.shape, generator=gen, device=dev) < epsilon
            actions = torch.where(explore, rand, greedy)
        state, obs, _, _ = env.step(pe, state, actions)
    return float(state.best_score.max())
