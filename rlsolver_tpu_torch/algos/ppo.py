"""PPO and A2C on the vectorized flip MDP (counterpart of
`rlsolver_tpu/algos/ppo.py`; RLSolver `methods/PPO.py:1-213`, CleanRL-style:
GAE, a clipped surrogate with value clipping, an entropy bonus, an annealed
learning rate and minibatch epochs, with a 2 x 128 Tanh MLP actor-critic).

One iteration (`make_ppo_iteration`): a rollout of `horizon` steps, actions
drawn as argmax(logits + Gumbel noise) (JAX's `categorical`); GAE over the
horizon with the env's `done`s; then `update_epochs` epochs, each a random
permutation of the T * B transitions cut into `num_minibatches`
minibatches, each one step of clip_by_global_norm(max_grad_norm) and Adam
(eps 1e-5, step size annealed linearly to 0 over every update of the run).
The Gumbel draws and the permutations come from the generator unless the
caller injects them (`PPODraws`).

The data-parallel form (`make_ppo_iteration(..., group=)`,
`train_ppo(..., mesh=)`, also named `train_ppo_sharded`; S2V_PPO's DDP,
`S2V_PPO/train_ddp.py:16-258`) shards the envs over the ranks of a
`parallel` mesh and keeps the model and its Adam replicated. Each rank draws its own rollout noise (the state's
`shard_generator`, JAX's `fold_in` of the shard index); the permutations
stay replicated (the JAX package folds only the rollout key), so every rank
cuts its own batch by the same permutation. In every minibatch the
advantages' mean and variance and the gradients are `pmean`'d (one flat
all-reduce, before the clip), and the metrics are `pmean`'d, the best cut
`pmax`'d.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional

import torch
from torch import nn

from rlsolver_tpu_torch.core.encode import SolutionCodec
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.flip_mdp import FlipMdpEnv, FlipMdpState
from rlsolver_tpu_torch.models.transformer import Dense
from rlsolver_tpu_torch.ops.sampling import gumbel_noise
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.parallel import mesh as mesh_lib


class MLPActorCritic(nn.Module):
    """2 x `hidden` Tanh actor and critic trunks over the bits (`PPO.py:54-80`),
    with flax's names (`actor0`, `actor1`, `actor_out`, `critic0`, ...) and
    [in, out] kernels, initialised as flax does from a seeded CPU generator."""

    def __init__(self, num_nodes: int, hidden: int = 128, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        for name in ("actor", "critic"):
            setattr(self, f"{name}0", Dense(num_nodes, hidden, gen))
            setattr(self, f"{name}1", Dense(hidden, hidden, gen))
        self.actor_out = Dense(hidden, num_nodes, gen)
        self.critic_out = Dense(hidden, 1, gen)
        if device is not None:
            self.to(device)

    def forward(self, obs: torch.Tensor):
        a = torch.tanh(self.actor1(torch.tanh(self.actor0(obs))))
        c = torch.tanh(self.critic1(torch.tanh(self.critic0(obs))))
        return self.actor_out(a), self.critic_out(c)[..., 0]


@dataclasses.dataclass
class PPOConfig:
    num_envs: int = 128
    horizon: int = 64  # steps per rollout (= episode length, `PPO.py:24`)
    num_iterations: int = 100
    num_minibatches: int = 4
    update_epochs: int = 4
    lr: float = 2.5e-4
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    norm_adv: bool = True
    clip_coef: float = 0.2
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    seed: int = 0
    start_str: Optional[str] = None  # base64 warm-start solution (`PPO.py:19-21`)


class PPOTrainState(NamedTuple):
    model: MLPActorCritic
    optimizer: ClippedAdam
    env_state: FlipMdpState
    obs: torch.Tensor
    generator: torch.Generator
    iteration: int
    shard_generator: Optional[torch.Generator] = None  # a rank's own rollout draws, when sharded


class PPODraws(NamedTuple):
    """An iteration's draws: Gumbel noise f32 [T, B, N] of the rollout's
    actions and the epochs' permutations int [E, T * B] (a rank's own B
    envs, when sharded)."""

    gumbel: torch.Tensor
    perms: torch.Tensor


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, last_value: torch.Tensor,
        gamma: float, lam: float) -> torch.Tensor:
    """Generalised advantages [T, B] by the reversed recursion of `PPO.py`,
    bootstrapping through non-terminal steps. rewards/values/dones [T, B]."""
    advs = torch.empty_like(rewards)
    adv_next, value_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * value_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        advs[t] = adv_next
        value_next = values[t]
    return advs


def make_optimizer(model: MLPActorCritic, cfg: PPOConfig) -> ClippedAdam:
    """clip_by_global_norm(max_grad_norm), then Adam(eps 1e-5) with the step
    size annealed over all num_iterations x epochs x minibatches updates."""
    steps = cfg.num_iterations * cfg.update_epochs * cfg.num_minibatches if cfg.anneal_lr else None
    return ClippedAdam(model.parameters(), cfg.lr, max_norm=cfg.max_grad_norm, eps=1e-5, schedule_steps=steps)


def make_ppo_iteration(env: FlipMdpEnv, cfg: PPOConfig, group=None):
    """iteration(state, draws=None) -> (state, metrics): one PPO iteration
    (see the module doc), the model and its Adam updated in place. metrics:
    loss (mean over the minibatches), mean_cut and best_cut of the envs
    after the rollout, mean_reward (0-d tensors). `group` (a `parallel`
    mesh or process group) makes it the data-parallel iteration."""

    def pmean(x):
        return mesh_lib.pmean(x, group)

    def loss_fn(model, obs_b, act_b, logp_b, adv_b, ret_b, val_b):
        logits, value = model(obs_b)
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, act_b[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).mean()
        ratio = torch.exp(logp - logp_b)
        pg1 = -adv_b * ratio
        pg2 = -adv_b * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
        pg_loss = torch.maximum(pg1, pg2).mean()
        if cfg.clip_vloss:
            v_clip = val_b + torch.clamp(value - val_b, -cfg.clip_coef, cfg.clip_coef)
            v_loss = 0.5 * torch.maximum((value - ret_b) ** 2, (v_clip - ret_b) ** 2).mean()
        else:
            v_loss = 0.5 * ((value - ret_b) ** 2).mean()
        return pg_loss - cfg.ent_coef * entropy + cfg.vf_coef * v_loss

    def iteration(state: PPOTrainState, draws: Optional[PPODraws] = None):
        model, optimizer, gen = state.model, state.optimizer, state.generator
        roll_gen = state.shard_generator or gen
        env_state, obs = state.env_state, state.obs
        dev = obs.device
        outs = []
        with torch.no_grad():
            for t in range(cfg.horizon):
                logits, value = model(obs)
                noise = gumbel_noise(logits.shape, roll_gen, dev) if draws is None else draws.gumbel[t].to(dev)
                action = (noise + logits).argmax(dim=-1)
                logprob = torch.log_softmax(logits, dim=-1).gather(1, action[:, None])[:, 0]
                env_state, next_obs, reward, done = env.step(env_state, action)
                outs.append((obs, action, logprob, value, reward, done))
                obs = next_obs
            obss, actions, logprobs, values, rewards, dones = (torch.stack(x) for x in zip(*outs))
            _, last_value = model(obs)
            advs = gae(rewards, values, dones, last_value, cfg.gamma, cfg.gae_lambda)
            returns = advs + values
        batch = tuple(x.reshape((-1,) + x.shape[2:]) for x in (obss, actions, logprobs, advs, returns, values))
        batch_size = cfg.horizon * obss.shape[1]
        mb_size = batch_size // cfg.num_minibatches

        losses = []
        for e in range(cfg.update_epochs):
            perm = torch.randperm(batch_size, generator=gen, device=dev) if draws is None else draws.perms[e].to(dev)
            idxs = perm[: mb_size * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_size).long()
            for idx in idxs:
                obs_b, act_b, logp_b, adv_b, ret_b, val_b = (x[idx] for x in batch)
                if cfg.norm_adv:
                    mean = pmean(adv_b.mean())
                    var = pmean(torch.mean((adv_b - mean) ** 2))
                    adv_b = (adv_b - mean) / (torch.sqrt(var) + 1e-8)
                loss = loss_fn(model, obs_b, act_b, logp_b, adv_b, ret_b, val_b)
                optimizer.zero_grad()
                loss.backward()
                mesh_lib.pmean_grads(optimizer.params, group)  # DDP's gradient all-reduce
                optimizer.step()
                losses.append(loss.detach())
        metrics = {
            "loss": pmean(torch.stack(losses).reshape(cfg.update_epochs, -1).mean(dim=1).mean()),
            "mean_cut": pmean(env_state.cut.mean()),
            "best_cut": mesh_lib.pmax(env_state.cut.max(), group),
            "mean_reward": pmean(rewards.mean()),
        }
        return state._replace(env_state=env_state, obs=obs, iteration=state.iteration + 1), metrics

    return iteration


def init_ppo_state(env: FlipMdpEnv, cfg: PPOConfig, num_envs: int, model: Optional[MLPActorCritic] = None,
                   xs: Optional[torch.Tensor] = None, group=None) -> PPOTrainState:
    """The env reset (from `cfg.start_str` where given, else random bits
    from the generator or the injected `xs`), a fresh model (or `model`) and
    its optimizer, the generator seeded with cfg.seed. With `group` the
    reset draws all `num_envs` envs, every rank takes rank 0's bits and
    model (a broadcast) and keeps its own envs (`xs`, where injected, is
    already the rank's), and gets a generator of its own rollout draws."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(cfg.seed)
    start_bits = None
    if cfg.start_str is not None:
        start_bits = SolutionCodec(env.num_nodes).str_to_bits(cfg.start_str)
    if xs is None and start_bits is None and group is not None:
        xs = torch.rand(num_envs, env.num_nodes, generator=gen, device=env.device) < 0.5
        xs = mesh_lib.shard_env_batch(group, mesh_lib.replicated(xs, group))
    local = num_envs // mesh_lib.world_size(group) if xs is None else xs.shape[0]
    env_state, obs = env.reset(gen, local, start_bits=start_bits, xs=xs)
    if model is None:
        model = MLPActorCritic(env.num_nodes, seed=cfg.seed)
    model = mesh_lib.replicated(model.to(env.device), group)
    return PPOTrainState(model, make_optimizer(model, cfg), env_state, obs, gen, 0,
                         mesh_lib.shard_generator(cfg.seed, group, env.device))


def train_ppo(graph: Graph, cfg: PPOConfig = PPOConfig(), model: Optional[MLPActorCritic] = None, device=None,
              timings: Optional[list] = None, mesh=None, iterations: Optional[int] = None):
    """PPO on one card (or the CPU). With `mesh` (a `parallel` mesh; None or
    one rank: one process) every rank of it runs this, S2V_PPO's DDP:
    `num_envs / ranks` envs a rank (RLSolver's `local_num_envs`,
    `train_ddp.py:40-41`), the model and its Adam replicated, every
    minibatch's gradients `pmean`'d. Returns (this rank's final state, the
    metrics history: one dict of floats an iteration, equal on every rank).
    `timings`, where given, collects each iteration's seconds (ending in a
    wait for the device). `iterations` stops the run early (the step size
    still annealed over `cfg.num_iterations`)."""
    group = mesh_lib.group_of(mesh)
    if cfg.num_envs % mesh_lib.world_size(group):
        raise ValueError(f"num_envs {cfg.num_envs} does not divide over {mesh_lib.world_size(group)} ranks")
    env = FlipMdpEnv(graph, horizon=cfg.horizon, device=device)
    iteration = make_ppo_iteration(env, cfg, group=group)
    state = init_ppo_state(env, cfg, cfg.num_envs, model, group=group)
    history: List[dict] = []
    for _ in range(cfg.num_iterations if iterations is None else iterations):
        t0 = time.time()
        state, metrics = iteration(state)
        history.append({k: float(v) for k, v in metrics.items()})  # waits for the iteration
        if timings is not None:
            timings.append(time.time() - t0)
    return state, history


def train_ppo_sharded(graph: Graph, mesh, cfg: PPOConfig = PPOConfig(), model: Optional[MLPActorCritic] = None,
                      device=None, timings: Optional[list] = None, iterations: Optional[int] = None):
    """Data-parallel PPO (S2V_PPO's DDP), the JAX package's name for
    `train_ppo(..., mesh=mesh)`."""
    return train_ppo(graph, cfg, model, device, timings, mesh=mesh, iterations=iterations)


def a2c_config(cfg: Optional[PPOConfig] = None) -> PPOConfig:
    """A2C as the JAX package derives it from PPO: one full-batch update per
    rollout and no clipping that can bind (one epoch: the ratio is 1)."""
    return dataclasses.replace(cfg or PPOConfig(), num_minibatches=1, update_epochs=1, clip_coef=10.0,
                               clip_vloss=False)


def train_a2c(graph: Graph, cfg: Optional[PPOConfig] = None, model: Optional[MLPActorCritic] = None, device=None,
              timings: Optional[list] = None):
    """A2C (`ECO_S2V/jumanji/agents/AgentA2C` capability) through `train_ppo`."""
    return train_ppo(graph, a2c_config(cfg), model, device, timings)

