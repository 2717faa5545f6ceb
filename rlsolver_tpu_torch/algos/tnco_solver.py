"""TNCO solvers: batched local search and MCPG over the binary rank codec
(counterpart of `rlsolver_tpu/algos/tnco_solver.py`; RLSolver
`TNCO_local_search.py:118-197` and the policy loop of `envs/env_L2A.py:322-450`).

One MCPG round (`make_tnco_mcpg_step`):
  1. each incumbent's order in the bits codec, repeated `repeat_times` times
     (repeat r of chain c at row r * C + c), resampled toward the per-bit
     Bernoulli policy by `mh_rounds` Metropolis rounds: kernel K3
     (`mh_sample_fused`, Philox draws on the card) with `sampler="fused"`,
     else `ops.sampling.metropolis_bitflip_scan`;
  2. decoded to orders, to rank priorities, then `ls_iters` iterations of
     the env's local search;
  3. the best of each chain's repeats (the first minimum) kept where it
     beats the chain's incumbent;
  4. one Adam step (optax's plain `adam`) on mean(logp(mh) * (v - mean v)):
     the cost is minimized.
The data-parallel form (`make_tnco_mcpg_step(..., group=)`,
`solve_tnco_mcpg(..., mesh=)`, also named `solve_tnco_mcpg_sharded`;
BASELINE config 5) shards the chains over the ranks of a `parallel` mesh
and keeps the policy and its Adam replicated: each rank draws its own MH
proposals and local-search noise (the state's `shard_generator`, JAX's
`fold_in` of the shard index; the replicated generator on one rank), the
mean cost and the gradients are `pmean`'d (one flat all-reduce) and the
incumbent `pmin`'d. Sharded, the step runs the MH scan even with
`sampler="fused"`, as the JAX package does (`tnco_solver.py:108`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.envs.tnco import LocalSearchDraws, TncoEnv
from rlsolver_tpu_torch.models.policy import BernoulliPolicy
from rlsolver_tpu_torch.ops.kernels.mh_sampler import mh_sample_fused
from rlsolver_tpu_torch.ops.sampling import bernoulli_logp, metropolis_bitflip_scan
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class TncoSearchConfig:
    num_chains: int = 64
    num_rounds: int = 30
    ls_iters: int = 8
    num_spin: int = 8
    noise_std: float = 0.3
    seed: int = 0


def solve_tnco_local_search(env: TncoEnv, cfg: TncoSearchConfig = TncoSearchConfig(),
                            sorts: Optional[torch.Tensor] = None,
                            draws: Optional[List[LocalSearchDraws]] = None) -> Tuple[np.ndarray, float, list]:
    """Local search in priority space from `num_chains` random orders (or
    `sorts`), `num_rounds` rounds of `ls_iters` iterations; round r's draws
    come from `draws[r]` where given. Returns (best order [R], its log10
    cost, the best cost after each round)."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(cfg.seed)
    if sorts is None:
        sorts = env.random_edge_sorts(gen, cfg.num_chains)
    fs = env.ranks_to_priorities(sorts.to(env.device))
    vs = env.obj_priorities(fs)
    history = []
    for r in range(cfg.num_rounds):
        fs, vs = env.local_search(gen, fs, vs, num_iters=cfg.ls_iters, num_spin=cfg.num_spin,
                                  noise_std=cfg.noise_std, draws=None if draws is None else draws[r])
        history.append(float(vs.min()))
    b = int(torch.argmin(vs))
    order = env.priorities_to_edge_sorts(fs[b : b + 1])[0].cpu().numpy()
    return order, float(vs[b]), history


@dataclasses.dataclass
class TncoMcpgConfig:
    num_chains: int = 32
    repeat_times: int = 4
    num_rounds: int = 30
    mh_rounds: int = 64
    ls_iters: int = 4
    lr: float = 5e-2
    seed: int = 0
    sampler: str = "scan"  # "scan" (torch loop) | "fused" (kernel K3, Philox draws on the card)


class TncoMcpgState(NamedTuple):
    """The policy (logits), its Adam, the generator, and the incumbents'
    priorities [C, R] and costs [C] (this rank's chains when sharded). The
    step updates the policy and its Adam in place and returns new
    incumbents. `shard_generator` draws a rank's own proposals and noise
    when the chains are sharded over more than one rank."""

    policy: BernoulliPolicy
    optimizer: ClippedAdam
    generator: torch.Generator
    best_fs: torch.Tensor
    best_vs: torch.Tensor
    shard_generator: Optional[torch.Generator] = None


class TncoRoundDraws(NamedTuple):
    """A round's draws in place of the generator's: the MH proposals
    (nodes int [M, C*R], uniforms f32 [M, C*R]) and the local search's."""

    nodes: torch.Tensor
    u: torch.Tensor
    ls: LocalSearchDraws


def _kernel_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device))


def make_tnco_mcpg_step(env: TncoEnv, cfg: TncoMcpgConfig, group=None):
    """step(state, draws=None) -> (state, {"best", "mean"}): one round (see
    the module doc). With `draws` the scan sampler's and the local search's
    draws are injected (a rank's own, when sharded). `group` (a `parallel`
    mesh or process group) shards the chains over its ranks."""
    if cfg.sampler not in ("scan", "fused"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    fused = cfg.sampler == "fused" and group is None

    def step(state: TncoMcpgState, draws: Optional[TncoRoundDraws] = None):
        policy, optimizer = state.policy, state.optimizer
        gen = state.shard_generator or state.generator
        with torch.no_grad():
            probs = policy()
        bits = env.edge_sorts_to_bits(env.priorities_to_edge_sorts(state.best_fs))
        tiled = bits.repeat(cfg.repeat_times, 1)
        if draws is not None:
            mh = metropolis_bitflip_scan(None, probs, tiled, draws.nodes.shape[0], draws.nodes.to(tiled.device),
                                         draws.u.to(tiled.device))
        elif fused:
            mh = mh_sample_fused(_kernel_seed(gen), probs, tiled, cfg.mh_rounds)
        else:
            mh = metropolis_bitflip_scan(gen, probs, tiled, cfg.mh_rounds)

        fs = env.ranks_to_priorities(env.bits_to_edge_sorts(mh))
        fs, vs = env.local_search(gen, fs, num_iters=cfg.ls_iters, draws=None if draws is None else draws.ls)

        c = state.best_fs.shape[0]
        best_r = torch.argmin(vs.reshape(cfg.repeat_times, c), dim=0)
        rows = best_r * c + torch.arange(c, device=vs.device)
        cand_fs, cand_vs = fs[rows], vs[rows]
        better = cand_vs < state.best_vs
        best_fs = torch.where(better[:, None], cand_fs, state.best_fs)
        best_vs = torch.where(better, cand_vs, state.best_vs)

        mean_v = mesh_lib.pmean(vs.mean(), group)
        adv = vs - mean_v
        loss = torch.mean(bernoulli_logp(policy(), mh) * adv)
        optimizer.zero_grad()
        loss.backward()
        mesh_lib.pmean_grads(optimizer.params, group)
        optimizer.step()
        metrics = {"best": mesh_lib.pmin(best_vs.min(), group), "mean": mean_v}
        return state._replace(best_fs=best_fs, best_vs=best_vs), metrics

    return step


def init_tnco_mcpg_state(env: TncoEnv, cfg: TncoMcpgConfig, sorts: Optional[torch.Tensor] = None,
                         group=None) -> TncoMcpgState:
    """Random incumbents (or `sorts` [C, R]), logits 0, a fresh Adam, the
    generator seeded with cfg.seed. With `group` every rank draws the
    global incumbents, takes rank 0's (a broadcast) and keeps its own rows,
    and gets a generator of its own draws."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(cfg.seed)
    if sorts is None:
        sorts = env.random_edge_sorts(gen, cfg.num_chains)
    sorts = mesh_lib.shard_env_batch(group, mesh_lib.replicated(sorts.to(env.device), group))
    fs = env.ranks_to_priorities(sorts)
    vs = env.obj_priorities(fs)
    policy = BernoulliPolicy(env.num_bits, device=env.device)
    return TncoMcpgState(policy, ClippedAdam(policy.parameters(), cfg.lr, max_norm=None), gen, fs, vs,
                         mesh_lib.shard_generator(cfg.seed, group, env.device))


def solve_tnco_mcpg(env: TncoEnv, cfg: TncoMcpgConfig = TncoMcpgConfig(),
                    timings: Optional[list] = None, mesh=None) -> Tuple[np.ndarray, float, list]:
    """MCPG on the env's device. With `mesh` (a `parallel` mesh; None or one
    rank: one process) every rank of it runs this: the chains sharded, the
    policy replicated, `pmean`'d gradients and `pmin`'d incumbents. Returns
    (best order [R], its log10 cost, the best cost after each round), the
    global ones on every rank. `timings`, where given, collects each
    round's seconds (ending in a wait for the device)."""
    group = mesh_lib.group_of(mesh)
    if cfg.num_chains % mesh_lib.world_size(group):
        raise ValueError(f"num_chains {cfg.num_chains} does not divide over {mesh_lib.world_size(group)} ranks")
    step = make_tnco_mcpg_step(env, cfg, group=group)
    state = init_tnco_mcpg_state(env, cfg, group=group)
    history = []
    for _ in range(cfg.num_rounds):
        t0 = time.time()
        state, metrics = step(state)
        history.append(float(metrics["best"]))  # waits for the round
        if timings is not None:
            timings.append(time.time() - t0)
    best_fs = mesh_lib.all_gather_rows(state.best_fs, group)
    best_vs = mesh_lib.all_gather_rows(state.best_vs, group)
    b = int(torch.argmin(best_vs))
    order = env.priorities_to_edge_sorts(best_fs[b : b + 1])[0].cpu().numpy()
    return order, float(best_vs[b]), history


def solve_tnco_mcpg_sharded(env: TncoEnv, mesh, cfg: TncoMcpgConfig = TncoMcpgConfig(),
                            timings: Optional[list] = None) -> Tuple[np.ndarray, float, list]:
    """Data-parallel MCPG on TNCO (BASELINE config 5), the JAX package's
    name for `solve_tnco_mcpg(..., mesh=mesh)`."""
    return solve_tnco_mcpg(env, cfg, timings, mesh=mesh)
