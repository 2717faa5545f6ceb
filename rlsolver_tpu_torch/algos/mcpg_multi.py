"""MCPG across problems: one solver loop and an adapter per problem (counterpart
of `rlsolver_tpu/algos/mcpg_multi.py`; RLSolver `methods/MCPG/MCPG.py:28-98`
with `sampler_select`, `MCPG/sampling.py:44-65`, over maxcut_edge, r/n
Cheeger cut, MaxSAT, MIMO, qubo and qubo_bin).

One round:
  1. Metropolis bit-flip chains from the Bernoulli policy, each chain
     repeated `repeat_times` times (repeat r of chain c at row r * C + c),
     for max(1, mh_steps_per_var * N) proposal rounds: the packed kernel K3
     with `sampler="fused"`, else `ops.sampling.metropolis_bitflip_scan`;
  2. the problem's local search (`McpgProblem.improve`), then its score;
  3. best of repeats per chain, kept where it beats the chain's incumbent;
  4. one step of Adam (optax's plain `adam`: no clipping) on the REINFORCE
     loss -mean(logp(mh samples) * (score - mean score)).
Chains restart from their incumbents. Every adapter maximizes its score.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.policy import BernoulliPolicy
from rlsolver_tpu_torch.ops import cut as cut_ops
from rlsolver_tpu_torch.ops.kernels.mh_sampler import mh_sample_fused
from rlsolver_tpu_torch.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu_torch.ops.sampling import bernoulli_logp, metropolis_bitflip_scan
from rlsolver_tpu_torch.ops.sweeps import EdgeSweepData, edge_pair_sweep
from rlsolver_tpu_torch.optim import ClippedAdam


@dataclasses.dataclass(frozen=True)
class McpgProblem:
    """A problem over bits [B, N] with a score to maximize.

    score(bits) -> f32 [B]; improve(gen, bits, noise) -> bool [B, N], where
    `noise` (None: drawn from gen) injects the local search's draws in the
    layout that problem's sweep takes; init_bits(gen, num_chains), where
    given, seeds the chains (Cheeger)."""

    num_vars: int
    score: Callable[[torch.Tensor], torch.Tensor]
    improve: Callable[..., torch.Tensor]
    init_bits: Optional[Callable[[torch.Generator, int], torch.Tensor]] = None


@dataclasses.dataclass
class MultiMCPGConfig:
    num_chains: int = 64
    repeat_times: int = 8
    num_rounds: int = 64
    mh_steps_per_var: float = 0.5  # MH proposal rounds = this * num_vars
    lr: float = 8e-2
    seed: int = 0
    sampler: str = "scan"  # "scan" (torch loop) | "fused" (kernel K3, Philox draws on the card)


class MultiMCPGResult(NamedTuple):
    best_bits: np.ndarray
    best_score: float
    history: list


class RoundDraws(NamedTuple):
    """A round's draws, injected in place of the generator's: the MH
    proposals (nodes int [R, B], uniforms f32 [R, B]) and the local
    search's noise (the problem's layout, or None)."""

    nodes: torch.Tensor
    u: torch.Tensor
    noise: Optional[torch.Tensor] = None


def mh_rounds(problem: McpgProblem, cfg: MultiMCPGConfig) -> int:
    return max(1, int(cfg.mh_steps_per_var * problem.num_vars))


def _kernel_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device))


def round_step(problem: McpgProblem, cfg: MultiMCPGConfig, policy: BernoulliPolicy, optimizer: ClippedAdam,
               gen: Optional[torch.Generator], chain_bits: torch.Tensor, best_bits: torch.Tensor,
               best_vs: torch.Tensor, draws: Optional[RoundDraws] = None):
    """One round (see the module doc) from chains bool [C, N] and their
    incumbents; returns (best_bits, best_vs, mh samples [R*C, N], scores
    [R*C]). The chains of the next round are the returned incumbents. The
    gradient of the round's update stays in `policy.logits.grad`."""
    with torch.no_grad():
        probs = policy()
    tiled = chain_bits.repeat(cfg.repeat_times, 1)
    if draws is not None:
        mh = metropolis_bitflip_scan(None, probs, tiled, draws.nodes.shape[0], draws.nodes, draws.u)
    elif cfg.sampler == "fused":
        mh = mh_sample_fused(_kernel_seed(gen), probs, tiled, mh_rounds(problem, cfg))
    else:
        mh = metropolis_bitflip_scan(gen, probs, tiled, mh_rounds(problem, cfg))
    improved = problem.improve(gen, mh, None if draws is None else draws.noise)
    scores = problem.score(improved)
    cand_bits, cand_vs = pick_xs_by_vs(improved, scores, cfg.repeat_times)
    best_bits, best_vs = update_xs_by_vs(best_bits, best_vs, cand_bits, cand_vs)

    adv = scores - scores.mean()
    loss = -torch.mean(bernoulli_logp(policy(), mh) * adv)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return best_bits, best_vs, mh, scores


def new_policy(num_vars: int, cfg: MultiMCPGConfig, device):
    """A fresh policy (logits 0) and its Adam (optax's `adam`: no clipping)."""
    policy = BernoulliPolicy(num_vars, device=device)
    return policy, ClippedAdam(policy.parameters(), cfg.lr, max_norm=None)


def solve_mcpg(problem: McpgProblem, cfg: MultiMCPGConfig = MultiMCPGConfig(), device=None,
               timings: Optional[list] = None) -> MultiMCPGResult:
    """`cfg.num_rounds` rounds on `cuda` unless `device="cpu"` (the problem's
    tensors must live there). `timings`, where given, collects each round's
    seconds (ending in a wait for the device)."""
    if cfg.sampler not in ("scan", "fused"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    if problem.init_bits is not None:
        chain_bits = problem.init_bits(gen, cfg.num_chains)
    else:
        chain_bits = torch.rand(cfg.num_chains, problem.num_vars, generator=gen, device=dev) < 0.5
    policy, optimizer = new_policy(problem.num_vars, cfg, dev)
    best_bits, best_vs = chain_bits, problem.score(chain_bits)
    history = []
    for _ in range(cfg.num_rounds):
        t0 = time.time()
        best_bits, best_vs, _, _ = round_step(problem, cfg, policy, optimizer, gen, best_bits, best_bits, best_vs)
        history.append(float(best_vs.max()))  # waits for the round
        if timings is not None:
            timings.append(time.time() - t0)
    b = int(torch.argmax(best_vs))
    return MultiMCPGResult(best_bits[b].cpu().numpy(), float(best_vs[b]), history)


# ------------------------------------------------------------------ adapters
def _pm(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * 2.0 - 1.0


def maxcut_edge_problem(graph: Graph, num_sweeps: int = 1, device=None) -> McpgProblem:
    """Maxcut with the edge-pair local search (`mcpg_sampling_maxcut_edge`)."""
    cg = cut_ops.CutGraph.build(graph, device)
    data = EdgeSweepData.build(graph, device)
    return McpgProblem(
        num_vars=graph.num_nodes,
        score=lambda bits: cut_ops.cut_value(bits, cg),
        improve=lambda gen, bits, noise=None: edge_pair_sweep(gen, bits, data, num_sweeps, noise=noise),
    )


def maxsat_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """MaxSAT (`mcpg_sampling_maxsat`); `noise`: the sweep's uniforms [S*N, B]."""
    return McpgProblem(
        num_vars=env.num_vars,
        score=env.obj,
        improve=lambda gen, bits, noise=None: env.sweep(gen, bits, num_sweeps=num_sweeps, u=noise),
    )


def qubo_problem(env, binary: bool = False, num_sweeps: int = 2) -> McpgProblem:
    """QUBO over spins +-1 (`mcpg_sampling_qubo`) or bits (`..._qubo_bin`)."""
    if binary:
        return McpgProblem(
            num_vars=env.num_vars,
            score=env.obj_bin,
            improve=lambda gen, bits, noise=None: env.sweep_bin(bits, num_sweeps=num_sweeps),
        )
    return McpgProblem(
        num_vars=env.num_vars,
        score=lambda bits: env.obj_pm(_pm(bits)),
        improve=lambda gen, bits, noise=None: env.sweep_pm(_pm(bits), num_sweeps=num_sweeps) > 0,
    )


def cheeger_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """Cheeger cut (`mcpg_sampling_r/ncheegercut`): maximize minus the
    ratio; chain i starts from the i-th highest-degree node alone."""
    return McpgProblem(
        num_vars=env.num_nodes,
        score=lambda bits: -env.obj(bits),
        improve=lambda gen, bits, noise=None: env.sweep(bits, num_sweeps=num_sweeps),
        init_bits=lambda gen, c: env.seed_bits(c),
    )


def mimo_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """MIMO detection (`mcpg_sampling_mimo`): maximize minus the residual."""
    return McpgProblem(
        num_vars=env.num_vars,
        score=lambda bits: -env.obj(_pm(bits)),
        improve=lambda gen, bits, noise=None: env.sweep(_pm(bits), num_sweeps=num_sweeps) > 0,
    )
