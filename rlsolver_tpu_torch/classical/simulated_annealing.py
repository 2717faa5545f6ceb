"""Batched simulated annealing over single-bit flips (counterpart of
`rlsolver_tpu/classical/simulated_annealing.py`): `anneal_maxcut`, the
set-cover annealer `anneal_set_cover` and the generic `anneal_bitvector`.

`num_chains` chains anneal in lockstep under a geometric temperature decay:
each step every chain proposes one uniform random flip and accepts it by
the Metropolis rule (always when it gains); the flip gains follow by
rank-1 updates. JAX's `lax.scan` is a Python loop. The temperatures are
JAX's: `init * decay ** arange(T)` is an f32 power of an f32 base, which
XLA computes as the C library's `powf`; numpy's scalar float32 power is
that function, so the schedule is built on the host, value for value.

Every annealer takes its run's randomness as an argument (`AnnealDraws`,
`SetCoverDraws`) in place of its generator's, so that a run can be held
against the JAX package's with JAX's draws.

On the card the maxcut annealer's loop is replayed as CUDA graphs of
`GRAPH_STEPS` steps (`capture.CapturedCall`, one graph per chain and node
count, shared by every instance of that shape); `anneal_chains(...,
cuda_graph=False)` gives the eager loop, which the graphs follow bit for bit."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops


@dataclasses.dataclass
class SAConfig:
    num_chains: int = 256
    num_steps: int = 2000
    init_temperature: float = 4.0
    final_temperature: float = 1e-2
    seed: int = 0


class AnnealDraws(NamedTuple):
    """A run's randomness: the start bits [B, N], each step's proposed node
    [T, B] and its acceptance uniform [T, B]."""

    xs0: torch.Tensor
    nodes: torch.Tensor
    u: torch.Tensor


def temperatures(cfg: SAConfig) -> np.ndarray:
    """f32 [T]: init * decay ** t, each power a float32 `powf`."""
    decay = np.float32((cfg.final_temperature / cfg.init_temperature) ** (1.0 / cfg.num_steps))
    powers = np.array([decay ** np.float32(t) for t in range(cfg.num_steps)], np.float32)
    return np.float32(cfg.init_temperature) * powers


GRAPH_STEPS = 250  # annealing steps one CUDA graph replays
_GRAPHS: Dict[tuple, CapturedCall] = {}


def _anneal_steps(adj, s, gains, vs, best_s, best_vs, nodes, u, temps):
    """One step per row of nodes / u [T, B] at temps [T]; `s` is written in
    place. -> (s, gains, vs, best_s, best_vs)."""
    rows = torch.arange(s.shape[0], device=s.device)
    for t in range(nodes.shape[0]):
        v = nodes[t]
        g = gains[rows, v]
        accept = (u[t] < torch.exp(torch.clamp(g / temps[t], max=0.0))) | (g > 0)
        s_a = s[rows, v]
        gains = gains + -2.0 * (s_a * accept)[:, None] * s * adj[v]
        gains[rows, v] = torch.where(accept, -g, g)
        s[rows, v] = torch.where(accept, -s_a, s_a)
        vs = vs + torch.where(accept, g, 0.0)
        better = vs > best_vs
        best_vs = torch.where(better, vs, best_vs)
        best_s = torch.where(better[:, None], s, best_s)
    return s, gains, vs, best_s, best_vs


def anneal_chains(cg: cut_ops.CutGraph, xs: torch.Tensor, nodes: torch.Tensor, u: torch.Tensor,
                  temps: torch.Tensor, cuda_graph: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The annealing loop from start bits xs [B, N], one step per row of
    nodes / u [T, B] at temps [T] -> (best signs [B, N], best cuts [B]). On
    the card the whole blocks of GRAPH_STEPS steps replay as CUDA graphs
    unless `cuda_graph=False`; the rest runs eagerly."""
    s, vs = cut_ops.signs_from_bits(xs), cut_ops.cut_dense(xs, cg)
    state = (s, cut_ops.flip_gains_dense(xs, cg), vs, s.clone(), vs)
    steps, done = nodes.shape[0], 0
    if cuda_graph and xs.is_cuda:
        key = (tuple(xs.shape), str(xs.device))
        block = _GRAPHS.setdefault(key, CapturedCall(_anneal_steps))
        for done in range(0, steps - steps % GRAPH_STEPS, GRAPH_STEPS):
            state = block(cg.adj, *state, nodes[done:done + GRAPH_STEPS], u[done:done + GRAPH_STEPS],
                          temps[done:done + GRAPH_STEPS])
        done = steps - steps % GRAPH_STEPS
        state = tuple(x.clone() for x in state)  # the graph's outputs are overwritten by its next replay
    _, _, _, best_s, best_vs = _anneal_steps(cg.adj, *state, nodes[done:], u[done:], temps[done:])
    return best_s, best_vs


def anneal_maxcut(graph: Graph, cfg: SAConfig = SAConfig(), device=None,
                  draws: Optional[AnnealDraws] = None) -> Tuple[np.ndarray, float]:
    """Returns (best bits [n], best cut). `draws` replaces the generator's."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    n, b, steps = graph.num_nodes, cfg.num_chains, cfg.num_steps
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        draws = AnnealDraws(torch.rand(b, n, generator=gen, device=dev) < 0.5,
                            torch.randint(0, n, (steps, b), generator=gen, device=dev),
                            torch.rand(steps, b, generator=gen, device=dev))
    best_s, best_vs = anneal_chains(cg, torch.as_tensor(draws.xs0, device=dev).bool(),
                                    torch.as_tensor(draws.nodes, device=dev).long(),
                                    torch.as_tensor(draws.u, device=dev).float(),
                                    torch.from_numpy(temperatures(cfg)).to(dev))
    i = int(torch.argmax(best_vs))
    return (best_s[i] > 0).cpu().numpy(), float(best_vs[i])


class SetCoverDraws(NamedTuple):
    """A set-cover run's randomness, each step's: the uniforms that pick the
    set to add [T, B, S] and the two to drop [T, B, S], whether to drop one
    only [T, B, 1], and the acceptance uniform [T, B]."""

    u_in: torch.Tensor
    u_out: torch.Tensor
    u_one: torch.Tensor
    u_accept: torch.Tensor


def set_cover_temperatures(cfg: SAConfig) -> np.ndarray:
    """f32 [T]: T0 (1 - (k + 1) / T) + 1e-6, the linear decay of RLSolver's
    set-cover SA, as XLA's CPU code computes it: the division by the
    constant T as a product with f32(1 / T), fused with the subtraction
    from 1 into one multiply-add (emulated in float64, where the product of
    two f32 values is exact), then the product with T0 and the sum
    rounded to f32 each."""
    k = np.arange(cfg.num_steps, dtype=np.float32) + np.float32(1)
    one_minus = (1.0 - k.astype(np.float64) * np.float64(np.float32(1.0 / cfg.num_steps))).astype(np.float32)
    return np.float32(cfg.init_temperature) * one_minus + np.float32(1e-6)


def _gumbel_top(u: torch.Tensor, mask: torch.Tensor, num: int) -> torch.Tensor:
    """The `num` columns of largest Gumbel score -log(-log(u + 1e-12)) among
    mask=True, [B, num]; masked columns score -inf. Ties (the masked
    columns, when fewer than `num` are allowed) go to the lowest index, as
    `lax.top_k`'s do: a stable descending sort."""
    gumbel = -torch.log(-torch.log(u + 1e-12))
    scores = torch.where(mask, gumbel, -torch.inf)
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :num]


def anneal_set_cover(instance, cfg: SAConfig = SAConfig(), device=None,
                     draws: Optional[SetCoverDraws] = None) -> Tuple[np.ndarray, float]:
    """Set-cover SA with RLSolver's swap moves (`simulated_annealing.py:41-105`):
    every chain starts from the greedy cover; each step adds one unselected
    set and drops two selected ones (one only with probability 0.05, or
    when fewer than two are selected), picked by masked Gumbel top-k, and
    accepts by the Metropolis rule under a linear decay; uncovering
    proposals score -inf and are never accepted. `num_chains` chains in
    lockstep. Returns (bits [num_sets], -#sets of the best)."""
    from rlsolver_tpu_torch.classical.greedy import greedy_set_cover

    dev = resolve_device(device)
    member = torch.from_numpy(instance.membership_matrix()).to(dev, torch.float32)  # [S, I]
    num_sets = member.shape[0]
    gr_bits, _ = greedy_set_cover(instance)
    b = cfg.num_chains
    xs = torch.from_numpy(gr_bits).to(dev)[None].expand(b, num_sets).clone()
    temps = torch.from_numpy(set_cover_temperatures(cfg)).to(dev)
    gen = None
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def objective(x):
        feasible = ((x.to(torch.float32) @ member) > 0).all(dim=1)
        return torch.where(feasible, -x.sum(dim=1).to(torch.float32), -torch.inf)

    def step_draws(t):
        if draws is not None:
            return (torch.as_tensor(draws.u_in[t], device=dev), torch.as_tensor(draws.u_out[t], device=dev),
                    torch.as_tensor(draws.u_one[t], device=dev), torch.as_tensor(draws.u_accept[t], device=dev))
        return (torch.rand(b, num_sets, generator=gen, device=dev), torch.rand(b, num_sets, generator=gen, device=dev),
                torch.rand(b, 1, generator=gen, device=dev), torch.rand(b, generator=gen, device=dev))

    vs = objective(xs)
    best_xs, best_vs = xs, vs
    rows = torch.arange(b, device=dev)[:, None]
    for t in range(cfg.num_steps):
        u_in, u_out, u_one, u_acc = step_draws(t)
        prop = xs.clone()
        prop[rows, _gumbel_top(u_in, ~xs, 1)] = True
        outs = _gumbel_top(u_out, xs, 2)  # two selected sets to drop
        keep_second = (u_one < 0.05) | (xs.sum(dim=1, keepdim=True) < 2)
        prop[rows, outs[:, :1]] = False
        both = prop.clone()
        both[rows, outs[:, 1:]] = False
        prop = torch.where(keep_second, prop, both)
        vs_prop = objective(prop)
        g = vs_prop - vs
        accept = ((g > 0) | (u_acc < torch.exp(torch.clamp(g / temps[t], max=0.0)))) & torch.isfinite(vs_prop)
        xs = torch.where(accept[:, None], prop, xs)
        vs = torch.where(accept, vs_prop, vs)
        better = vs > best_vs
        best_vs = torch.where(better, vs, best_vs)
        best_xs = torch.where(better[:, None], xs, best_xs)
    i = int(torch.argmax(best_vs))
    return best_xs[i].cpu().numpy(), float(best_vs[i])


def anneal_bitvector(objective: Callable[[torch.Tensor], torch.Tensor], num_bits: int, cfg: SAConfig = SAConfig(),
                     init_bits=None, device=None, draws: Optional[AnnealDraws] = None) -> Tuple[np.ndarray, float]:
    """Generic SA for a batched bit-vector objective (bool [B, N] -> f32
    [B], higher better; -inf marks a hard infeasible state, never
    accepted): one uniform bit flip proposed a step, the Metropolis rule,
    `anneal_maxcut`'s geometric schedule. Starts from `init_bits` [N] in
    every chain, else from uniform bits. Returns (best bits [N], its
    value)."""
    dev = resolve_device(device)
    b, steps = cfg.num_chains, cfg.num_steps
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        xs0 = torch.rand(b, num_bits, generator=gen, device=dev) < 0.5
        draws = AnnealDraws(xs0, torch.randint(0, num_bits, (steps, b), generator=gen, device=dev),
                            torch.rand(steps, b, generator=gen, device=dev))
    if init_bits is not None:
        xs = torch.as_tensor(init_bits, device=dev).bool()[None].expand(b, num_bits).clone()
    else:
        xs = torch.as_tensor(draws.xs0, device=dev).bool()
    nodes = torch.as_tensor(draws.nodes, device=dev).long()
    u = torch.as_tensor(draws.u, device=dev).float()
    temps = torch.from_numpy(temperatures(cfg)).to(dev)
    vs = objective(xs)
    best_xs, best_vs = xs, vs
    rows = torch.arange(b, device=dev)
    for t in range(steps):
        prop = xs.clone()
        prop[rows, nodes[t]] = ~xs[rows, nodes[t]]
        vs_prop = objective(prop)
        g = vs_prop - vs
        accept = ((g > 0) | (u[t] < torch.exp(torch.clamp(g / temps[t], max=0.0)))) & torch.isfinite(vs_prop)
        xs = torch.where(accept[:, None], prop, xs)
        vs = torch.where(accept, vs_prop, vs)
        better = vs > best_vs
        best_vs = torch.where(better, vs, best_vs)
        best_xs = torch.where(better[:, None], xs, best_xs)
    i = int(torch.argmax(best_vs))
    return best_xs[i].cpu().numpy(), float(best_vs[i])
