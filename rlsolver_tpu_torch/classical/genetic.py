"""Batched genetic algorithm for maxcut (counterpart of
`rlsolver_tpu/classical/genetic.py`): a population of bit strings, the
elite kept, parents drawn by linear rank weights, uniform crossover,
bit-flip mutation, and one greedy 1-flip sweep of the whole population as
the local improvement. The sweep is `MaxcutEnv.sweep_1flip` without a
packed engine: on the card the f32 sweep kernel K10, on the CPU its plain
loop."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv


@dataclasses.dataclass
class GAConfig:
    population: int = 128
    generations: int = 40
    mutation_rate: float = 0.02
    elite_frac: float = 0.25
    seed: int = 0


class GenerationDraws(NamedTuple):
    """One generation's randomness: parent ranks [2, P - E] (0 = the best),
    the crossover mask and the mutation mask [P - E, N] (bool)."""

    parents: torch.Tensor
    cross: torch.Tensor
    mutate: torch.Tensor


def genetic_maxcut(graph: Graph, cfg: GAConfig = GAConfig(), device=None, xs0: Optional[torch.Tensor] = None,
                   draws: Optional[Sequence[GenerationDraws]] = None) -> Tuple[np.ndarray, float]:
    """Returns (best bits, best cut). `xs0` (the first population) and
    `draws` (one per generation) replace the generator's."""
    env = MaxcutEnv(graph, device)
    dev = env.device
    n, pop = graph.num_nodes, cfg.population
    n_elite = max(1, int(pop * cfg.elite_frac))
    n_child = pop - n_elite
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    xs = env.random_xs(gen, pop) if xs0 is None else torch.as_tensor(xs0, device=dev).bool()
    ranks = torch.arange(pop, 0, -1, dtype=torch.float32, device=dev)
    probs = ranks / ranks.sum()

    def generation(xs, vs, d: GenerationDraws):
        order = torch.argsort(-vs, stable=True)  # best first
        elite = xs[order[:n_elite]]
        parents = torch.as_tensor(d.parents, device=dev).long()
        pa, pb = xs[order[parents[0]]], xs[order[parents[1]]]
        children = torch.where(torch.as_tensor(d.cross, device=dev), pa, pb)
        children = torch.logical_xor(children, torch.as_tensor(d.mutate, device=dev))
        xs_new = torch.cat([elite, children], dim=0)
        return env.sweep_1flip(xs_new, env.obj(xs_new))

    xs, vs = env.sweep_1flip(xs, env.obj(xs))
    for i in range(cfg.generations):
        if draws is None:
            d = GenerationDraws(torch.multinomial(probs, 2 * n_child, replacement=True, generator=gen).view(2, -1),
                                torch.rand(n_child, n, generator=gen, device=dev) < 0.5,
                                torch.rand(n_child, n, generator=gen, device=dev) < cfg.mutation_rate)
        else:
            d = draws[i]
        xs, vs = generation(xs, vs, d)
    i = int(torch.argmax(vs))
    return xs[i].cpu().numpy(), float(vs[i])
