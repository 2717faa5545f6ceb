"""Parallel local search for maxcut, no neural net (counterpart of
`rlsolver_tpu/algos/local_search_solver.py`; RLSolver's
`search_and_evaluate_local_search`, `env_MCPG.py:408-491`).

Thousands of chains; each iteration runs the env's local search (noisy
multi-flips, then a greedy 1-flip sweep), keeps each chain's better of old
and new, and replaces the worst `replace_frac` of the chains by copies of
random good ones. The sweep runs on the card as K10 (f32 gains), or with
`packed_sweep` (the CLI's `--fast`) as K5/K8a/K8b on integer weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.eval.evaluator import Evaluator
from rlsolver_tpu_torch.ops.reductions import evolutionary_replacement, update_xs_by_vs


@dataclasses.dataclass
class LocalSearchConfig:
    num_sims: int = 1024
    num_iters: int = 32  # outer iterations
    ls_iters: int = 8  # multi-flip iterations per local_search call
    num_spin: int = 8
    noise_std: float = 0.3
    replace_frac: float = 0.125  # worst chains replaced per iteration
    seed: int = 0
    log_every: int = 4
    packed_sweep: bool = False  # packed 1-flip kernels (K5, K8a, K8b) on integer weights


def solve_maxcut_local_search(
    graph: Graph,
    config: LocalSearchConfig = LocalSearchConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    device=None,
):
    """Returns (best_x np.bool_[n], best_v float, evaluator). Runs on `cuda`
    unless `device="cpu"`."""
    dev = resolve_device(device)
    env = MaxcutEnv(graph, dev, packed_sweep=config.packed_sweep)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)
    xs = env.random_xs(gen, config.num_sims)
    vs = env.obj(xs)
    low_k = max(1, int(config.num_sims * config.replace_frac))

    evaluator = Evaluator(save_dir, graph.num_nodes, xs[0].cpu().numpy(), float(vs[0]), if_maximize=True)
    start = time.time()
    for it in range(config.num_iters):
        xs2, vs2 = env.local_search(gen, xs, vs, num_iters=config.ls_iters, num_spin=config.num_spin,
                                    noise_std=config.noise_std)
        xs, vs = update_xs_by_vs(xs, vs, xs2, vs2)
        xs, vs = evolutionary_replacement(gen, xs, vs, low_k)
        if (it + 1) % config.log_every == 0 or it == config.num_iters - 1:
            evaluator.record(it + 1, vs.cpu().numpy(), xs.cpu().numpy())
            if verbose:
                print(evaluator.log_line(it + 1))
    evaluator.save()

    if instance_file is not None:
        write_graph_result(
            evaluator.best_v,
            time.time() - start,
            graph.num_nodes,
            "parallel_local_search",
            evaluator.best_x.astype(int),
            instance_file,
        )
    return evaluator.best_x, evaluator.best_v, evaluator
