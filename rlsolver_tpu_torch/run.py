"""The port's CLI (counterpart of `rlsolver_tpu/run.py`), so far for maxcut
by MCPG, L2A (dREINFORCE), parallel local search, the classical baselines
(greedy, sa, ga, random_walk, sdp, bls), ISCO and PI-GNN, and for maximum
independent set by ISCO:

    python -m rlsolver_tpu_torch --alg mcpg --fast --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --alg mcpg --data-dir data/gset --prefixes gset_14
    python -m rlsolver_tpu_torch --alg l2a --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --alg local_search --fast --graphs BA_100_ID0 --device cpu
    python -m rlsolver_tpu_torch --alg sa --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --problem mis --alg isco --graphs BA_100_ID0

`--fast` takes the packed CUDA kernels where the graph's weights are
integers: MCPG's fused sampler and packed sweeps; for L2A and local search
the packed 1-flip sweep (`packed_sweep=True`), as in the JAX package. The
other algorithms take their JAX CLI's default configs and ignore `--fast`,
as the JAX CLI does.

Runs on the card unless `--device cpu`. Every returned solution is
re-scored with the host objective, and a mismatch raises. `--write` writes
reference-format result files.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.io import list_graph_files, read_graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.problems.objectives import obj_maxcut, obj_maximum_independent_set


def _mcpg(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos.mcpg import MCPGConfig, solve_maxcut_mcpg

    cfg = MCPGConfig(seed=seed)
    if fast:
        cfg = MCPGConfig(seed=seed, sampler="fused", sweep_mode="packed")
    best_x, best_v, _ = solve_maxcut_mcpg(graph, cfg, device=device)
    return best_x, best_v


def _local_search(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos.local_search_solver import LocalSearchConfig, solve_maxcut_local_search

    best_x, best_v, _ = solve_maxcut_local_search(graph, LocalSearchConfig(seed=seed, packed_sweep=fast),
                                                  device=device)
    return best_x, best_v


def _l2a(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos import l2a

    best_x, best_v, _ = l2a.solve_maxcut_l2a(graph, l2a.L2AConfig(seed=seed, packed_sweep=fast), device=device)
    return best_x, best_v


def _greedy(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.greedy import greedy_maxcut

    return greedy_maxcut(graph, device=device)


def _sa(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.simulated_annealing import SAConfig, anneal_maxcut

    return anneal_maxcut(graph, SAConfig(seed=seed), device=device)


def _ga(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.genetic import GAConfig, genetic_maxcut

    return genetic_maxcut(graph, GAConfig(seed=seed), device=device)


def _random_walk(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.random_walk import random_walk_maxcut

    return random_walk_maxcut(graph, seed=seed, device=device)


def _sdp(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.sdp import SDPConfig, sdp_maxcut

    return sdp_maxcut(graph, SDPConfig(seed=seed), device=device)


def _bls(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.classical.bls import BLSConfig, solve_maxcut_bls

    bits, cut, _ = solve_maxcut_bls(graph, BLSConfig(seed=seed), device=device)
    return bits, cut


def _isco(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig, solve_maxcut_isco

    return solve_maxcut_isco(graph, ISCOConfig(seed=seed), device=device)


def _pignn(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos.pignn import PIGNNConfig, solve_maxcut_pignn

    return solve_maxcut_pignn(graph, PIGNNConfig(seed=seed), device=device)


def _mis_isco(graph: Graph, seed: int, fast: bool, device):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig, solve_mis_isco

    return solve_mis_isco(graph, ISCOConfig(seed=seed), device=device)


SOLVERS = {"mcpg": _mcpg, "local_search": _local_search, "l2a": _l2a, "greedy": _greedy, "sa": _sa, "ga": _ga,
           "random_walk": _random_walk, "sdp": _sdp, "bls": _bls, "isco": _isco, "pignn": _pignn}
# (solvers, host objective) by problem
PROBLEMS = {"maxcut": (SOLVERS, obj_maxcut), "mis": ({"isco": _mis_isco}, obj_maximum_independent_set)}
PORTED_ALGS = tuple(SOLVERS)


def _ported_pairs() -> str:
    return "; ".join(f"--problem {p}: {', '.join(solvers)}" for p, (solvers, _) in PROBLEMS.items())


def run_one(alg: str, graph: Graph, seed: int, write: bool, instance_path: str,
            fast: bool = False, device=None, problem: str = "maxcut"):
    """Solve one instance, re-score it on the host, optionally write it."""
    solvers, objective = PROBLEMS[problem]
    t0 = time.time()
    bits, value = solvers[alg](graph, seed, fast, device)
    duration = time.time() - t0
    bits = np.asarray(bits).astype(np.int64)
    check = objective(bits, graph)
    if abs(check - value) >= 1e-4:
        raise RuntimeError(f"solver/objective mismatch: {value} vs {check}")
    path = None
    if write:
        path = write_graph_result(
            obj=value, running_duration=duration, num_nodes=graph.num_nodes,
            alg_name=alg, solution=bits, instance_file=instance_path,
        )
    return value, duration, path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rlsolver_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--problem", default="maxcut")
    p.add_argument("--alg", required=True)
    p.add_argument("--data-dir", default=None, help="directory of gset-format txt files")
    p.add_argument("--prefixes", nargs="*", default=[], help="instance filename prefixes")
    p.add_argument("--graphs", nargs="*", default=[], help="synthetic names, e.g. BA_100_ID0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write", action="store_true", help="write result files")
    p.add_argument("--fast", action="store_true",
                   help="packed CUDA kernel paths (integer-weight graphs, |w| < 2^15): "
                   "MCPG sampler='fused' + sweep_mode='packed'; l2a and local_search packed_sweep")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.problem not in PROBLEMS or args.alg not in PROBLEMS[args.problem][0]:
        raise NotImplementedError(
            f"--problem {args.problem} --alg {args.alg} is not yet ported to rlsolver_tpu_torch "
            f"(ported: {_ported_pairs()})"
        )

    jobs = []
    if args.data_dir:
        for f in list_graph_files(args.data_dir, args.prefixes or [""]):
            jobs.append((read_graph(f), f))
    for name in args.graphs:
        jobs.append((graph_from_name(name), os.path.join("data", f"{name}.txt")))
    if not jobs:
        p.error("nothing to solve: pass --data-dir or --graphs")

    for graph, path in jobs:
        value, duration, out = run_one(args.alg, graph, args.seed, args.write, path,
                                       fast=args.fast, device=args.device, problem=args.problem)
        name = graph.name or os.path.basename(path)
        print(f"{args.alg} {name}: obj={value:.1f} time={duration:.2f}s" + (f" -> {out}" if out else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
