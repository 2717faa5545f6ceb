"""The port's CLI (counterpart of `rlsolver_tpu/run.py`), so far for maxcut
by MCPG, L2A (dREINFORCE) and parallel local search:

    python -m rlsolver_tpu_torch --alg mcpg --fast --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --alg mcpg --data-dir data/gset --prefixes gset_14
    python -m rlsolver_tpu_torch --alg l2a --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --alg local_search --fast --graphs BA_100_ID0 --device cpu

`--fast` takes the packed CUDA kernels where the graph's weights are
integers: MCPG's fused sampler and packed sweeps; for L2A and local search
the packed 1-flip sweep (`packed_sweep=True`), as in the JAX package.

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
from rlsolver_tpu_torch.problems.objectives import obj_maxcut


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


SOLVERS = {"mcpg": _mcpg, "local_search": _local_search, "l2a": _l2a}
PORTED_ALGS = tuple(SOLVERS)


def run_one(alg: str, graph: Graph, seed: int, write: bool, instance_path: str,
            fast: bool = False, device=None):
    """Solve one instance, re-score it on the host, optionally write it."""
    t0 = time.time()
    bits, value = SOLVERS[alg](graph, seed, fast, device)
    duration = time.time() - t0
    bits = np.asarray(bits).astype(np.int64)
    check = obj_maxcut(bits, graph)
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
    if args.alg not in PORTED_ALGS:
        raise NotImplementedError(
            f"--alg {args.alg} is not yet ported to rlsolver_tpu_torch (ported: {', '.join(PORTED_ALGS)})"
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
                                       fast=args.fast, device=args.device)
        name = graph.name or os.path.basename(path)
        print(f"{args.alg} {name}: obj={value:.1f} time={duration:.2f}s" + (f" -> {out}" if out else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
