"""The port's CLI (counterpart of `rlsolver_tpu/run.py`): one entry point
over the problem, algorithm and instance axes.

  maxcut               mcpg, l2a, local_search, greedy, sa, ga, random_walk,
                       sdp, bls, isco, pignn, milp (HiGHS), vqe (n <= 16),
                       seq2seq, l2o
  mis                  greedy, isco, milp
  mvc                  greedy, milp
  graph_partitioning   greedy, milp
  graph_coloring       greedy, welsh_powell, dsatur, rlf
  set_cover            greedy, milp (instance files: --data-dir)
  knapsack             greedy, dp, branch_and_bound, fptas, sa, milp (--data-dir)
  tsp                  nn, christofides, karp_steele, cheapest_insertion, each
                       polished by 200 iterations of best-improvement 2-opt
                       on the card (--data-dir of .tsp files)

    python -m rlsolver_tpu_torch --alg mcpg --fast --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --alg mcpg --data-dir data/gset --prefixes gset_14
    python -m rlsolver_tpu_torch --alg local_search --fast --graphs BA_100_ID0 --device cpu
    python -m rlsolver_tpu_torch --alg milp --milp-time-limit 60 --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --problem graph_coloring --alg dsatur --graphs BA_100_ID0
    python -m rlsolver_tpu_torch --problem knapsack --alg dp --data-dir data/knapsack
    python -m rlsolver_tpu_torch --problem tsp --alg christofides --data-dir data/tsp

`--fast` takes the packed CUDA kernels where the graph's weights are
integers: MCPG's fused sampler and packed sweeps; for L2A and local search
the packed 1-flip sweep (`packed_sweep=True`), as in the JAX package. The
other algorithms take their JAX CLI's default configs and ignore `--fast`,
as the JAX CLI does. `--alg milp` runs HiGHS for `--milp-time-limit`
seconds and writes its dual bound and gap into the result file.

Device solvers run on the card unless `--device cpu`; the host solvers
(greedy heuristics, colorings, knapsack's greedy, FPTAS and branch and
bound, MILP, the TSP constructions) take no device. Every returned
solution is re-scored with the host objective (a coloring must also be
proper; a TSP tour must be a permutation whose length `obj_tsp` confirms
within 1e-3 relative), and a mismatch raises. `--write` writes
reference-format result files (not for TSP, as in the JAX CLI). A pair
that neither CLI has raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.io import list_graph_files, read_graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.problems import objectives as obj


@dataclasses.dataclass(frozen=True)
class Options:
    """What the CLI passes every solver beside the instance and the seed."""

    fast: bool = False
    device: Optional[str] = None
    milp_time_limit: float = 60.0


# a solver returns (solution, value) or (solution, value, info for the result file)
Solver = Callable[[object, int, Options], tuple]


def _mcpg(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.mcpg import MCPGConfig, solve_maxcut_mcpg

    cfg = MCPGConfig(seed=seed)
    if opts.fast:
        cfg = MCPGConfig(seed=seed, sampler="fused", sweep_mode="packed")
    best_x, best_v, _ = solve_maxcut_mcpg(graph, cfg, device=opts.device)
    return best_x, best_v


def _local_search(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.local_search_solver import LocalSearchConfig, solve_maxcut_local_search

    best_x, best_v, _ = solve_maxcut_local_search(graph, LocalSearchConfig(seed=seed, packed_sweep=opts.fast),
                                                  device=opts.device)
    return best_x, best_v


def _l2a(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos import l2a

    best_x, best_v, _ = l2a.solve_maxcut_l2a(graph, l2a.L2AConfig(seed=seed, packed_sweep=opts.fast),
                                             device=opts.device)
    return best_x, best_v


def _greedy(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.greedy import greedy_maxcut

    return greedy_maxcut(graph, device=opts.device)


def _sa(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.simulated_annealing import SAConfig, anneal_maxcut

    return anneal_maxcut(graph, SAConfig(seed=seed), device=opts.device)


def _ga(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.genetic import GAConfig, genetic_maxcut

    return genetic_maxcut(graph, GAConfig(seed=seed), device=opts.device)


def _random_walk(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.random_walk import random_walk_maxcut

    return random_walk_maxcut(graph, seed=seed, device=opts.device)


def _sdp(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.sdp import SDPConfig, sdp_maxcut

    return sdp_maxcut(graph, SDPConfig(seed=seed), device=opts.device)


def _bls(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.classical.bls import BLSConfig, solve_maxcut_bls

    bits, cut, _ = solve_maxcut_bls(graph, BLSConfig(seed=seed), device=opts.device)
    return bits, cut


def _isco(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig, solve_maxcut_isco

    return solve_maxcut_isco(graph, ISCOConfig(seed=seed), device=opts.device)


def _pignn(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.pignn import PIGNNConfig, solve_maxcut_pignn

    return solve_maxcut_pignn(graph, PIGNNConfig(seed=seed), device=opts.device)


def _vqe(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.solvers.vqe import VQEConfig, vqe_maxcut

    bits, cut, _ = vqe_maxcut(graph, VQEConfig(seed=seed), device=opts.device)
    return bits, cut


def _seq2seq(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.l2o import Seq2SeqConfig, solve_maxcut_seq2seq

    bits, cut, _ = solve_maxcut_seq2seq(graph, Seq2SeqConfig(seed=seed), device=opts.device)
    return bits, cut


def _l2o(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.l2o import L2OConfig, solve_maxcut_l2o

    bits, cut, _ = solve_maxcut_l2o(graph, L2OConfig(seed=seed), device=opts.device)
    return bits, cut


def _mis_isco(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig, solve_mis_isco

    return solve_mis_isco(graph, ISCOConfig(seed=seed), device=opts.device)


def _milp(graph: Graph, seed: int, opts: Options):
    from rlsolver_tpu_torch.solvers.milp import solve_maxcut

    res = solve_maxcut(graph, time_limit=opts.milp_time_limit)
    gap = (res.bound - res.obj) / max(1e-9, abs(res.obj))
    return res.solution.astype(bool), res.obj, {"obj_bound": res.bound, "gap": gap,
                                                "time_limit": opts.milp_time_limit}


def _from_milp(solve, sign: float = 1.0):
    """A MILP solve as a solver. `sign` maps the MILP's objective to the
    problem's: -1 for MVC, whose MILP minimizes the cover's size while the
    objective is its negative (the JAX CLI reports the size, and its own
    re-score then raises)."""

    def solver(instance, seed: int, opts: Options):
        res = solve(instance, time_limit=opts.milp_time_limit)
        return np.asarray(res.solution).astype(np.int64), sign * res.obj

    return solver


def _coloring(fn):
    def solver(graph: Graph, seed: int, opts: Options):
        colors, k = fn(graph)
        return colors.astype(np.int64), float(k)

    return solver


def _graph_problem_solvers() -> Dict[str, Dict[str, Solver]]:
    """The other graph problems' solvers (the JAX CLI's registries)."""
    from rlsolver_tpu_torch.classical import coloring as col
    from rlsolver_tpu_torch.classical import greedy as gr
    from rlsolver_tpu_torch.solvers import milp

    return {
        "mis": {"greedy": lambda g, seed, opts: gr.greedy_mis(g), "isco": _mis_isco,
                "milp": _from_milp(milp.solve_mis)},
        "mvc": {"greedy": lambda g, seed, opts: gr.greedy_mvc(g), "milp": _from_milp(milp.solve_mvc, -1.0)},
        "graph_partitioning": {"greedy": lambda g, seed, opts: gr.greedy_graph_partitioning(g),
                               "milp": _from_milp(milp.solve_graph_partitioning)},
        "graph_coloring": {"greedy": _coloring(col.greedy_coloring), "welsh_powell": _coloring(col.welsh_powell),
                           "dsatur": _coloring(col.dsatur), "rlf": _coloring(col.recursive_largest_first)},
    }


def _set_cover_solvers() -> Dict[str, Solver]:
    """Set cover over instance files (`util_read_data.py:335-344`); the
    objective is minus the number of sets (`util_obj.py:145`)."""
    from rlsolver_tpu_torch.classical.greedy import greedy_set_cover
    from rlsolver_tpu_torch.solvers import milp

    def milp_cover(inst, seed: int, opts: Options):
        sol = np.asarray(milp.solve_set_cover(inst, time_limit=opts.milp_time_limit).solution).astype(np.int64)
        return sol, -float(sol.sum())

    return {"greedy": lambda inst, seed, opts: greedy_set_cover(inst), "milp": milp_cover}


def _knapsack_solvers() -> Dict[str, Solver]:
    """Knapsack over instance files (`util_read_data.py:314-333`); the
    objective is the total profit."""
    from rlsolver_tpu_torch.classical import knapsack as kp
    from rlsolver_tpu_torch.solvers import milp

    return {
        "greedy": lambda inst, seed, opts: kp.greedy_knapsack(inst),
        "dp": lambda inst, seed, opts: kp.dp_knapsack(inst, device=opts.device),
        "branch_and_bound": lambda inst, seed, opts: kp.branch_and_bound_knapsack(inst),
        "fptas": lambda inst, seed, opts: kp.fptas_knapsack(inst),
        "sa": lambda inst, seed, opts: kp.sa_knapsack(inst, seed, device=opts.device),
        "milp": _from_milp(milp.solve_knapsack),
    }


def _tsp_solvers() -> Dict[str, Solver]:
    """TSP over coordinate files (`read_tsp_coords`): a host construction,
    then 200 iterations of batched best-improvement 2-opt on the device.
    A solver returns (tour, length)."""
    from rlsolver_tpu_torch.classical import tsp as ctsp

    def chain(construct):
        def solve(dist: np.ndarray, seed: int, opts: Options):
            tours, lengths = ctsp.two_opt_best_improvement(np.asarray(construct(dist))[None], dist, max_iters=200,
                                                           device=opts.device)
            return tours[0].cpu().numpy(), float(lengths[0])

        return solve

    return {"nn": chain(ctsp.nearest_neighbor_tour), "christofides": chain(ctsp.christofides_tour),
            "karp_steele": chain(ctsp.karp_steele_tour), "cheapest_insertion": chain(ctsp.cheapest_insertion_tour)}


SOLVERS: Dict[str, Solver] = {"mcpg": _mcpg, "local_search": _local_search, "l2a": _l2a, "greedy": _greedy,
                              "sa": _sa, "ga": _ga, "random_walk": _random_walk, "sdp": _sdp, "bls": _bls,
                              "isco": _isco, "pignn": _pignn, "milp": _milp, "vqe": _vqe, "seq2seq": _seq2seq,
                              "l2o": _l2o}
PORTED_ALGS = tuple(SOLVERS)
INSTANCE_PROBLEMS = ("set_cover", "knapsack")  # instance files of their own, not graphs
PROBLEMS = ("maxcut", "mis", "mvc", "graph_partitioning", "graph_coloring") + INSTANCE_PROBLEMS + ("tsp",)


def _registry(problem: str) -> Dict[str, Solver]:
    if problem == "maxcut":
        return SOLVERS
    if problem == "set_cover":
        return _set_cover_solvers()
    if problem == "knapsack":
        return _knapsack_solvers()
    if problem == "tsp":
        return _tsp_solvers()
    return _graph_problem_solvers()[problem]


def _ported_pairs() -> str:
    return "; ".join(f"--problem {p}: {', '.join(_registry(p))}" for p in PROBLEMS)


def _check_solution(problem: str, solution: np.ndarray, value: float, instance) -> None:
    """Re-score the solution with the host objective; raise on a mismatch
    (and on an improper coloring)."""
    from rlsolver_tpu_torch.classical.coloring import is_proper_coloring

    if problem == "graph_coloring":
        if not is_proper_coloring(instance, solution):
            raise RuntimeError("improper coloring")
        check = float(len(np.unique(solution)))
    else:
        objective = {"maxcut": obj.obj_maxcut, "mis": obj.obj_maximum_independent_set,
                     "mvc": obj.obj_minimum_vertex_cover, "graph_partitioning": obj.obj_graph_partitioning,
                     "set_cover": obj.obj_set_cover, "knapsack": obj.obj_knapsack}[problem]
        check = objective(solution, instance)
    if abs(check - value) >= 1e-4:
        raise RuntimeError(f"solver/objective mismatch: {value} vs {check}")


def _solve(problem: str, alg: str, instance, seed: int, opts: Options) -> Tuple[np.ndarray, float, float, dict]:
    """Solve and re-score one instance -> (solution, value, seconds, info)."""
    t0 = time.time()
    out = _registry(problem)[alg](instance, seed, opts)
    duration = time.time() - t0
    solution, value = np.asarray(out[0]).astype(np.int64), out[1]
    _check_solution(problem, solution, value, instance)
    return solution, value, duration, out[2] if len(out) > 2 else None


def run_one(alg: str, graph: Graph, seed: int, write: bool, instance_path: str, fast: bool = False, device=None,
            problem: str = "maxcut", milp_time_limit: float = 60.0):
    """Solve one graph instance, re-score it on the host, optionally write
    it. Returns (value, seconds, result path or None)."""
    bits, value, duration, info = _solve(problem, alg, graph, seed, Options(fast, device, milp_time_limit))
    path = None
    if write:
        path = write_graph_result(obj=value, running_duration=duration, num_nodes=graph.num_nodes, alg_name=alg,
                                  solution=bits, instance_file=instance_path, info=info)
    return value, duration, path


def run_instance_problem(problem: str, alg: str, path: str, seed: int, write: bool, device=None,
                         milp_time_limit: float = 60.0):
    """set_cover or knapsack on one instance file: its reader, its host
    objective, a result file of 0/1 labels. Returns (value, seconds, result
    path or None)."""
    from rlsolver_tpu_torch.core.io import read_knapsack, read_set_cover

    inst = read_set_cover(path) if problem == "set_cover" else read_knapsack(path)
    sol, value, duration, _ = _solve(problem, alg, inst, seed, Options(False, device, milp_time_limit))
    out = None
    if write:
        size = inst.num_sets if problem == "set_cover" else inst.num_items
        out = write_graph_result(obj=value, running_duration=duration, num_nodes=size, alg_name=alg, solution=sol,
                                 instance_file=path, plus1=False)
    return value, duration, out


def run_tsp(alg: str, path: str, seed: int, device=None) -> Tuple[float, float]:
    """One .tsp file: its solver, then the re-validation (a permutation
    whose `obj_tsp` re-score is the reported length within 1e-3 relative).
    Returns (length, seconds)."""
    from rlsolver_tpu_torch.core.io import read_tsp_coords, tsp_distance_matrix

    dist = tsp_distance_matrix(read_tsp_coords(path))
    t0 = time.time()
    tour, length = _tsp_solvers()[alg](dist, seed, Options(device=device))
    duration = time.time() - t0
    if sorted(np.asarray(tour).tolist()) != list(range(dist.shape[0])):
        raise RuntimeError(f"{alg} returned a non-permutation tour on {path}")
    check = -obj.obj_tsp(tour, dist)
    if abs(check - length) > 1e-3 * max(1.0, abs(length)):
        raise RuntimeError(f"solver/objective mismatch: {length} vs {check}")
    return length, duration


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rlsolver_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--problem", default="maxcut")
    p.add_argument("--alg", required=True)
    p.add_argument("--data-dir", default=None, help="directory of gset-format (or instance, or .tsp) files")
    p.add_argument("--prefixes", nargs="*", default=[], help="instance filename prefixes")
    p.add_argument("--graphs", nargs="*", default=[], help="synthetic names, e.g. BA_100_ID0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write", action="store_true", help="write result files")
    p.add_argument("--fast", action="store_true",
                   help="packed CUDA kernel paths (integer-weight graphs, |w| < 2^15): "
                   "MCPG sampler='fused' + sweep_mode='packed'; l2a and local_search packed_sweep")
    p.add_argument("--milp-time-limit", type=float, default=60.0,
                   help="HiGHS wall-clock limit (seconds) for --alg milp; the maxcut result file gets the dual "
                   "bound and the gap")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.problem not in PROBLEMS or args.alg not in _registry(args.problem):
        raise NotImplementedError(
            f"--problem {args.problem} --alg {args.alg} is not yet ported to rlsolver_tpu_torch "
            f"(ported: {_ported_pairs()})"
        )

    if args.problem == "tsp":
        if not args.data_dir:
            p.error("tsp needs --data-dir of .tsp files")
        import glob

        for f in sorted(glob.glob(os.path.join(args.data_dir, "*.tsp"))):
            if args.prefixes and not any(os.path.basename(f).startswith(x) for x in args.prefixes):
                continue
            length, duration = run_tsp(args.alg, f, args.seed, device=args.device)
            print(f"{args.alg} {os.path.basename(f)}: length={length:.6f} time={duration:.2f}s")
        return 0

    if args.problem in INSTANCE_PROBLEMS:
        if not args.data_dir:
            p.error(f"{args.problem} needs --data-dir of instance files")
        for f in list_graph_files(args.data_dir, args.prefixes or [""]):
            value, duration, out = run_instance_problem(args.problem, args.alg, f, args.seed, args.write,
                                                        device=args.device, milp_time_limit=args.milp_time_limit)
            print(f"{args.alg} {os.path.basename(f)}: obj={value:.1f} time={duration:.2f}s"
                  + (f" -> {out}" if out else ""))
        return 0

    jobs = []
    if args.data_dir:
        for f in list_graph_files(args.data_dir, args.prefixes or [""]):
            jobs.append((read_graph(f), f))
    for name in args.graphs:
        jobs.append((graph_from_name(name), os.path.join("data", f"{name}.txt")))
    if not jobs:
        p.error("nothing to solve: pass --data-dir or --graphs")

    for graph, path in jobs:
        value, duration, out = run_one(args.alg, graph, args.seed, args.write, path, fast=args.fast,
                                       device=args.device, problem=args.problem,
                                       milp_time_limit=args.milp_time_limit)
        name = graph.name or os.path.basename(path)
        print(f"{args.alg} {name}: obj={value:.1f} time={duration:.2f}s" + (f" -> {out}" if out else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
