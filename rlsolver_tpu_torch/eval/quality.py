"""Distribution-wise quality runner (counterpart of `scripts/quality_table.py`
and `scripts/bound_table.py`; reference protocol `README.md:356-371`).

Runs every DIST_TABLE column over 10 seeded instances per (BA/ER/PL) x N and
appends rows

    dist,n,id,alg,obj,seconds

to a resumable CSV (`results_quality/torch/dist_table.csv` by default). The
protocols are the JAX runner's, field for field: the classical budgets
(`sa_config`, `ga_config`, `specb_config`), and one cell function per
learned column (`cell_mcpg`, `cell_jumanji`, `cell_dqn` for eco/s2v,
`cell_specb`, `cell_isco`, `cell_pignn`, `cell_l2a`), each with the JAX
runner's chains, steps, iterations, training seeds and eval env counts, and
its `SPECB_*`, `ECO_*`, `JUMANJI_ITERS` and `ISCO_BATCH` overrides. A batched
cell's rows carry its seconds divided by its instances. Every cut a solver
returns with its solution is re-scored on the host in float64 before its row
is written.

`--redo` re-runs cells and appends (the summary keeps the best row). A cell
that raises is logged and the sweep goes on, except after a CUDA error that
leaves the process's context unusable: then the runner exits 17, and a fresh
process resumes from the CSV.

    python scripts/torch_quality_table.py [--sizes 100,1000] [--dists BA,ER,PL]
        [--algs greedy,sa,...] [--ids 10] [--out PATH] [--redo ALGS] [--device cpu]

`bound_main` is `scripts/bound_table.py`: the HiGHS MILP (`milp`) and its
dual bound (`milp_bound`) per instance on the host, into the same CSV.
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import List, Optional, Sequence

OUT = os.path.join("results_quality", "torch", "dist_table.csv")
HEADER = ["dist", "n", "id", "alg", "obj", "seconds"]
# training-graph seeds of the per-cell learned columns (generate_graph(dist, n, seed))
JUMANJI_TRAIN_SEED, DQN_TRAIN_SEED = 91000, 92000
EXIT_CONTEXT_LOST = 17
# CUDA's descriptions (cudaGetErrorString) of the errors after which the
# context is unusable for the rest of the process
STICKY_CUDA_ERRORS = ("an illegal memory access was encountered", "unspecified launch failure",
                      "uncorrectable ECC error encountered", "an illegal instruction was encountered",
                      "misaligned address", "device-side assert triggered", "the launch timed out and was terminated",
                      "hardware stack error", "invalid program counter")


class RescoreError(AssertionError):
    """A solver's reported cut differs from the host's re-score of its solution."""


def context_lost(exc: BaseException) -> bool:
    return any(s in repr(exc) for s in STICKY_CUDA_ERRORS)


def existing_rows(path):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.reader(f):
                if row and row[0] != "dist":
                    done.add((row[0], int(row[1]), int(row[2]), row[3]))
    return done


def append_row(path, dist, n, gid, alg, obj, seconds):
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow([dist, n, gid, alg, f"{obj:.1f}", f"{seconds:.1f}"])


def ensure_csv(path: str, header=HEADER) -> None:
    """Creates the CSV (and its directory) with its header if it is absent."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(header)


def rescored(label: str, graph, bits, value: float) -> float:
    """`value` after checking it against the float64 host cut of `bits`."""
    import numpy as np

    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    host = obj_maxcut(np.asarray(bits).astype(np.int64), graph)
    if host != float(value):
        raise RescoreError(f"{label} {graph.name}: reported cut {value} != host re-score {host}")
    return float(value)


def kernel_launches(reset: bool = False) -> dict:
    """The port's kernels launched since the last reset, by name (then
    reset the counts, if asked)."""
    from rlsolver_tpu_torch.ops.kernels import build

    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    if reset:
        build.reset_counts()
    return counts


def state_bits(state):
    """The best spins of an env state's best env as {0, 1} bits."""
    b = int(state.best_score.argmax())
    return (state.best_spins[b] > 0).cpu().numpy()


# ---------------------------------------------------------------- protocols
def sa_config(n: int, seed: int):
    from rlsolver_tpu_torch.classical.simulated_annealing import SAConfig

    return SAConfig(num_chains=256, num_steps=max(2000, 12 * n), seed=seed)


def ga_config(n: int, seed: int):
    from rlsolver_tpu_torch.classical.genetic import GAConfig

    return GAConfig(generations=40 if n <= 400 else 64, seed=seed)


def specb_iters(n: int) -> int:
    iters = 4000 if n <= 300 else (8000 if n <= 600 else 12000)
    if n >= 2000:  # large-N rows: [N, N] @ [N, k] matmuls dominate
        iters = 3000
    return int(os.environ.get("SPECB_ITERS", iters))


def specb_config(n: int):
    """The certified Poljak-Rendl bound's cell (the license-free analogue of
    the reference's Gurobi "obj bound" column, `README.md:335`)."""
    from rlsolver_tpu_torch.classical.spectral_bound import SpectralBoundConfig

    return SpectralBoundConfig(opt_iters=specb_iters(n), lr=4.0, block_size=int(os.environ.get("SPECB_BLOCK", 16)),
                               mu_halvings=10, certify_squarings=int(os.environ.get("SPECB_CERT", 12)))


MCPG_PROTOCOL = dict(total_mcmc_num=256, repeat_times=32, num_ls=8, max_epoch_num=6, reset_epoch_num=64)


def mcpg_config(**over):
    """DIST_TABLE's batched MCPG (`over`: the convergence pass's widths and seed)."""
    from rlsolver_tpu_torch.algos.mcpg import MCPGConfig

    return MCPGConfig(**{**MCPG_PROTOCOL, **over})


def jumanji_configs(n: int):
    """(train env config, eval env config, SpinPPOConfig): truncated-rollout
    training (a full 2N-step buffer is [2N, B, N, 7]), full 2N-step eval."""
    from rlsolver_tpu_torch.algos.jumanji_ppo import SpinPPOConfig
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig

    train = SpinSystemConfig(num_envs=128 if n <= 500 else 64, max_steps=min(2 * n, 256), basin_reward=1.0 / n,
                             stag_punishment=0.01)
    evaluate = SpinSystemConfig(num_envs=64, basin_reward=1.0 / n, stag_punishment=0.01)
    ppo = SpinPPOConfig(num_iters=int(os.environ.get("JUMANJI_ITERS", 100 if n <= 500 else 80)), features=32,
                        n_layers=2, num_minibatches=1 if n <= 300 else (8 if n <= 500 else 16))
    return train, evaluate, ppo


def dqn_configs(alg: str, n: int):
    """(train env config, eval env config, DQNConfig, loop steps) of the
    per-cell ECO-DQN ("eco": truncated training episodes, full 2N-step eval)
    or S2V-DQN ("s2v": irreversible one-shot construction)."""
    from rlsolver_tpu_torch.algos.dqn import DQNConfig
    from rlsolver_tpu_torch.envs.spin_system import NUM_OBSERVABLES_S2V, RewardSignal, SpinSystemConfig

    if alg == "eco":
        train = SpinSystemConfig(num_envs=int(os.environ.get("ECO_ENVS", 64)), max_steps=min(2 * n, 512),
                                 basin_reward=1.0 / n, stag_punishment=0.01)
        evaluate = SpinSystemConfig(num_envs=32, basin_reward=1.0 / n, stag_punishment=0.01)
        steps = int(os.environ.get("ECO_STEPS", 24576 if n <= 500 else 12288))
    else:
        train = evaluate = SpinSystemConfig(num_envs=32, max_steps=n, reversible_spins=False,
                                            num_observables=NUM_OBSERVABLES_S2V, reward_signal=RewardSignal.DENSE,
                                            norm_rewards=False)
        steps = 6144 if n <= 500 else 3072
    dcfg = DQNConfig(features=32, n_layers=2, buffer_capacity=2**12, eps_decay_steps=steps // 2)
    return train, evaluate, dcfg, steps


def isco_config(n: int):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig

    # dense-energy cost scales ~ chains x N^2 x 2N
    return ISCOConfig(batch_size=int(os.environ.get("ISCO_BATCH", 256 if n <= 800 else 96)),
                      chain_length=max(600, 2 * n), seed=0)


def l2a_config(dist: str, n: int, **over):
    """Distribution-wise L2A's training (`over`: the convergence pass's
    iterations and seed)."""
    from rlsolver_tpu_torch.algos.l2a_distribution import L2ADistConfig
    from rlsolver_tpu_torch.config import GraphType

    base = dict(graph_type=GraphType(dist), num_nodes=n, num_sims=256, num_repeats=4, top_k=max(12, n // 10),
                seq_len=8, num_iters=60, embed_dim=32, pretrain_steps=100, ls_sweeps=2, num_validation=0)
    return L2ADistConfig(**{**base, **over})


def l2a_eval_kwargs(n: int) -> dict:
    """The packed evaluator's budget: MCPG-class guided search."""
    return dict(num_rounds=128 if n <= 500 else 256, num_sims=512, num_repeats=16, num_sweeps=8)


# ------------------------------------------------------------ cell functions
# Each takes the cell's graphs (those still to run) and returns (cuts,
# seconds per instance).
def run_classical(alg: str, graph, seed: int, device=None):
    """(bits, value) of one classical run."""
    n = graph.num_nodes
    if alg == "greedy":
        from rlsolver_tpu_torch.classical.greedy import greedy_maxcut

        return greedy_maxcut(graph, device=device)
    if alg == "sa":
        from rlsolver_tpu_torch.classical.simulated_annealing import anneal_maxcut

        return anneal_maxcut(graph, sa_config(n, seed), device=device)
    if alg == "ga":
        from rlsolver_tpu_torch.classical.genetic import genetic_maxcut

        return genetic_maxcut(graph, ga_config(n, seed), device=device)
    if alg == "sdp":
        from rlsolver_tpu_torch.classical.sdp import SDPConfig, sdp_maxcut

        return sdp_maxcut(graph, SDPConfig(seed=seed), device=device)
    if alg == "rw":
        from rlsolver_tpu_torch.classical.random_walk import random_walk_maxcut

        return random_walk_maxcut(graph, seed=seed, device=device)
    raise ValueError(alg)


def cell_classical(alg: str, graphs, seeds, device):
    cuts, secs = [], []
    for g, seed in zip(graphs, seeds):
        t0 = time.time()
        bits, value = run_classical(alg, g, seed=seed, device=device)
        secs.append(time.time() - t0)
        cuts.append(rescored(alg, g, bits, value))
    return cuts, secs


def cell_mcpg(graphs, device, **over):
    from rlsolver_tpu_torch.algos.mcpg_batch import solve_maxcut_mcpg_batched

    t0 = time.time()
    x, bv, _ = solve_maxcut_mcpg_batched(graphs, mcpg_config(**over), device=device)
    dt = (time.time() - t0) / len(graphs)
    return [rescored("mcpg", g, x[k], bv[k]) for k, g in enumerate(graphs)], [dt] * len(graphs)


def cell_jumanji(dist: str, n: int, graphs, device):
    from rlsolver_tpu_torch.algos.jumanji_ppo import MPNNActorCritic, make_greedy_evaluator, train_spin_ppo
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv

    train_cfg, eval_cfg, ppo = jumanji_configs(n)
    train_g = generate_graph(GraphType(dist), n, seed=JUMANJI_TRAIN_SEED)
    train_env, eval_env = SpinSystemEnv(n, train_cfg), SpinSystemEnv(n, eval_cfg)
    t0 = time.time()
    params, _ = train_spin_ppo(train_env, train_g, ppo, device=device)
    ev = make_greedy_evaluator(eval_env, MPNNActorCritic(eval_cfg.num_observables, ppo.features, ppo.n_layers,
                                                         device=device))
    dt = (time.time() - t0) / len(graphs)  # the training only, as the JAX runner books it
    cuts = []
    for g in graphs:
        v = ev(params, g)
        cuts.append(rescored("jumanji", g, state_bits(ev.last_state), v))
    return cuts, [dt] * len(graphs)


def cell_dqn(alg: str, dist: str, n: int, graphs, device):
    from rlsolver_tpu_torch.algos.dqn import DQNAgent
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv

    train_cfg, eval_cfg, dcfg, steps = dqn_configs(alg, n)
    train_g = generate_graph(GraphType(dist), n, seed=DQN_TRAIN_SEED)
    agent = DQNAgent(SpinSystemEnv(n, train_cfg), dcfg, device=device)
    t0 = time.time()
    params, _, _ = agent.train_scan(train_g, steps)
    eval_agent = DQNAgent(SpinSystemEnv(n, eval_cfg), dcfg, device=device)
    dt = (time.time() - t0) / len(graphs)
    cuts = []
    for g in graphs:
        v = eval_agent.evaluate_scan(params, g)
        cuts.append(rescored(alg, g, state_bits(eval_agent.last_eval_state), v))
    return cuts, [dt] * len(graphs)


def cell_specb(n: int, graphs, device):
    from rlsolver_tpu_torch.classical.spectral_bound import maxcut_upper_bound_cell

    t0 = time.time()
    vals = maxcut_upper_bound_cell(graphs, specb_config(n), device=device)
    dt = (time.time() - t0) / len(graphs)
    return [float(v) for v in vals], [dt] * len(graphs)


def cell_isco(n: int, graphs, device):
    from rlsolver_tpu_torch.algos.isco import solve_maxcut_isco_cell

    t0 = time.time()
    bits, vals = solve_maxcut_isco_cell(graphs, isco_config(n), device=device)  # the dense energy
    dt = (time.time() - t0) / len(graphs)
    return [rescored("isco", g, b, v) for g, b, v in zip(graphs, bits, vals)], [dt] * len(graphs)


def cell_pignn(graphs, device, seed: int = 0):
    from rlsolver_tpu_torch.algos.pignn import PIGNNConfig, solve_maxcut_pignn_cell

    t0 = time.time()
    bits, vals = solve_maxcut_pignn_cell(graphs, PIGNNConfig(seed=seed), device=device)
    dt = (time.time() - t0) / len(graphs)
    return [rescored("pignn", g, b, v) for g, b, v in zip(graphs, bits, vals)], [dt] * len(graphs)


def cell_l2a(dist: str, n: int, graphs, device, train_over: Optional[dict] = None,
             eval_over: Optional[dict] = None):
    from rlsolver_tpu_torch.algos.l2a_distribution import evaluate_l2a_packed, train_l2a_distribution

    t0 = time.time()
    bundle = train_l2a_distribution(l2a_config(dist, n, **(train_over or {})), device=device)
    vals, xs = evaluate_l2a_packed(bundle, list(graphs), **{**l2a_eval_kwargs(n), **(eval_over or {})},
                                   return_xs=True)
    dt = (time.time() - t0) / len(graphs)
    return [rescored("l2a", g, x, v) for g, x, v in zip(graphs, xs, vals)], [dt] * len(graphs)


def run_cell(alg: str, dist: str, n: int, graphs, ids: Sequence[int], device, pignn_seed: int = 0):
    """One (dist, n, alg) cell over `graphs` (instance ids `ids`): (cuts, seconds)."""
    if alg == "mcpg":
        return cell_mcpg(graphs, device)
    if alg == "jumanji":
        return cell_jumanji(dist, n, graphs, device)
    if alg in ("eco", "s2v"):
        return cell_dqn(alg, dist, n, graphs, device)
    if alg == "specb":
        return cell_specb(n, graphs, device)
    if alg == "isco":
        return cell_isco(n, graphs, device)
    if alg == "pignn":
        return cell_pignn(graphs, device, seed=pignn_seed)
    if alg == "l2a":
        return cell_l2a(dist, n, graphs, device)
    return cell_classical(alg, graphs, ids, device)


# ---------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--dists", default="BA,ER,PL")
    p.add_argument("--algs", default="greedy,sa,ga,sdp,rw,mcpg,l2a")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--pignn-seed", type=int, default=0,
                   help="PI-GNN's seed (its cell's mean spreads about 1.3%% over seeds: a miss is held over 3 seeds, "
                        "the others' rows written to a CSV of their own)")
    p.add_argument("--redo", default="",
                   help="comma-separated algs whose cells (for --sizes/--dists/--ids) are re-run and APPENDED; "
                        "the summary keeps each instance's best row, so a cut-off run never empties a cell")
    args = p.parse_args(argv)

    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    dists = args.dists.split(",")
    algs = args.algs.split(",")
    ensure_csv(args.out)
    done = existing_rows(args.out)
    if args.redo:
        done -= {(d, n, i, a) for d in dists for n in sizes for i in range(args.ids) for a in args.redo.split(",")}

    for n in sizes:  # N outermost: a size's widths serve every distribution in turn
        for dist in dists:
            graphs = {}

            def get_graph(i):
                if i not in graphs:
                    graphs[i] = graph_from_name(f"{dist}_{n}_ID{i}")
                return graphs[i]

            for alg in algs:
                todo = [i for i in range(args.ids) if (dist, n, i, alg) not in done]
                if not todo:
                    continue
                print(f"== {dist}_{n} {alg} ({len(todo)} instances)", flush=True)
                kernel_launches(reset=True)
                try:
                    cuts, secs = run_cell(alg, dist, n, [get_graph(i) for i in todo], todo, device, args.pignn_seed)
                    for i, v, s in zip(todo, cuts, secs):
                        append_row(args.out, dist, n, i, alg, v, s)
                    print(f"   mean {sum(cuts) / len(cuts):.2f}, {sum(secs) / len(secs):.2f} s an instance; "
                          f"kernel launches {kernel_launches()}", flush=True)
                except Exception as e:  # keep the sweep going; log and move on
                    print(f"!! {dist}_{n} {alg} failed: {e!r}", flush=True)
                    if context_lost(e):  # every later cell of this process would fail
                        print("!! CUDA context lost - exiting for a fresh process to resume", flush=True)
                        raise SystemExit(EXIT_CONTEXT_LOST)
    print("done", flush=True)
    return 0


def bound_main(argv: Optional[List[str]] = None) -> int:
    """HiGHS's time-limited MILP per instance on the host: `milp` (its
    incumbent) and `milp_bound` (its dual bound) rows, resumable."""
    p = argparse.ArgumentParser(description=bound_main.__doc__)
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--dists", default="BA,ER,PL")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--time-limit", type=float, default=60.0)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.solvers.milp import solve_maxcut

    ensure_csv(args.out)
    done = existing_rows(args.out)
    for n in [int(s) for s in args.sizes.split(",")]:
        for dist in args.dists.split(","):
            for i in range(args.ids):
                if (dist, n, i, "milp") in done:
                    continue
                g = graph_from_name(f"{dist}_{n}_ID{i}")
                t0 = time.time()
                try:
                    r = solve_maxcut(g, time_limit=args.time_limit)
                except Exception as e:
                    print(f"!! {dist}_{n}_ID{i} milp failed: {e!r}", flush=True)
                    continue
                dt = time.time() - t0
                append_row(args.out, dist, n, i, "milp", r.obj, dt)
                append_row(args.out, dist, n, i, "milp_bound", r.bound, dt)
                print(f"{dist}_{n}_ID{i}: obj={r.obj:.0f} bound={r.bound:.0f} ({dt:.0f}s)", flush=True)
    print("done", flush=True)
    return 0
