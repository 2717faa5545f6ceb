"""The JAX package's TSP, seq2seq, L2O, RUN-CSP and DCS runs on the CPU,
which `chip_smoke.py`'s `tsp` and `l2o` phases hold the port to.

    JAX_PLATFORMS=cpu python scripts/jax_tsp_l2o_reference.py [--only NAME ...]

Prints one JSON object, for seeds 0-2 where a run draws:
  pomo          `train_pomo(POMOConfig(seed=s))` (embed 128, 4 heads, 3 layers,
                batch 64, TSP20, 200 steps), then `infer_pomo` (x8, greedy)
                on `generate_tsp_coords(EVAL_SIZE, 20, seed=EVAL_SEED)`: the
                mean best length; `pomo_untrained` the same at the seeds'
                initial parameters (lr = 0);
  anneal        `TSPEnv.anneal` at its defaults (5000 steps, T 1 -> 1e-3,
                k-NN mix 0.5) from `random_tours(PRNGKey(s), 1024)` on the
                TSP100 instance `generate_tsp_coords(1, 100, seed=100)[0]`,
                then `two_opt_descent` (5000 steps) from its best tours: the
                best length after each, re-scored in float64;
  cli           the CLI's `run_tsp` for nn, christofides, karp_steele and
                cheapest_insertion on the TSP100 instance and on
                `generate_tsp_coords(1, 1000, seed=1000)[0]`, each written as
                '<index> <x> <y>' lines (`write_tsp`): the lengths;
  seq2seq, l2o  `--alg seq2seq` / `--alg l2o` on BA_100_ID0 at their default
                configs: the best cuts;
  runcsp        `RunCspSolver(maxcut, RunCspConfig(seed=s))` trained on
                BA_100_ID0..ID3 (50 epochs, 16 iterations), then
                `boosted_predict` (8 starts) on each of them: the four cuts,
                for seeds 0-9 (RUNCSP_SEEDS: its seeds' means spread widely);
  dcs           `DCS(DCSConfig(seed=s))` trained 300 epochs: `recovery_error()`;
                `dcs_untrained` the same before training.
"""

import _bootstrap  # noqa: F401  (sys.path + backend repair)

import argparse
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

SEEDS = (0, 1, 2)
RUNCSP_SEEDS = tuple(range(10))
EVAL_SIZE, EVAL_SEED = 128, 20
TSP_SEEDS = {100: 100, 1000: 1000}
CLI_ALGS = ("nn", "christofides", "karp_steele", "cheapest_insertion")


def write_tsp(path: str, coords: np.ndarray) -> None:
    """'<index> <x> <y>' lines, 1-indexed, each float at full precision."""
    with open(path, "w") as f:
        f.writelines(f"{i + 1} {x!r} {y!r}\n" for i, (x, y) in enumerate(coords.tolist()))


def pomo(out):
    from rlsolver_tpu.algos.am_pomo import POMOConfig, infer_pomo, init_pomo_state, make_pomo_step
    from rlsolver_tpu.core.generate import generate_tsp_coords
    from rlsolver_tpu.models.attention_tsp import AttentionTSP

    nodes = jnp.asarray(generate_tsp_coords(EVAL_SIZE, 20, seed=EVAL_SEED), jnp.float32)
    out.update(pomo=[], pomo_untrained=[], pomo_seconds=[], pomo_last_mean_length=[])
    for s in SEEDS:
        t0 = time.time()
        cfg = POMOConfig(seed=s)
        model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers)
        optimizer, step = make_pomo_step(model, cfg)
        state = init_pomo_state(model, cfg, optimizer)
        out["pomo_untrained"].append(float(np.mean(infer_pomo(model, state.params, nodes)[1])))
        jit_step = jax.jit(step)
        for _ in range(cfg.num_steps):
            state, metrics = jit_step(state)
        out["pomo"].append(float(np.mean(infer_pomo(model, state.params, nodes)[1])))
        out["pomo_last_mean_length"].append(float(metrics["mean_length"]))
        out["pomo_seconds"].append(time.time() - t0)


def anneal(out):
    from rlsolver_tpu.core.generate import generate_tsp_coords
    from rlsolver_tpu.core.io import tsp_distance_matrix
    from rlsolver_tpu.envs.tsp import TSPEnv
    from rlsolver_tpu.problems.objectives import obj_tsp

    dist = tsp_distance_matrix(generate_tsp_coords(1, 100, seed=TSP_SEEDS[100])[0])
    env = TSPEnv(dist)
    out.update(anneal=[], descent=[], anneal_seconds=[])
    for s in SEEDS:
        t0 = time.time()
        key = jax.random.PRNGKey(s)
        k_tours, k_anneal, k_desc = jax.random.split(key, 3)
        tours, lengths = env.anneal(k_anneal, env.random_tours(k_tours, 1024))
        b = int(jnp.argmin(lengths))
        out["anneal"].append(-obj_tsp(np.asarray(tours[b]), dist))
        tours, lengths = env.two_opt_descent(k_desc, tours)
        b = int(jnp.argmin(lengths))
        out["descent"].append(-obj_tsp(np.asarray(tours[b]), dist))
        out["anneal_seconds"].append(time.time() - t0)


def cli(out):
    from rlsolver_tpu.core.generate import generate_tsp_coords
    from rlsolver_tpu.run import run_tsp

    out["cli"], out["cli_seconds"] = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for n, seed in TSP_SEEDS.items():
            path = os.path.join(d, f"rand{n}.tsp")
            write_tsp(path, generate_tsp_coords(1, n, seed=seed)[0])
            for alg in CLI_ALGS:
                length, seconds = run_tsp(alg, path, 0)
                out["cli"][f"{alg}_{n}"] = length
                out["cli_seconds"][f"{alg}_{n}"] = seconds


def l2o(out):
    from rlsolver_tpu.algos.l2o import L2OConfig, Seq2SeqConfig, solve_maxcut_l2o, solve_maxcut_seq2seq
    from rlsolver_tpu.core.generate import graph_from_name

    g = graph_from_name("BA_100_ID0")
    out.update(seq2seq=[], l2o=[], seq2seq_seconds=[], l2o_seconds=[])
    for s in SEEDS:
        t0 = time.time()
        out["seq2seq"].append(float(solve_maxcut_seq2seq(g, Seq2SeqConfig(seed=s))[1]))
        out["seq2seq_seconds"].append(time.time() - t0)
        t0 = time.time()
        out["l2o"].append(float(solve_maxcut_l2o(g, L2OConfig(seed=s))[1]))
        out["l2o_seconds"].append(time.time() - t0)


def runcsp(out):
    from rlsolver_tpu.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver
    from rlsolver_tpu.core.generate import graph_from_name

    lang = ConstraintLanguage.maxcut()
    insts = [CSPInstance.from_graph(graph_from_name(f"BA_100_ID{i}"), lang, "NEQ") for i in range(4)]
    out.update(runcsp=[], runcsp_seconds=[])
    for s in RUNCSP_SEEDS:
        t0 = time.time()
        solver = RunCspSolver(lang, RunCspConfig(seed=s))
        params, _ = solver.train(insts)
        out["runcsp"].append([inst.num_clauses - solver.boosted_predict(params, inst)[1] for inst in insts])
        out["runcsp_seconds"].append(time.time() - t0)


def dcs(out):
    from rlsolver_tpu.algos.dcs import DCS, DCSConfig

    out.update(dcs=[], dcs_untrained=[], dcs_seconds=[])
    for s in SEEDS:
        t0 = time.time()
        model = DCS(DCSConfig(seed=s))
        out["dcs_untrained"].append(model.recovery_error())
        model.train()
        out["dcs"].append(model.recovery_error())
        out["dcs_seconds"].append(time.time() - t0)


RUNS = {"pomo": pomo, "anneal": anneal, "cli": cli, "l2o": l2o, "runcsp": runcsp, "dcs": dcs}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--only", nargs="*", default=list(RUNS), choices=list(RUNS))
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for name in args.only:
        RUNS[name](out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
