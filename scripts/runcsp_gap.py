"""RUN-CSP's maxcut cell on the CPU, the JAX package beside the port, over
training seeds the card's check does not use (10-19 by default), with the
boost keys varied by seed: is the port's mean cut within the seeds' own
spread of JAX's?

    JAX_PLATFORMS=cpu python scripts/runcsp_gap.py [--side jax|port|both] [--seeds 10 11 ...]
    python scripts/runcsp_gap.py --pool run_a.log run_b.log

The cell: `RunCspConfig(seed=s)` trained on BA_100_ID0..3, then 8 boosted
predictions on each (boost i of seed s draws from key / generator seed
100 + 1000 s + i; the packages' own `boosted_predict` uses 100 + i for every
seed). The port runs from its own initial parameters, as on the card. Prints
each seed's four cuts and their mean per side, then one JSON line with both
sides' mean, the standard deviation of the per-seed means, the gap and its
standard error; `--pool` prints that line for the seeds of several runs.
"""

import _bootstrap  # noqa: F401  (sys.path + backend repair)

import argparse
import json
import time

import numpy as np


def jax_side(seeds):
    import jax

    from rlsolver_tpu.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver
    from rlsolver_tpu.core.generate import graph_from_name

    lang = ConstraintLanguage.maxcut()
    insts = [CSPInstance.from_graph(graph_from_name(f"BA_100_ID{i}"), lang, "NEQ") for i in range(4)]
    out = []
    for s in seeds:
        t0 = time.time()
        solver = RunCspSolver(lang, RunCspConfig(seed=s))
        params, _ = solver.train(insts)
        cuts = [inst.num_clauses - min(inst.count_conflicts(solver.predict(params, inst,
                                                                             jax.random.PRNGKey(100 + 1000 * s + i)))
                                       for i in range(8)) for inst in insts]
        out.append(cuts)
        print(f"jax seed {s}: {cuts} mean {np.mean(cuts)} ({time.time() - t0:.1f} s)", flush=True)
    return out


def port_side(seeds):
    import torch

    from rlsolver_tpu_torch.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver
    from rlsolver_tpu_torch.core.generate import graph_from_name

    lang = ConstraintLanguage.maxcut()
    insts = [CSPInstance.from_graph(graph_from_name(f"BA_100_ID{i}"), lang, "NEQ") for i in range(4)]
    out = []
    for s in seeds:
        t0 = time.time()
        solver = RunCspSolver(lang, RunCspConfig(seed=s), device="cpu")
        params, _ = solver.train(insts)
        cuts = [inst.num_clauses - min(inst.count_conflicts(solver.predict(
            params, inst, torch.Generator().manual_seed(100 + 1000 * s + i))) for i in range(8)) for inst in insts]
        out.append(cuts)
        print(f"port seed {s}: {cuts} mean {np.mean(cuts)} ({time.time() - t0:.1f} s)", flush=True)
    return out


def summary(per_side) -> dict:
    """Each side's per-seed means, their mean and standard deviation; with
    both sides, the gap (port less JAX) and its standard error."""
    result = {side: dict(per_seed=v, mean=float(np.mean(v)), std=float(np.std(v, ddof=1)))
              for side, v in per_side.items()}
    if len(result) == 2:
        result["gap"] = result["port"]["mean"] - result["jax"]["mean"]
        result["se_gap"] = float(np.sqrt(sum(result[side]["std"] ** 2 / len(result[side]["per_seed"])
                                             for side in ("jax", "port"))))
    return result


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--side", choices=("jax", "port", "both"), default="both")
    parser.add_argument("--seeds", nargs="+", type=int, default=list(range(10, 20)))
    parser.add_argument("--pool", nargs="+", metavar="LOG",
                        help="no run: pool the per-seed means of earlier runs' logs (their last line)")
    args = parser.parse_args()
    per_side = {}
    if args.pool:
        for path in args.pool:
            with open(path) as f:
                last = json.loads(f.read().strip().splitlines()[-1])
            for side in ("jax", "port"):
                if side in last:
                    per_side.setdefault(side, []).extend(last[side]["per_seed"])
    else:
        for side, run in (("jax", jax_side), ("port", port_side)):
            if args.side in (side, "both"):
                per_side[side] = [float(np.mean(c)) for c in run(args.seeds)]
    print(json.dumps(summary(per_side)))


if __name__ == "__main__":
    main()
