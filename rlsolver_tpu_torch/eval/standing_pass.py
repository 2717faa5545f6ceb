"""Symmetric convergence pass for narrow-margin cells (counterpart of
`scripts/standing_pass.py`).

For each given (dist, N) cell it runs the SAME number of attempts for every
listed method (L2A and MCPG by default), each at the matched converged
budget and a seed of its own, appends a row per instance only where a
method improves its own current value (the summary keeps the best row), and
records every attempt (seed, seconds, the cell's average after merging) in
the `boost_log.csv` beside the CSV, which the table discloses. The cells run
`eval.quality`'s protocols with the pass's widths: the protocols are defined
once.

    python scripts/torch_standing_pass.py --cells BA:500,BA:600 [--attempts 2] [--algs l2a,mcpg] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import List, Optional

from rlsolver_tpu_torch.eval import quality


def current_vals(path, dist, n, alg):
    vals = {}
    if os.path.exists(path):
        with open(path) as f:
            for r in csv.reader(f):
                if r and r[0] == dist and r[1] == str(n) and r[3] == alg:
                    vals[int(r[2])] = float(r[4])  # later rows win
    return vals


def log_attempt(path, dist, n, alg, attempt, seed, seconds, avg):
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        wr = csv.writer(f)
        if new:
            wr.writerow(["dist", "n", "alg", "attempt", "seed", "seconds", "avg_obj"])
        wr.writerow([dist, n, alg, attempt, seed, f"{seconds:.1f}", f"{avg:.2f}"])


def append_improvements(path, dist, n, alg, vals, dt):
    old = current_vals(path, dist, n, alg)
    improved = 0
    with open(path, "a", newline="") as f:
        wr = csv.writer(f)
        for i, v in enumerate(vals):
            if float(v) > old.get(i, float("-inf")):
                wr.writerow([dist, n, i, alg, f"{float(v):.1f}", f"{dt:.1f}"])
                improved += 1
    merged = [max(float(v), old.get(i, float("-inf"))) for i, v in enumerate(vals)]
    return improved, sum(merged) / len(merged)


def _graphs(dist, n, ids):
    from rlsolver_tpu_torch.core.generate import graph_from_name

    return [graph_from_name(f"{dist}_{n}_ID{i}") for i in range(ids)]


def run_l2a(dist, n, ids, seed, args, device):
    t0 = time.time()
    vals, _ = quality.cell_l2a(dist, n, _graphs(dist, n, ids), device,
                               train_over=dict(num_iters=args.iters, seed=seed),
                               eval_over=dict(num_rounds=args.rounds, num_sims=args.eval_sims, seed=seed))
    return vals, time.time() - t0


def run_mcpg(dist, n, ids, seed, args, device):
    t0 = time.time()
    vals, _ = quality.cell_mcpg(_graphs(dist, n, ids), device, total_mcmc_num=args.mcpg_chains,
                                repeat_times=args.mcpg_repeats, max_epoch_num=args.mcpg_epochs, seed=seed)
    return vals, time.time() - t0


RUNNERS = {"l2a": run_l2a, "mcpg": run_mcpg}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", required=True, help="e.g. BA:500,BA:600,BA:700")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--attempts", type=int, default=2)
    p.add_argument("--algs", default="l2a,mcpg")
    p.add_argument("--seed-base", type=int, default=7)
    p.add_argument("--rounds", type=int, default=512)
    p.add_argument("--eval-sims", type=int, default=1024)
    p.add_argument("--iters", type=int, default=80)
    p.add_argument("--mcpg-epochs", type=int, default=10)
    p.add_argument("--mcpg-chains", type=int, default=512)
    p.add_argument("--mcpg-repeats", type=int, default=64)
    p.add_argument("--out", default=quality.OUT)
    p.add_argument("--boost-log", default=None, help="default: boost_log.csv beside --out")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from rlsolver_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    boost_log = args.boost_log or os.path.join(os.path.dirname(args.out), "boost_log.csv")
    quality.ensure_csv(args.out)
    for cell in args.cells.split(","):
        dist, n_s = cell.split(":")
        n = int(n_s)
        for attempt in range(args.attempts):
            seed = args.seed_base + attempt
            for alg in args.algs.split(","):
                try:
                    vals, dt = RUNNERS[alg](dist, n, args.ids, seed, args, device)
                except Exception as e:
                    print(f"!! {cell} {alg} attempt {attempt} failed: {e!r}", flush=True)
                    if quality.context_lost(e):
                        raise SystemExit(quality.EXIT_CONTEXT_LOST)
                    continue
                improved, avg = append_improvements(args.out, dist, n, alg, vals, dt / args.ids)
                log_attempt(boost_log, dist, n, alg, attempt, seed, dt, avg)
                print(f"{cell} {alg} attempt {attempt} (seed {seed}): improved {improved}/{args.ids}, cell avg "
                      f"{avg:.1f}, {dt:.0f}s", flush=True)
    return 0
