"""Converged instance-wise benchmark at published-Gset scale (counterpart of
`scripts/instance_wise.py`; reference protocol `README.md:344-350`).

Methods run on seeded stand-ins with the exact Gset sizes and densities under
a fixed time budget, and their cut-against-seconds curves are compared:

    G14like:  800 nodes,  4694 edges (seed 14)
    G22like: 2000 nodes, 19990 edges (seed 22)
    G49like / G50like: 3000-node 2-D toroidal grids (30 x 100, 50 x 60)
    G55like: 5000 nodes, 12468 edges (seed 55)
    G70like: 10000 nodes, 9999 edges (seed 70)

Algorithms: BLS (own baseline), MCPG with the per-instance gset presets (the
packed sweeps and the fused sampler), instance-wise L2A with the fused local
search, and ISCO. Parity bar: MCPG / L2A >= own BLS at every scale within
the budget.

Appends curve rows `instance,alg,seconds,obj` (each a new best) to
`results_quality/torch/instance_wise.csv`, resumable per (instance, alg).
Each (instance, alg) runs in a fresh process (the same command line with
`--inline`), so that an out-of-memory error or a lost CUDA context ends that
run alone. Every final best is checked against the host's float64 re-score
of its solution. `--summarize` prints the table.

    python scripts/torch_instance_wise.py [--insts G14like,...] [--algs bls,mcpg,l2a]
        [--budget 600] [--out PATH] [--device cpu] [--summarize [--compare REFERENCE_CSV]]
"""

from __future__ import annotations

import argparse
import collections
import csv
import dataclasses
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

from rlsolver_tpu_torch.eval import quality

INSTANCES = {
    # name: (nodes, edges, seed, mcpg preset key); G49/G50 are grids (seed unused)
    "G14like": (800, 4694, 14, "gset_14"),
    "G22like": (2000, 19990, 22, "gset_22"),
    "G49like": (3000, 6000, 0, "gset_22"),
    "G50like": (3000, 6000, 1, "gset_22"),
    "G55like": (5000, 12468, 55, "gset_55"),
    "G70like": (10000, 9999, 70, "gset_70"),
}
GRIDS = {"G49like": (30, 100), "G50like": (50, 60)}
OUT = os.path.join("results_quality", "torch", "instance_wise.csv")
HEADER = ["instance", "alg", "seconds", "obj"]
SUMMARY_ALGS = ["bls", "isco", "mcpg", "l2a"]
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD = "import sys; from rlsolver_tpu_torch.eval.instance_wise import main; sys.exit(main(sys.argv[1:]))"


def build_instance(name):
    from rlsolver_tpu_torch.core.generate import gnm_edges, grid_2d_periodic_edges
    from rlsolver_tpu_torch.core.graph import Graph

    n, m, seed, _ = INSTANCES[name]
    edges = grid_2d_periodic_edges(*GRIDS[name]) if name in GRIDS else gnm_edges(n, m, seed=seed)
    return Graph.from_edge_list(n, [(a, b, 1.0) for a, b in edges], name=name)


def done_pairs(path):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.reader(f):
                if row and row[0] != "instance":
                    done.add((row[0], row[1]))
    return done


class CurveWriter:
    def __init__(self, path, instance, alg):
        self.path, self.instance, self.alg = path, instance, alg
        self.t0 = time.time()
        self.best = -np.inf

    def add(self, obj, seconds=None):
        obj = float(obj)
        if obj <= self.best:
            return
        self.best = obj
        t = seconds if seconds is not None else time.time() - self.t0
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([self.instance, self.alg, f"{t:.1f}", f"{obj:.1f}"])


# ---------------------------------------------------------------- protocols
def bls_config(n: int):
    from rlsolver_tpu_torch.classical.bls import BLSConfig

    return BLSConfig(num_chains=1024 if n <= 2000 else 256, num_rounds=100000, seed=0, packed_sweep=True)


def mcpg_config(name: str):
    from rlsolver_tpu_torch.algos.mcpg import GSET_PRESETS

    return dataclasses.replace(GSET_PRESETS[INSTANCES[name][3]], sweep_mode="packed", sampler="fused",
                               max_epoch_num=10_000)


def l2a_config(n: int):
    """Sims, heads and embedding by N (attention is query-chunked, so sims
    scale with N); the fused local search refines every candidate with 8
    degree-ordered packed sweeps a rollout step. `IW_SEED` varies the seed
    of a repeated run."""
    from rlsolver_tpu_torch.algos.l2a import L2AConfig

    if n <= 1000:
        sims, reps, heads, embed = 256, 16, 4, 64
    elif n <= 3000:
        sims, reps, heads, embed = 128, 16, 4, 64
    else:
        sims, reps, heads, embed = 64, 16, 4, 32
    return L2AConfig(num_sims=sims, num_repeats=reps, num_heads=heads, top_k=max(16, n // 10), seq_len=8,
                     num_iters=10_000, embed_dim=embed, pretrain_steps=150 if n <= 2500 else 40, packed_sweep=True,
                     fused_ls=True, fused_sweeps=8, seed=int(os.environ.get("IW_SEED", "0")))


def isco_config(n: int):
    from rlsolver_tpu_torch.algos.isco import ISCOConfig

    return ISCOConfig(batch_size=256 if n <= 3000 else 64, chain_length=max(1000, 2 * n), seed=0)


def isco_mode(n: int) -> str:
    return "sparse" if n > 5000 else "dense"


# ------------------------------------------------------------------ runners
def run_bls(name, g, budget, out=OUT, device=None):
    from rlsolver_tpu_torch.classical.bls import solve_maxcut_bls

    w = CurveWriter(out, name, "bls")
    bits, best, _ = solve_maxcut_bls(g, bls_config(g.num_nodes), record=lambda i, b: w.add(b), time_budget=budget,
                                     device=device)
    return quality.rescored("bls", g, bits, best)


def run_mcpg(name, g, budget, out=OUT, device=None):
    from rlsolver_tpu_torch.algos.mcpg import solve_maxcut_mcpg

    w = CurveWriter(out, name, "mcpg")
    x, best, ev = solve_maxcut_mcpg(g, mcpg_config(name), time_budget=budget, verbose=True, device=device)
    for _, v, t in ev.records:
        w.add(v, seconds=t)
    return quality.rescored("mcpg", g, x, best)


def run_l2a(name, g, budget, out=OUT, device=None):
    from rlsolver_tpu_torch.algos.l2a import solve_maxcut_l2a

    w = CurveWriter(out, name, "l2a")
    x, best, ev = solve_maxcut_l2a(g, l2a_config(g.num_nodes), time_budget=budget, verbose=True, device=device)
    for _, v, t in ev.records:
        w.add(v, seconds=t)
    return quality.rescored("l2a", g, x, best)


def run_isco(name, g, budget, out=OUT, device=None):
    from rlsolver_tpu_torch.algos.isco import solve_maxcut_isco

    w = CurveWriter(out, name, "isco")
    n = g.num_nodes
    bits, best = solve_maxcut_isco(g, isco_config(n), mode=isco_mode(n), time_budget=budget,
                                   record=lambda i, b: w.add(b), device=device)
    return quality.rescored("isco", g, bits, best)


RUNNERS = {"bls": run_bls, "mcpg": run_mcpg, "l2a": run_l2a, "isco": run_isco}


# ------------------------------------------------------------------ summary
def best_rows(path) -> dict:
    """{(instance, alg): (best obj, its seconds)}."""
    best = collections.defaultdict(lambda: (-np.inf, 0.0))
    with open(path) as f:
        for row in csv.reader(f):
            if row and row[0] != "instance":
                k = (row[0], row[1])
                if float(row[3]) > best[k][0]:
                    best[k] = (float(row[3]), float(row[2]))
    return best


def summarize(path=OUT, reference: Optional[str] = None) -> None:
    """Prints each (instance, alg)'s best cut at its seconds; with a
    `reference` curve CSV (the JAX package's `results_quality/instance_wise.csv`),
    then each curve's final cut beside the reference curve's best at the same
    seconds and at its own end."""
    best = best_rows(path)
    names = sorted({k[0] for k in best})
    print(f"{'instance':10s} " + " ".join(f"{a:>14s}" for a in SUMMARY_ALGS))
    for nm in names:
        cells = []
        for a in SUMMARY_ALGS:
            v, t = best.get((nm, a), (np.nan, np.nan))
            cells.append(f"{v:8.0f}@{t:5.0f}s")
        print(f"{nm:10s} " + " ".join(f"{c:>14s}" for c in cells))
    if reference is None:
        return
    with open(reference) as f:
        ref_rows = [(r["instance"], r["alg"], float(r["seconds"]), float(r["obj"])) for r in csv.DictReader(f)]
    for (nm, a), (v, t) in sorted(best.items()):
        curve = [(s, o) for i, al, s, o in ref_rows if (i, al) == (nm, a)]
        if not curve:
            print(f"{nm} {a}: {v:.1f} at {t:.1f} s; no reference curve")
            continue
        at = max((o for s, o in curve if s <= t), default=float("nan"))
        end_s, end_o = max(curve, key=lambda so: so[1])[0], max(o for _, o in curve)
        print(f"{nm} {a}: {v:.1f} at {t:.1f} s; reference {at:.1f} by {t:.1f} s, {end_o:.1f} at {end_s:.1f} s "
              f"(final - reference at the same seconds {v - at:+.1f})")
    for nm in names:
        bls = best.get((nm, "bls"), (np.nan, 0.0))[0]
        for a in ("mcpg", "l2a"):
            if (nm, a) in best:
                v = best[(nm, a)][0]
                print(f"{nm} parity bar {a} >= bls: {v:.1f} vs {bls:.1f} -> {'holds' if v >= bls else 'FAILS'}")


# ---------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--insts", default="G14like,G22like,G70like")
    p.add_argument("--algs", default="bls,mcpg,l2a")
    p.add_argument("--budget", type=float, default=600.0)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--redo", default="",
                   help="comma-separated algs re-run for --insts and APPENDED (the summary keeps the best row)")
    p.add_argument("--summarize", action="store_true")
    p.add_argument("--compare", default=None, help="with --summarize: a reference curve CSV to print beside")
    p.add_argument("--inline", action="store_true",
                   help="run in this process (default: one process per (instance, alg))")
    args = p.parse_args(argv)
    if args.summarize:
        summarize(args.out, args.compare)
        return 0

    from rlsolver_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    quality.ensure_csv(args.out, HEADER)
    done = done_pairs(args.out)
    redo = [a for a in args.redo.split(",") if a]
    done -= {(i, a) for i in args.insts.split(",") for a in redo}
    for name in args.insts.split(","):
        g = None
        for alg in args.algs.split(","):
            if (name, alg) in done:
                continue
            print(f"== {name} {alg} (budget {args.budget:.0f}s)", flush=True)
            t0 = time.time()
            if not args.inline:
                cmd = [sys.executable, "-u", "-c", _CHILD, "--inline", "--insts", name, "--algs", alg,
                       "--budget", str(args.budget), "--out", os.path.abspath(args.out), "--device", str(device)]
                if alg in redo:  # the child reads `done` from the CSV anew
                    cmd += ["--redo", alg]
                path = os.pathsep.join(x for x in (_REPO, os.environ.get("PYTHONPATH")) if x)
                r = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=path))
                print(f"   subprocess exit {r.returncode}", flush=True)
                continue
            if g is None:
                g = build_instance(name)
            quality.kernel_launches(reset=True)
            try:
                best = RUNNERS[alg](name, g, args.budget, out=args.out, device=device)
                print(f"   -> best {best:.0f} in {time.time() - t0:.0f}s (the host's re-score of its solution); "
                      f"kernel launches {quality.kernel_launches()}", flush=True)
            except Exception as e:
                print(f"!! {name} {alg} failed: {e!r}", flush=True)
    print("done", flush=True)
    return 0
