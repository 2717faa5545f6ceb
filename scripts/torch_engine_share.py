"""Time the integer-weight sweep kernels and K10 of the PyTorch/CUDA port
across graph sizes and densities: the numbers behind `K6_MIN_TILES_PER_SM`,
`LIST_STAGE_ENTRIES`, `K8A_MIN_NEIGHBOURS`, `K5_MAX_NEIGHBOURS` and
`FLIP_L2_SHARE` in rlsolver_tpu_torch/ops/kernels/engine.py, and K10's time
by density.

    python3 scripts/torch_engine_share.py [--chains 24576,262144] [--sizes 2000,4000,...]
                                          [--edges-per-node 1,10] [--stages 128,256,1024,4096]
                                          [--unit-sizes 2000,3000,...]
                                          [--flip-chains 768,2048] [--dense-edges 30,35,...,500]
                                          [--unit-flip-cells "2000:1,5,...,500;500:20,...,100;1000:20,...,50"]
                                          [--k10-densities 0.1,0.25,0.5,1.0]
                                          [--no-sweep] [--no-unit] [--no-flip] [--no-unit-flip] [--no-k10]

Needs one CUDA card. For each N and edge density, a seeded G(N, m) graph
with weights in +-{1..7} (3 signed planes, as the W22-like and W70-like
stand-ins; W22-like has 10 edges per node, W70-like 1) is swept on the card.

The noisy sweep, at each chain count of `--chains`: K6 (a block's chains in
shared memory) against K7 (chains in device memory, chain-minor; the
transposes in and out counted in its time) at the engine's stage, two fused
sweeps each (the first sweep and a later one), after a check that the two
give the same bits; each timed with CUDA events after a warm-up launch, in
the order K6, K7, K7, K6; then K7 at each stage of `--stages` (a warm-up
launch, then the mean of two). The chains are random words, made on the
card.

The noisy sweep on unit weights, at each chain count of `--chains`, with
each of `--edges-per-node` edges per node and at each of `--unit-sizes`:
K4 (each step's non-zero mask words, a block's chains in shared memory, the
tile K6 has) against K7 at the engine's stage, two fused sweeps each, after
a check that the two give the same bits, in the order K4, K7, K7, K4.

The 1-flip sweep, at each chain count of `--flip-chains`: K8a (each row's
non-zero bit-plane words, one warp a chain) against K8b (the neighbour
lists in the level schedule), in the order K8a, K8b, K8b, K8a, after a
check that the two give the same bits; on the sizes and densities above,
at N = 2000 with each of `--dense-edges` edges per node, and on D2000-like
(`build_d2000_like`, 10% of all pairs).

The unit-weight 1-flip sweep, at each chain count of `--flip-chains`: K5
(the signed lists in a level schedule, copied whole into each block's
shared memory) against K8a and K8b on the same graph's unit weights (one
plane), in the order K5, K8a, K8b, K8b, K8a, K5 (K5 only where its table
fits), after a check that the three give the same bits: on the cells of
`--unit-flip-cells`, N with its edges per node (by default N = 2000 from 2
to 1000 neighbours a node, N = 500 and 1000 at 40 to 200, where K5's
table fits at densities it cannot hold at N = 2000, and N = 4000 at 50 to
80, where K8a and K8b split the graphs whose table does not fit), and at
the largest N, in steps of 500, whose K5 table fits at one edge per node.

K10 at L2A's 2048 chains, on G22-like, F22-like and, for each of
`--k10-densities`, the share of all pairs of 2000 nodes drawn from the
complete graph `build_complete_f32(2000)` (weights uniform in [0.5, 1.5);
1.0 is the complete graph itself), after a check against the plain loop;
each launch first restores the input state, which is timed alone and taken
off. (The row mode that K10's lists replaced, timed here beside them while
it existed, lost at every density, the complete graph included: PERF.md.)

One JSON line per cell; the last line gives, for each (edges per node,
chains), K6 over K7 by K6's tiles per SM and the fewest tiles per SM from
which K6 was faster at every size, the fastest stage at each size; for the
unit pair K4 over K7 by the tile's tiles per SM; for the
1-flip pair K8a over K8b by neighbours per node (the table `plan_1flip` was
set from) and the cells where K8a was the faster; for the unit 1-flip
triple each cell's times and the cells where K5 was the fastest; and K10's
time by density.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.core.generate import (  # noqa: E402
    build_complete_f32, build_d2000_like, build_f22_like, build_g22_like, build_weighted_gnm, gnm_edges)
from rlsolver_tpu_torch.core.graph import Graph  # noqa: E402
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv  # noqa: E402
from rlsolver_tpu_torch.ops import cut  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import build, codec, engine  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as sw  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import sweep_kernel as sk  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as wsw  # noqa: E402

K10_CHAINS = 2048  # L2A's 256 sims x 8 repeats
K10_REPS = 5  # launches per timing

def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def alternate(*fns):
    """The time of each fn, the mean of two runs in the order a b .. b a,
    after one warm-up launch of each."""
    for fn in fns:
        fn()
    first = [event_ms(fn) for fn in fns]
    second = [event_ms(fn) for fn in reversed(fns)][::-1]
    return tuple((x + y) / 2 for x, y in zip(first, second))


def mean_ms(fn, runs: int = 2) -> float:
    fn()
    return sum(event_ms(fn) for _ in range(runs)) / runs


def random_words(b: int, n: int, gen) -> torch.Tensor:
    """Random chains [b, W] made on the card (no [b, n] bools: 2^20 chains of
    10000 nodes would take 10 GB)."""
    w = codec.num_words(n)
    words = torch.randint(-2**31, 2**31, (b, w), generator=gen, device="cuda", dtype=torch.int64).to(torch.int32)
    if n % 32:
        words[:, -1] &= (1 << (n % 32)) - 1
    return words


def sweep_rows(args, l2, gen):
    rows = []
    stages = [int(x) for x in args.stages.split(",")]
    for per_node in (int(x) for x in args.edges_per_node.split(",")):
        for n in (int(x) for x in args.sizes.split(",")):
            g = build_weighted_gnm(n, per_node * n, n, f"W{n}")
            tab = wsw.WeightedSweepTables.build(g, "cuda")
            thr1, thr2 = sw._noisy_thresholds(tab, 0.25)
            for b in (int(x) for x in args.chains.split(",")):
                w0 = random_words(b, n, gen)

                def run(words, stage):
                    return wsw.launch_sweep(tab, words, thr1, thr2, None, 7, 0.25, 2, stage)

                if not torch.equal(run(w0.clone(), None), run(w0.clone(), engine.LIST_STAGE_ENTRIES)):
                    raise AssertionError(f"N={n}, {b} chains: K6 and K7 differ")
                words = w0.clone()
                k6, k7 = alternate(lambda: run(words, None), lambda: run(words, engine.LIST_STAGE_ENTRIES))
                by_stage = {s: mean_ms(lambda: run(words, s)) for s in stages}
                row = dict(n=n, edges=g.num_edges, list_entries=tab.entries.shape[0], chains=b,
                           k6_tiles_per_sm=engine.k6_tiles_per_sm(n), chain_bytes=b * codec.num_words(n) * 4,
                           chain_share_of_l2=b * codec.num_words(n) * 4 / l2, k6_ms=k6, k7_ms=k7,
                           k7_ms_by_stage=by_stage)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del w0, words
            del tab
    return rows


def unit_rows(args, l2, gen):
    rows = []
    for per_node in (int(x) for x in args.edges_per_node.split(",")):
        for n in (int(x) for x in args.unit_sizes.split(",")):
            g = Graph.from_edge_list(n, [(a, b, 1.0) for a, b in gnm_edges(n, per_node * n, seed=n)], f"U{n}")
            tp, tw = sw.PackedSweepTables.build(g, "cuda"), wsw.WeightedSweepTables.build(g, "cuda")
            thr1, thr2 = sw._noisy_thresholds(tp, 0.25)
            w = codec.num_words(n)
            for b in (int(x) for x in args.chains.split(",")):
                w0 = random_words(b, n, gen)

                def k4(words):
                    sw.MCPG_SWEEP.launch(tp.nodes, thr1, thr2, tp.word_offsets, tp.word_entries, 0, None, 1, 7,
                                         0.25 / 65536.0, words, b, w, n, 2)
                    return words

                def k7(words):
                    return wsw.launch_sweep(tw, words, thr1, thr2, None, 7, 0.25, 2, engine.LIST_STAGE_ENTRIES)

                if not torch.equal(k4(w0.clone()), k7(w0.clone())):
                    raise AssertionError(f"U{n}, {b} chains: K4 and K7 differ")
                words = w0.clone()
                t4, t7 = alternate(lambda: k4(words), lambda: k7(words))
                row = dict(n=n, edges=g.num_edges, chains=b, k6_tiles_per_sm=engine.k6_tiles_per_sm(n),
                           word_list_bytes=sw.word_list_bytes(g), plan=engine.plan_sweep(g, l2)._asdict(),
                           k4_ms=t4, k7_ms=t7)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del w0, words
            del tp, tw
    return rows


def flip_graphs(args):
    """(edges per node, graph) of the 1-flip cells."""
    for per_node in (int(x) for x in args.edges_per_node.split(",")):
        for n in (int(x) for x in args.sizes.split(",")):
            yield per_node, build_weighted_gnm(n, per_node * n, n, f"W{n}")
    for per_node in (int(x) for x in args.dense_edges.split(",") if x):
        yield per_node, build_weighted_gnm(2000, per_node * 2000, 2000 + per_node, f"W2000x{per_node}")
    g = build_d2000_like()
    yield g.num_edges / g.num_nodes, g


def flip_rows(args, l2, gen):
    rows = []
    for per_node, g in flip_graphs(args):
        n = g.num_nodes
        w = codec.num_words(n)
        adj = wsw.WeightedAdjPlanes.build(g, "cuda")
        for b in (int(x) for x in args.flip_chains.split(",")):
            w0 = random_words(b, n, gen)

            def k8a(words):
                wsw.WSWEEP_1FLIP.launch(adj.word_offsets, adj.word_entries, adj.wdeg, adj.word_entries.shape[0] - 1,
                                        words, b, w, n)
                return words

            def k8b(words):
                wsw.WSWEEP_1FLIP_LEVELS.launch(adj.offsets, adj.entries, adj.level_nodes, adj.level_offsets,
                                               adj.wdeg, words, b, w, adj.depth)
                return words

            ref = k8b(w0.clone())
            if not torch.equal(k8a(w0.clone()), ref):
                raise AssertionError(f"{g.name}, {b} chains: K8a and K8b differ")
            words = w0.clone()
            ta, tb = alternate(lambda: k8a(words), lambda: k8b(words))
            row = dict(graph=g.name, n=n, edges=g.num_edges, edges_per_node=per_node,
                       neighbours_per_node=2 * g.num_edges / n, depth=adj.depth, chains=b,
                       word_entries_per_node=adj.word_entries.shape[0] / n,
                       word_entry_bytes=wsw.word_entry_bytes(g), word_entry_share=wsw.word_entry_bytes(g) / l2, plan=engine.plan_1flip(g, l2)._asdict(),
                       k8a_ms=ta, k8b_ms=tb)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del w0, words
        del adj
    return rows


def unit_graph(n: int, m: int, seed: int) -> Graph:
    """G(n, m) of `gnm_edges` with every weight 1."""
    e = np.sort(np.asarray(gnm_edges(n, m, seed=seed), np.int32).reshape(-1, 2), axis=1)
    return Graph(n, e, np.ones(e.shape[0], np.float32), f"U{n}x{2 * m // n}")


def unit_flip_graphs(args):
    """The unit 1-flip cells' graphs: each N of `--unit-flip-cells` at its
    edges per node, then the largest N (in steps of 500) whose K5 table
    fits at one edge per node."""
    for cell in args.unit_flip_cells.split(";"):
        n, spec = cell.split(":")
        for per_node in (int(x) for x in spec.split(",") if x):
            yield unit_graph(int(n), per_node * int(n), int(n) + per_node)
    n = 10000
    while engine.k5_fits(unit_graph(n + 500, n + 500, 1)):
        n += 500
    yield unit_graph(n, n, 1)


def unit_flip_rows(args, l2, gen):
    rows = []
    for g in unit_flip_graphs(args):
        n = g.num_nodes
        w = codec.num_words(n)
        fits = engine.k5_fits(g)
        adj = wsw.WeightedAdjPlanes.build(g, "cuda")
        lv = sw.LevelLists.build(g, "cuda") if fits else None
        for b in (int(x) for x in args.flip_chains.split(",")):
            w0 = random_words(b, n, gen)

            def k5(words):
                rec, ent, nbytes = lv.layout
                sw.SWEEP_1FLIP.launch(lv.table, nbytes, lv.depth, rec, ent, words, b, w)
                return words

            def k8a(words):
                wsw.WSWEEP_1FLIP.launch(adj.word_offsets, adj.word_entries, adj.wdeg, adj.word_entries.shape[0] - 1,
                                        words, b, w, n)
                return words

            def k8b(words):
                wsw.WSWEEP_1FLIP_LEVELS.launch(adj.offsets, adj.entries, adj.level_nodes, adj.level_offsets,
                                               adj.wdeg, words, b, w, adj.depth)
                return words

            fns = ([k5] if fits else []) + [k8a, k8b]
            ref = k8b(w0.clone())
            if any(not torch.equal(f(w0.clone()), ref) for f in fns):
                raise AssertionError(f"{g.name}, {b} chains: K5, K8a and K8b differ")
            words = w0.clone()
            times = alternate(*(lambda f=f: f(words) for f in fns))
            t5, ta, tb = ((None,) if not fits else ()) + times
            row = dict(graph=g.name, n=n, neighbours_per_node=2 * g.num_edges / n, depth=adj.depth, chains=b,
                       k5_fits=fits, k5_table_bytes=lv.table_bytes if fits else sw.level_table_bytes(g),
                       k5_depth=lv.depth if fits else None, plan=engine.plan_1flip(g, l2)._asdict(),
                       k5_ms=t5, k8a_ms=ta, k8b_ms=tb)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del w0, words
        del adj, lv
    return rows


def k10_graphs(args):
    yield build_g22_like()
    yield build_f22_like()
    complete = build_complete_f32(2000)
    rng = np.random.default_rng(2000)
    for d in (float(x) for x in args.k10_densities.split(",") if x):
        keep = rng.random(complete.num_edges) < d if d < 1.0 else np.ones(complete.num_edges, bool)
        yield Graph(complete.num_nodes, complete.edges[keep], complete.weights[keep], f"K2000x{d}")


def k10_rows(args, gen):
    rows = []
    for g in k10_graphs(args):
        n = g.num_nodes
        env = MaxcutEnv(g, "cuda")
        lists = env.f32_lists
        xs = torch.rand(K10_CHAINS, n, generator=gen, device="cuda") < 0.5
        state = (cut.signs_from_bits(xs), env.gains(xs), env.obj(xs))
        out = sk.sweep_1flip_f32(env.cg.adj, *state, lists)
        if not all(torch.equal(a, b) for a, b in zip(out, sk.sweep_1flip_f32_plain(env.cg.adj, *state))):
            raise AssertionError(f"{g.name}: K10 differs from the plain loop")
        accepted = out[0] != state[0]
        row_len = (lists.offsets[1:] - lists.offsets[:-1]).float()
        work = [t.clone() for t in state]

        def restore():
            for t, t0 in zip(work, state):
                t.copy_(t0)

        def run():
            restore()
            sk.SWEEP_1FLIP_F32.launch(lists.offsets, lists.entries, *work, K10_CHAINS, n)

        t_restore = mean_ms(restore, 4)
        ms = mean_ms(lambda: [run() for _ in range(K10_REPS)]) / K10_REPS - t_restore
        row = dict(graph=g.name, n=n, edges=g.num_edges, density=2 * g.num_edges / (n * (n - 1)),
                   chains=K10_CHAINS, accepted_flips=int(accepted.sum()),
                   listed_neighbours_of_accepted=float((accepted.float() @ row_len).sum()),
                   list_bytes=lists.entries.numel() * 4 + lists.offsets.numel() * 4, restore_ms=t_restore, k10_ms=ms)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del env, xs, state, out, work
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", default="24576,262144")
    p.add_argument("--sizes", default="2000,3000,4000,5000,6000,7000,8000,10000")
    p.add_argument("--edges-per-node", default="1,10")
    p.add_argument("--stages", default="128,256,1024,4096")
    p.add_argument("--unit-sizes", default="2000,3000,4000,5000,7000,10000,14000")
    p.add_argument("--flip-chains", default="768,2048")
    p.add_argument("--dense-edges", default="30,35,40,45,50,60,100,500")
    p.add_argument("--unit-flip-cells",
                   default="2000:1,5,10,15,20,25,30,35,40,50,100,250,500;500:20,25,30,35,40,50,75,100;"
                           "1000:20,25,30,35,40,50;4000:25,30,35,40")
    p.add_argument("--k10-densities", default="0.1,0.25,0.5,1.0")
    p.add_argument("--no-sweep", action="store_true", help="skip the noisy-sweep pair")
    p.add_argument("--no-unit", action="store_true", help="skip the unit-weight pair K4/K7")
    p.add_argument("--no-flip", action="store_true", help="skip the 1-flip pair")
    p.add_argument("--no-unit-flip", action="store_true", help="skip the unit 1-flip triple K5/K8a/K8b")
    p.add_argument("--no-k10", action="store_true", help="skip K10")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_engine_share: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for src, log in build.build_all(["mcpg_sweep.cu", "weighted_sweep.cu", "sweep_1flip_f32.cu"]).items():
        print(f"{src}: " + " | ".join(ln.strip() for ln in log.splitlines() if "Used " in ln or "spill" in ln),
              flush=True)
    l2 = engine.l2_bytes("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sweeps = [] if args.no_sweep else sweep_rows(args, l2, gen)
    units = [] if args.no_unit else unit_rows(args, l2, gen)
    flips = [] if args.no_flip else flip_rows(args, l2, gen)
    unit_flips = [] if args.no_unit_flip else unit_flip_rows(args, l2, gen)
    k10 = [] if args.no_k10 else k10_rows(args, gen)

    summary = {}
    for r in sweeps:
        summary.setdefault(f"{r['edges'] // r['n']} edges/node, {r['chains']} chains", []).append(r)
    k6_over_k7 = {}
    for key, rs in summary.items():
        faster = [r["k6_tiles_per_sm"] for r in rs if r["k6_ms"] <= r["k7_ms"]]
        k6_wins_from = min((t for t in sorted(set(faster))
                            if all(r["k6_ms"] <= r["k7_ms"] for r in rs if r["k6_tiles_per_sm"] >= t)), default=None)
        k6_over_k7[key] = dict(by_n={r["n"]: (r["k6_tiles_per_sm"], r["k6_ms"] / r["k7_ms"]) for r in rs},
                               k6_faster_from_tiles_per_sm=k6_wins_from,
                               fastest_stage={r["n"]: min(r["k7_ms_by_stage"], key=r["k7_ms_by_stage"].get)
                                              for r in rs})
    out = {"device": torch.cuda.get_device_name(0), "smi": smi, "l2_bytes": l2, "sweep_k6_over_k7": k6_over_k7}
    if units:
        by = {}
        for r in units:
            by.setdefault(f"{r['edges'] // r['n']} edges/node, {r['chains']} chains", []).append(r)
        out["unit_k4_over_k7"] = {key: {r["n"]: (r["k6_tiles_per_sm"], r["k4_ms"] / r["k7_ms"]) for r in rs}
                                  for key, rs in by.items()}
    if flips:
        by = {}
        for r in flips:
            by.setdefault(f"{r['chains']} chains", []).append(r)
        out["flip_k8a_over_k8b"] = {
            key: dict(by_neighbours_per_node=[(r["graph"], round(r["neighbours_per_node"], 1), r["depth"],
                                               r["k8a_ms"], r["k8b_ms"], r["k8a_ms"] / r["k8b_ms"])
                                              for r in rs],
                      k8a_faster=[r["graph"] for r in rs if r["k8a_ms"] < r["k8b_ms"]])
            for key, rs in by.items()}
    if unit_flips:
        out["unit_flip_k5_k8a_k8b"] = [(r["graph"], r["chains"], round(r["neighbours_per_node"], 1), r["depth"],
                                        r["k5_ms"], r["k8a_ms"], r["k8b_ms"]) for r in unit_flips]
        out["k5_fastest"] = [(r["graph"], r["chains"]) for r in unit_flips
                             if r["k5_ms"] is not None and r["k5_ms"] < min(r["k8a_ms"], r["k8b_ms"])]
    if k10:
        out["k10_by_density"] = [(r["graph"], round(r["density"], 4), r["accepted_flips"], r["k10_ms"]) for r in k10]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
