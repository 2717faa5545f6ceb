"""Time the integer-weight sweep kernels of the PyTorch/CUDA port across
graph sizes: the numbers behind `K6_MIN_TILES_PER_SM`, `LIST_STAGE_ENTRIES`
and `FLIP_L2_SHARE` in rlsolver_tpu_torch/ops/kernels/engine.py.

    python3 scripts/torch_engine_share.py [--chains 24576,262144] [--sizes 2000,4000,...]
                                          [--edges-per-node 1,10] [--stages 128,256,1024,4096]
                                          [--flip-chains 768,2048] [--no-sweep] [--no-flip]

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

The 1-flip sweep, at each chain count of `--flip-chains` and each density:
K8a (the bit-planes read in place) against K8b (the neighbour lists in the
level schedule), in the order K8a, K8b, K8b, K8a, after a check that the
two give the same bits.

One JSON line per size; the last line gives, for each (edges per node,
chains), K6 over K7 by K6's tiles per SM and the fewest tiles per SM from
which K6 was faster at every size, the fastest stage at each size, and for
the 1-flip pair K8a over K8b by the planes' share of L2 and the sizes at
which K8a was the faster.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.core.generate import build_weighted_gnm  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import build, codec, engine  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as sw  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as wsw  # noqa: E402

def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def alternate(fn_a, fn_b):
    """Times of a and b, each the mean of two runs in the order a b b a,
    after one warm-up launch of each."""
    fn_a(), fn_b()
    ta1, tb1, tb2, ta2 = event_ms(fn_a), event_ms(fn_b), event_ms(fn_b), event_ms(fn_a)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


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


def flip_rows(args, l2, gen):
    rows = []
    for per_node in (int(x) for x in args.edges_per_node.split(",")):
        for n in (int(x) for x in args.sizes.split(",")):
            g = build_weighted_gnm(n, per_node * n, n, f"W{n}")
            w = codec.num_words(n)
            adj = wsw.WeightedAdjPlanes.build(g, "cuda")
            for b in (int(x) for x in args.flip_chains.split(",")):
                w0 = random_words(b, n, gen)

                def k8a(words):
                    wsw.WSWEEP_1FLIP.launch(adj.planes, adj.wdeg, adj.k, int(adj.signed), words, b, w, n)
                    return words

                def k8b(words):
                    wsw.WSWEEP_1FLIP_LEVELS.launch(adj.offsets, adj.entries, adj.level_nodes, adj.level_offsets,
                                                   adj.wdeg, words, b, w, adj.depth)
                    return words

                if not torch.equal(k8a(w0.clone()), k8b(w0.clone())):
                    raise AssertionError(f"N={n}, {b} chains: K8a and K8b differ")
                words = w0.clone()
                ta, tb = alternate(lambda: k8a(words), lambda: k8b(words))
                row = dict(n=n, edges=g.num_edges, depth=adj.depth, chains=b, flip_table_bytes=adj.planes.numel() * 4,
                           flip_share=adj.planes.numel() * 4 / l2, k8a_ms=ta, k8b_ms=tb)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del w0, words
            del adj
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", default="24576,262144")
    p.add_argument("--sizes", default="2000,3000,4000,5000,6000,7000,8000,10000")
    p.add_argument("--edges-per-node", default="1,10")
    p.add_argument("--stages", default="128,256,1024,4096")
    p.add_argument("--flip-chains", default="768,2048")
    p.add_argument("--no-sweep", action="store_true", help="skip the noisy-sweep pair")
    p.add_argument("--no-flip", action="store_true", help="skip the 1-flip pair")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_engine_share: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(["weighted_sweep.cu"])
    l2 = engine.l2_bytes("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sweeps = [] if args.no_sweep else sweep_rows(args, l2, gen)
    flips = [] if args.no_flip else flip_rows(args, l2, gen)

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
    if flips:
        by = {}
        for r in flips:
            by.setdefault(f"{r['edges'] // r['n']} edges/node, {r['chains']} chains", []).append(r)
        out["flip_k8a_over_k8b"] = {
            key: dict(by_share={round(r["flip_share"], 4): r["k8a_ms"] / r["k8b_ms"] for r in rs},
                      k8a_faster_at_n=[r["n"] for r in rs if r["k8a_ms"] < r["k8b_ms"]])
            for key, rs in by.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
