"""Time the in-place bit-plane kernels of the PyTorch/CUDA port against the
node-chunked ones, and the chunked ones at several chunk sizes: the numbers
behind `SWEEP_L2_SHARE`, `FLIP_L2_SHARE` and `MAX_CHUNK` in
rlsolver_tpu_torch/ops/kernels/engine.py.

    python3 scripts/torch_engine_share.py [--chains 33792] [--sizes 2000,4000,...]
                                          [--chunks 1,2,4,8,16,32]

Needs one CUDA card. For each N, a seeded G(N, 10N) graph with weights in
+-{1..7} (3 signed planes, as the W22-like and W70-like stand-ins) is swept
on the card by the in-place kernels and the node-chunked ones with the
engine's chunk: K6 against K7 (two fused sweeps, so the first sweep's
earlier plane and a later sweep are both in the time) and K8a against K8b
(one 1-flip sweep), each timed with CUDA events after a warm-up launch, in
the order in-place, chunked, chunked, in-place. Then K7 and K8b at each
chunk of `--chunks` whose two stages fit beside 32 chains (a warm-up launch,
then the mean of two). One JSON line per size gives the tables' bytes as a
share of the card's L2 and the times; the last line gives, for each pair,
the in-place over chunked ratios, the largest share at which the in-place
kernel was faster, the largest at which it was less than CLIFF_RATIO times
slower, and the fastest chunk at each size.
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

CLIFF_RATIO = 2.0  # in-place over chunked time that marks tables past the L2 cliff


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


def stages_fit(n: int, n_planes: int, chunk: int) -> bool:
    """Whether two stages of `chunk` rows fit beside the smallest tile (32
    chains) that the chunked kernels accept."""
    w = codec.num_words(n)
    return 32 * (w | 1) * 4 + 2 * n_planes * chunk * w * 4 <= build.header_constant("kMaxSmem")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", type=int, default=132 * 256)
    p.add_argument("--sizes", default="2000,3000,4000,5000,6000,7000,8000,10000")
    p.add_argument("--chunks", default="1,2,4,8,16,32")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_engine_share: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(["weighted_sweep.cu"])
    l2 = engine.l2_bytes(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for n in (int(x) for x in args.sizes.split(",")):
        g = build_weighted_gnm(n, 10 * n, n, f"W{n}")
        w, b = codec.num_words(n), args.chains
        tab = wsw.WeightedSweepTables.build(g, dev)
        adj = wsw.WeightedAdjPlanes.build(g, dev)
        p_sweep, p_flip = tab.planes.shape[0], adj.planes.shape[0]
        c_sweep, c_flip = engine.pick_node_chunk(n, p_sweep), engine.pick_node_chunk(n, p_flip)
        words = codec.pack_bits(torch.rand(b, n, generator=gen, device=dev) < 0.5)
        thr1, thr2 = sw._noisy_thresholds(tab, 0.25)
        sweep = (tab.nodes, thr1, thr2, tab.planes, tab.k, int(tab.signed), None, 1, 7, 0.25 / 65536.0,
                 words, b, w, n, 2)
        flip = (adj.planes, adj.wdeg, adj.k, int(adj.signed), words, b, w, n)
        k6, k7 = alternate(lambda: wsw.WSWEEP.launch(*sweep), lambda: wsw.WSWEEP_CHUNKED.launch(*sweep, c_sweep))
        k8a, k8b = alternate(lambda: wsw.WSWEEP_1FLIP.launch(*flip),
                             lambda: wsw.WSWEEP_1FLIP_CHUNKED.launch(*flip, c_flip))
        chunks = [c for c in (int(x) for x in args.chunks.split(",")) if c <= n]
        k7_by_chunk = {c: mean_ms(lambda: wsw.WSWEEP_CHUNKED.launch(*sweep, c))
                       for c in chunks if stages_fit(n, p_sweep, c)}
        k8b_by_chunk = {c: mean_ms(lambda: wsw.WSWEEP_1FLIP_CHUNKED.launch(*flip, c))
                        for c in chunks if stages_fit(n, p_flip, c)}
        row = dict(n=n, words=w, chains=b, sweep_table_bytes=tab.planes.numel() * 4,
                   sweep_share=tab.planes.numel() * 4 / l2, chunk_sweep=c_sweep, k6_ms=k6, k7_ms=k7,
                   flip_table_bytes=adj.planes.numel() * 4, flip_share=adj.planes.numel() * 4 / l2,
                   chunk_flip=c_flip, k8a_ms=k8a, k8b_ms=k8b, k7_ms_by_chunk=k7_by_chunk,
                   k8b_ms_by_chunk=k8b_by_chunk)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del tab, adj, words

    def up_to(shares):
        return max(shares) if shares else None

    def compare(share_key, in_place, chunked, by_chunk):
        ratios = [(r[share_key], r[in_place] / r[chunked]) for r in rows]
        return dict(ratios=ratios, in_place_faster_up_to_share=up_to([s for s, q in ratios if q < 1.0]),
                    below_cliff_up_to_share=up_to([s for s, q in ratios if q < CLIFF_RATIO]),
                    fastest_chunk={r["n"]: min(r[by_chunk], key=r[by_chunk].get) for r in rows if r[by_chunk]})

    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "l2_bytes": l2, "chains": args.chains,
                      "sweep_k6_over_k7": compare("sweep_share", "k6_ms", "k7_ms", "k7_ms_by_chunk"),
                      "flip_k8a_over_k8b": compare("flip_share", "k8a_ms", "k8b_ms", "k8b_ms_by_chunk")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
