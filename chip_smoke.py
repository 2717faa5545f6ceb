"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  1. build   — nvcc builds every kernel source in rlsolver_tpu_torch/csrc for
               sm_90a, one compiler per source, all at once;
  2. check   — every kernel's wrapper runs on the card at its path's shapes
               and is held bit for bit against its plain PyTorch version:
               K2-K5 on the G22-like graph (N = 2000; 2^20 chains for the
               sampler and the sweep, 2048 for the warm start's 1-flip
               sweep); K5 (signed neighbour lists in a level schedule,
               copied into shared memory) also on a +-1 G22-like, on Hub3000's topology with unit and +-1
               weights and on a 10,000-node unit path, each against the
               sequential plain sweep, the f32 sweep and K8b; the engine's
               1-flip choice on D2000-like's topology with unit weights
               against K5's plain version; K6 on W22-like and K7 on W70-like (the plain sweep
               on 2048 chains and 2 sweeps); K4 in both modes on Hub3000's
               topology with unit and +-1 weights (a hub's list of many
               words, isolated nodes' empty lists); the 1-flip sweeps K8a
               (each row's non-zero plane words) on W22-like (forced),
               Hub3000 and D2000-like (10% of all pairs), and K8b (lists on a
               level schedule) on those and on W70-like and a 10,000-node
               path (10,000 levels), each against the sequential plain
               sweep, the f32 sweep and each other, on 2048 or 768 chains;
               fused K6 equals fused K7 (a small forced stage on W22-like,
               the engine's on W70-like's 24,576 chains) and, on G22-like
               with random +-1 signs, fused K4; on a hub graph with isolated
               nodes, whose hub's list spans several of K7's stages, K6 and
               K7 equal the plain sweep and each other; the fused sampler's
               marginals are checked against the policy; K10, the f32 1-flip
               sweep on each accepted flip's neighbour list, on L2A's 2048
               chains of G22-like (also against K5), F22-like (the same
               topology, weights uniform in [0.5, 1.5)) and the complete
               graph on 2000 nodes (s and vs bit for bit, gains as values);
               K11 and K12 (one ring kernel: the stream staged through
               shared memory by bulk copies) on 8192 chains x 1024 rounds
               of G22-like (the MH shapes of bench.py), on 1001 chains x
               1000 rounds with nodes -1 and N among the proposals, at
               N = 10000, and at N = 52,000, 55,000 and 58,000, where the
               ring shrinks to 2 stages, 1 and none; K11 against K12 on
               probs of the 2^-16 grid, and K11's marginals against the
               policy;
  3. stream  — K2, the injected-randomness twin of K3, which no solver path
               runs: `mh_sample_stream` alone on the main path's shapes, its
               launches counted in that run;
     injected — K11 and K12 likewise (`mh_sample_onehot`, `mh_sample_packed`)
               on the shapes of their check;
  4. main    — MCPG `--fast` (sampler="fused", sweep_mode="packed") on the
               G22-like instance with the gset_22 preset of GSET_PRESETS_40G
               (2048 x 512 = 2^20 chains), cut to one epoch of 4 rounds; the
               best cut must equal its host re-scoring and every kernel of the
               path must have launched;
  5. w22     — MCPG `--fast` on W22-like (the G22-like topology, integer
               weights in +-{1..7}) with the same preset, cut to 2 rounds:
               K3, K6 and the 1-flip kernel the engine's rule picks (K8b at
               20 neighbours a node) must launch, and no other sweep;
  6. w70     — MCPG `--fast` on W70-like (10000 nodes, 9999 edges, the same
               weights) with the gset_70 preset cut to 768 x 32 chains and 2
               rounds: the engine must pick K7, and K8b for its warm start's
               1-flip sweep; K3, K7, K8b must launch;
     d2000   — parallel local search with the packed 1-flip sweep on
               D2000-like (200 neighbours a node) at 2048 chains: the best
               cut must equal its host re-score, the kernel the rule picks
               (K8a) must be the only packed sweep launched, and K8a must
               have launched on some solver path;
  7. profile — device time by kernel of one --fast round on G22-like,
               W22-like and W70-like, and of the G22-like and W70-like
               solves' warm starts (their local-search rounds end in K5 and
               K8b; torch.profiler);
  8. l2a     — `solve_maxcut_l2a` on G22-like at the default widths of
               L2AConfig (256 sims x 8 repeats, top_k 16, 2 searchers, 4
               multi-flip iterations, embed 64, 4 heads, 2 encoder layers,
               mlp 256), depth cut as printed; every local search ends in K10,
               and the plain f32 loop is made to raise for the run; then the
               device time by kernel of one rollout step and one PPO update;
     l2a_dist — distribution-wise L2A at the BA_1000 cell of DIST_TABLE's
               L2A column (256 sims x 4 repeats, top_k 100, seq_len 8, embed
               32, 2 sweeps; training cut from 60 to 20 iterations of fresh
               BA graphs), then `evaluate_l2a_packed` (512 sims x 16 repeats,
               8 sweeps, 256 rounds) on BA_1000_ID0 and ID1; the
               plain sweep versions are made to raise for the run, K4 and
               the 1-flip kernel the rule picks must launch and no other
               sweep, every best cut must equal its host re-score, and the
               cuts are printed beside the JAX package's
               (results_quality/dist_table.csv); then the device time by
               kernel of one training iteration and one eval round;
     mcpg_multi — `mcpg_multi.solve_mcpg(sampler="fused")` at 256 chains x
               32 repeats = 8192 samples a round, depth cut to 2 rounds, on
               maxcut_edge, the +-1 and the binary QUBO (`maxcut_to_qubo`)
               and the r-Cheeger cut of G22-like, a uniform random 3-SAT of
               SATLIB's uf250-1065 shape, MIMO detection at 400 x 400 and
               10 dB (with ZF's and MMSE's bit error rates) and a 2000-item
               subset-sum with 8 tags: K3 must launch in every solve, equal
               its plain version on the first 256 chains at each problem's
               (N, 8192 chains, MH rounds), and every best score its float64
               host re-score; then the device time by kernel of one QUBO and
               one MaxSAT round (`run_mcpg_multi`);
     mcpg_batch — `solve_maxcut_mcpg_batched` with DIST_TABLE's MCPG protocol
               (256 x 32 chains, 8 sweeps, 6 epochs of 8 rounds) at full
               depth on BA_100_ID0..9 and, cut to 2 epochs, on
               BA_1000_ID0..9, each family in one call: best cuts equal to
               their host re-scores, printed
               beside the JAX run's (results_quality/dist_table.csv); the
               device time of one BA_1000 round; then one round of MCPG's
               colored sweep mode on G22-like beside one of the sequential
               mode, their best cuts within 2% (`run_mcpg_batch`);
     baselines — DIST_TABLE's classical columns, ISCO and PI-GNN at
               scripts/quality_table.py's budgets and cell protocols
               (`run_baselines`): Greedy on BA_100_ID0..9 and BA_1000_ID0..9,
               each cut equal to dist_table.csv's; RandomWalk, SDP, SA (256
               chains x max(2000, 12 N) steps) and GA (40 / 64 generations, K10
               each generation) on BA_100_ID0..9, SA and GA also on
               BA_1000_ID0..3; the ISCO cell (256 x 600 on BA_100, 96 x 2000 on
               BA_1000_ID0..9); the PI-GNN cell and the spectral-bound cell
               (4000 iterations) on BA_100; BLS with the packed warm start (K5)
               on G22-like at 1024 chains for 15 s, its curve beside
               results_quality/instance_wise.csv's. Every best cut equals its
               host re-score; each column's mean is at least JAX's over the
               same instances less 1%; every certified bound is at or above
               the largest cut dist_table.csv holds for its instance and their
               mean at most JAX's plus 1%; GA launches K10 and no packed sweep,
               BLS the engine's 1-flip kernel (K5) and no other sweep, every
               other solver no kernel; then K10 at GA's shape (128 chains,
               BA_1000_ID0) and K5 at BLS's warm-start shape (1024 chains,
               G22-like) equal their plain versions, and the device time of
               100 SA steps and 20 ISCO steps (BA_1000);
     eco     — the committed ECO-DQN network (results_quality/eco_params_BA.pkl,
               loaded by `convert.load_flax_pickle` without JAX) in bf16 at
               scripts/eco_distribution.py's protocol (50 envs at N <= 500,
               else 32; basin reward 1/N, stagnation punishment 0.01), one
               greedy restart of `evaluate_scan` on BA_100_ID0..9 and, cut
               from ten instances to four, BA_1000_ID0..3: every best cut
               equal to the host re-score of its best spins, each size's mean
               at least the JAX run's mean over the same instances less 1%
               (280.4 on BA_100), the cuts beside the JAX run's, the seconds
               per rollout step and per instance, and the device time of the
               first 100 steps of a BA_1000 rollout (`run_eco`);
     s2v     — S2V-DQN at scripts/quality_table.py:228-284's protocol on BA_100
               at full depth (`train_scan` of 6144 loop steps, 32 envs, the
               irreversible S2V env), then one greedy rollout on each of
               BA_100_ID0..9: cuts equal to their host re-scores, mean above
               the RandomWalk column's 234.8, printed beside the JAX run's
               (within 2% expected, not enforced) (`run_s2v`);
     jumanji — `train_spin_ppo` at scripts/quality_table.py:171-227's protocol
               on BA_100 at full depth (128 envs x 200 steps, 100 iterations),
               then `make_greedy_evaluator` at 64 envs on BA_100_ID0..9, with
               the s2v phase's checks (`run_jumanji`);
     pattern1 — bench.py:38-268's `pattern1_peco` on the port (BA_800_ID0,
               MPNN(64, 3), env counts 512-4096 through `find_best_num_sims`,
               the env-only twin, the host CPU twin, DQN train steps/s; then
               bf16 over the f32 winner x1, x2, x4), one JSON line with
               bench.py's key names, the device time of one f32 block, and a
               DQN `train_runner` whose mid-way `torch.save` checkpoint must
               restore bit for bit (`run_pattern1`); no kernel of the port
               lies on these four phases' path, and their launches are
               counted and printed;
  9. cli     — `python -m rlsolver_tpu_torch --alg mcpg --fast` on BA_100_ID0
               and on W22-like written as a gset file, and `--alg l2a` and
               `--alg local_search` on BA_100_ID0 with and without `--fast`;
               then the CLI's `main` in this process with `--alg sa`,
               `--alg isco` and `--alg ga` on BA_100_ID0;
 10. time    — kernel, plain-version and bound times at each path's shapes
               (K7's with its transposes; K8a on D2000-like, the d2000
               phase's graph and chains), K6 on G22-like's own lists beside
               K4, K8b beside K5 on G22-like, and K8a beside K8b on
               D2000-like and W22-like (forced); a bit-plane sweep's bound counts the
               popcounts its tables' non-zero words need and, per warp and
               step, reads of those words and of the distinct chain words
               they meet (K8a's bytes: its word entries); K6's, K7's and
               K8b's bound is the least of that and the neighbour-list
               reckoning (a bit extract and a multiply-add per neighbour,
               reads of the distinct neighbour words and of the list), and
               K5's too; K11's chain floor (its dependent rounds at an
               assumed shared-memory latency) is printed on a line of its
               own, not in the kernels line;
               K10's counts one f32 FMA per listed neighbour of each
               accepted flip, its bytes the state in and out and the lists;
               `dense_bound_ms` (every word; K10: every rank-1 update over
               the dense rows) beside it.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Peak integer rates: results per clock per SM from the CUDA C++ Programming
# Guide's table of arithmetic-instruction throughput for compute capability
# 9.0 (64 for 32-bit integer add, logic, shift, compare and multiply; 16 for
# population count), times the card's SM count and the H100 SXM's 1.98 GHz
# boost clock, at which its published 67 TFLOP/s of float32 is
# 132 SMs x 128 lanes x 2 flops. Every instruction of a warp, a broadcast
# load of one table word included, takes a slot of one of the SM's four warp
# schedulers, each of which dispatches at most one instruction per clock.
BOOST_CLOCK_HZ = 1.98e9
INT32_PER_SM_CLOCK = 64
POPC_PER_SM_CLOCK = 16
WARP_INSTR_PER_SM_CLOCK = 4
FP32_PER_SM_CLOCK = 128  # f32 add or multiply results (same table)

# integer operations per unit of work, counted from the kernels' sources
PHILOX_OPS = 100  # one Philox4x32-10 call (4 draws)
K2_OPS = 6  # per proposal: word/bit/acc2 decode, read bit, flip
K3_OPS = 12 + PHILOX_OPS // 4  # per proposal: node/u16, bit, threshold compare, flip + draws
WORD_INT_OPS = 2  # AND and add per word of a popcount (and one popcount)
NBR_INT_OPS = 2  # per neighbour of a list: bit extract, multiply-add
LIST_READ_BYTES = 16  # a warp reads the list 16 bytes (two entries) at a time
STEP_OPS = 10  # per sweep step: compare, bit set, loop
W70_CHAINS, W70_REPEATS = 768, 32  # gset_70's C, with R cut from 288 to 32
# K10, per gain of an accepted flip: one f32 result. The product
# (-2 s_i) s_j A_ij is exact, so one FMA of it gives the plain loop's bits,
# and the sign s_j needs no operation of its own per gain: kept in the gain
# (h_j = s_j g_j), the update is h_j = fma(-2 s_i, A_ij, h_j), which rounds
# as the plain loop does (round to nearest is odd-symmetric).
K10_F32_OPS = 1
K10_STEP_OPS = 2  # per (chain, node): the compare and the add to the cut
K11_OPS = 10 + 3  # per proposal: node/word/bit decode, read bit, flip; q, u*q, 1-q in f32
# K11's chain floor: each chain's rounds depend on each other through its
# state, and a round makes 3 dependent shared-memory accesses (the ring's
# node, the state word, its store), each taken at an assumed 30 cycles, a
# published microbenchmark figure for Hopper's shared memory that this
# script does not measure
K11_CHAIN_ACCESSES = 3
SMEM_LATENCY_CYCLES = 30
MH_CHAINS, MH_ROUNDS = 8192, 1024  # the MH shapes of bench.py
FORCED_STAGE = 100  # K7's list entries per stage in the checks that force it small
FLIP_KERNELS = {False: "sweep_1flip_weighted", True: "sweep_1flip_weighted_levels"}  # by FlipPlan.levels
SWEEPS = ("mcpg_sweep", "mcpg_sweep_weighted", "mcpg_sweep_weighted_chunked",
          "sweep_1flip", "sweep_1flip_weighted", "sweep_1flip_weighted_levels")
# Distribution-wise L2A at the BA_1000 cell of DIST_TABLE's L2A column, as
# scripts/quality_table.py:349-371 runs it (the training cut from 60 to 20
# iterations to leave the script's time limit room for the Pattern I
# phases): the training config, then the packed evaluator's budget
DIST_TRAIN = dict(num_nodes=1000, num_sims=256, num_repeats=4, top_k=100, seq_len=8, num_iters=20, embed_dim=32,
                  pretrain_steps=100, ls_sweeps=2, num_validation=0)
DIST_EVAL = dict(num_rounds=256, num_sims=512, num_repeats=16, num_sweeps=8)
DIST_INSTANCES = ("BA_1000_ID0", "BA_1000_ID1")
DIST_PLAIN = 2048  # of the eval's candidates, those the plain K4 sweep checks (N * sweeps Python steps)


def build_hub_graph():
    """A 3000-node graph with weights in +-{1..7}: node 0 joined to 2400
    others (a list of many stages), 3000 random edges among nodes 1..2899,
    and nodes 2900..2999 isolated (empty lists)."""
    import numpy as np
    from rlsolver_tpu_torch.core.graph import Graph
    rng = np.random.default_rng(2026)
    pairs = {(0, int(j)) for j in rng.choice(np.arange(1, 2900), size=2400, replace=False)}
    while len(pairs) < 5400:
        a, b = sorted(int(x) for x in rng.integers(1, 2900, size=2))
        if a != b:
            pairs.add((a, b))
    w = rng.integers(1, 8, size=len(pairs)) * rng.choice((-1, 1), size=len(pairs))
    return Graph.from_edge_list(3000, [(a, b, float(x)) for (a, b), x in zip(sorted(pairs), w)], name="Hub3000")


def build_path_graph(n: int = 10000):
    """The path 0 - 1 - ... - (n-1) with weights in +-{1..7}: node i's level
    is i, so K8b's schedule is n levels of one node."""
    import numpy as np
    from rlsolver_tpu_torch.core.graph import Graph
    rng = np.random.default_rng(10)
    w = rng.integers(1, 8, size=n - 1) * rng.choice((-1, 1), size=n - 1)
    return Graph.from_edge_list(n, [(i, i + 1, float(x)) for i, x in enumerate(w)], name=f"Path{n}")


def phase(name, t0):
    print(f"phase {name} ok {time.time() - t0:.2f}s (sm clock, its max, power, temperature: {smi_clocks()})",
          flush=True)


def smi_clocks() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms of fn() over reps calls (CUDA events), after one warm-up call."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, int_ops: float, popc_ops: float, warp_reads: float = 0.0, f32_ops: float = 0.0):
    """Least ms for the work: the largest of the bytes over the memory rate,
    the integer operations over the INT32 rate, the popcounts over the
    popcount rate, the warp-wide table reads over the warp schedulers' rate
    and the f32 operations over the FP32 rate (the pipes may overlap, so
    their times do not add)."""
    sm_clock = torch.cuda.get_device_properties(0).multi_processor_count * BOOST_CLOCK_HZ
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(int_ops / (INT32_PER_SM_CLOCK * sm_clock), popc_ops / (POPC_PER_SM_CLOCK * sm_clock),
                warp_reads / (WARP_INSTR_PER_SM_CLOCK * sm_clock), f32_ops / (FP32_PER_SM_CLOCK * sm_clock))
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nonzero(t: torch.Tensor) -> int:
    return int(torch.count_nonzero(t))


def plane_reads(planes: torch.Tensor) -> int:
    """Warp-wide reads a step needs from bit-planes [P, N, W], summed over
    the rows: each non-zero table word (a broadcast), and each distinct
    chain word it meets, once however many planes are non-zero there."""
    nz = planes != 0
    return int(nz.sum()) + int(nz.any(dim=0).sum())


def list_reads(offsets: torch.Tensor, entries: torch.Tensor) -> int:
    """Warp-wide reads a sweep needs from neighbour lists: each step's
    distinct neighbour words, and the list 16 bytes at a time."""
    n = offsets.numel() - 1
    steps = torch.repeat_interleave(torch.arange(n, device=offsets.device), (offsets[1:] - offsets[:-1]).long())
    distinct = torch.unique(steps * (n // 32 + 1) + (entries[:, 0].long() >> 5)).numel()
    return distinct + -(-(entries.numel() * 4) // LIST_READ_BYTES)


def scan_work(chains: int, sweeps: int, needed, dense, read):
    """Totals over `sweeps` sweeps (the first, then sweeps - 1 later ones) of
    counts per sweep given as (first, later) pairs: `needed`, the popcounts
    a chain needs, one per non-zero table word it meets (summed over the
    sweep's rows, so the graph's sparsity counts); `dense`, the popcounts of
    a scan of every word; `read`, the warp-wide reads the needed words take
    (`plane_reads`), once per warp of 32 chains. -> (needed, dense, warp
    reads)."""
    def total(pair):
        return pair[0] + (sweeps - 1) * pair[1]
    return chains * total(needed), chains * total(dense), -(-chains // 32) * total(read)


def require_equal(name, a, b, errs, key):
    """Exact check of a kernel's output against its plain version; keeps
    the largest |difference| seen for each kernel (0 when it passes)."""
    if a.dtype == torch.bool:
        err = float((a != b).any())  # bits: max |a - b| is 0 or 1
    else:
        err = float((a.double() - b.double()).abs().max())
    errs[key] = max(errs.get(key, 0.0), err)
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain version differ in {int((a != b).sum())} entries")
    print(f"  {name}: {'bit-exact' if a.dtype == torch.bool else 'equal values'} ({tuple(a.shape)})", flush=True)


def profile_device(label: str, fn, top: int = 12) -> None:
    """Prints the wall time of one fn() (ending in a synchronize), the device
    busy time and its share, and the device time of the top kernels
    (torch.profiler device events; the CPU ops that launched them carry
    the same device time again and are left out)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    dev_events = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    dev_events.sort(key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in dev_events)
    print(f"  {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, count in dev_events[:top]:
        print(f"    {ms:9.2f} ms {100 * ms / wall_ms:5.1f}%  x{count:<5d} {key[:90]}")


def jax_alg_runs(alg: str, n: int, dist: str = "BA"):
    """The JAX package's runs of `alg` on dist_n in
    results_quality/dist_table.csv, in file order: each run a list of its
    ten cuts by instance id (a run is a block of rows for ids 0..9)."""
    import csv
    runs, cur = [], {}
    with open(os.path.join(REPO, "results_quality", "dist_table.csv")) as f:
        for r in csv.DictReader(f):
            if r["dist"] == dist and r["n"] == str(n) and r["alg"] == alg:
                cur[int(r["id"])] = float(r["obj"])
                if len(cur) == 10:
                    runs.append([cur[i] for i in range(10)])
                    cur = {}
    return runs


def run_l2a_dist(dev, errs: dict) -> dict:
    """Distribution-wise L2A at BA_1000's widths: trains the policy across
    fresh BA graphs (the 1-flip kernel of the rule in every update), then
    runs the packed evaluator (K4) on DIST_INSTANCES, the plain sweep
    versions made to raise. Checks every best cut against its host
    re-score and the launches, prints the times, peak memory and the cuts
    beside the JAX package's, then holds the path's 1-flip kernel and K4
    against their plain versions at the path's shapes (into `errs`), and
    prints the device time by kernel of one training iteration and one
    eval round. Returns the launch counts."""
    from rlsolver_tpu_torch.algos import l2a_distribution as l2d
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.ops.kernels import build, codec, engine, mcpg_sweep as sw, sweep_kernel as sk
    from rlsolver_tpu_torch.ops.kernels import weighted_sweep as wsw
    from rlsolver_tpu_torch.optim import ClippedAdam
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    cfg = l2d.L2ADistConfig(graph_type=GraphType.BA, **DIST_TRAIN)
    print(f"  L2ADistConfig {DIST_TRAIN}, then evaluate_l2a_packed {DIST_EVAL}: training cut from 60 to "
          f"{cfg.num_iters} iterations", flush=True)
    l2 = engine.l2_bytes(dev)
    graphs = [graph_from_name(name) for name in DIST_INSTANCES]
    sweep_plan, flip_plan = engine.plan_sweep(graphs[0], l2), engine.plan_1flip(graphs[0], l2)
    flip_k = FLIP_KERNELS[flip_plan.levels] if flip_plan.weighted else "sweep_1flip"
    sweep_k = ("mcpg_sweep_weighted_chunked" if sweep_plan.node_chunk else "mcpg_sweep_weighted") \
        if sweep_plan.weighted else "mcpg_sweep"
    print(f"  {DIST_INSTANCES[0]}: sweep plan {sweep_plan}, 1-flip plan {flip_plan} (the training graphs' family)")

    def plain_sweep_on_the_card(*args, **kwargs):
        raise AssertionError("a plain sweep version ran on the card")

    plains = [(sk, "sweep_1flip_f32_plain"), (sw, "_sweep_1flip_plain"), (wsw, "_sweep_1flip_plain"),
              (sw, "_sweep_plain"), (wsw, "_wsweep_plain")]
    saved = [getattr(m, a) for m, a in plains]
    for m, a in plains:
        setattr(m, a, plain_sweep_on_the_card)
    build.reset_counts()
    train_t, eval_t = {}, {}
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    try:
        torch.cuda.reset_peak_memory_stats()
        bundle = l2d.train_l2a_distribution(cfg, device=dev, timings=train_t)
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vals, best = l2d.evaluate_l2a_packed(bundle, graphs, seed=0, return_xs=True, timings=eval_t, **DIST_EVAL)
        torch.cuda.synchronize()
        eval_peak = torch.cuda.max_memory_allocated()
    finally:
        for (m, a), fn in zip(plains, saved):
            setattr(m, a, fn)
    counts = {k.name: k.launches for k in build.KERNELS}
    iters, blocks = train_t["iteration"], eval_t["block"]
    per_round = [t / 8 for t in blocks]  # evaluate_l2a_packed's blocks of 8 rounds
    def spread(ts):
        """first, then min / median / mean / max of the rest"""
        rest = ts[1:] or ts
        return (f"first {ts[0]:.4f}, then min {min(rest):.4f} median {np.median(rest):.4f} mean "
                f"{np.mean(rest):.4f} max {max(rest):.4f}")

    print(f"  pretrain {train_t['pretrain'][0]:.3f} s; seconds per training iteration: {spread(iters)}; "
          f"losses {[round(h['loss'], 4) for h in bundle['history'][:3]]}..{round(bundle['history'][-1]['loss'], 4)}")
    print(f"  eval: {len(blocks)} blocks of 8 rounds of {DIST_EVAL['num_sims']} x {DIST_EVAL['num_repeats']} = "
          f"{DIST_EVAL['num_sims'] * DIST_EVAL['num_repeats']} candidates; seconds per round: {spread(per_round)}")
    print(f"  max_memory_allocated: training {train_peak / 2**30:.2f} GiB, eval {eval_peak / 2**30:.2f} GiB, each "
          f"with the {base / 2**30:.2f} GiB that earlier phases hold; launches {counts}")
    jax_cuts = dict(enumerate(jax_alg_runs("l2a", 1000)[0]))  # the campaign's own run
    lo, hi = min(jax_cuts.values()), max(jax_cuts.values())
    for name, g, v, x in zip(DIST_INSTANCES, graphs, vals, best):
        host = obj_maxcut(x.astype("int64"), g)
        gid = int(name.split("_ID")[1])
        print(f"  {name}: best cut {v} host re-score {host}; JAX {jax_cuts[gid]} (JAX over ids 0-9: {lo}-{hi}; "
              f"port - JAX {v - jax_cuts[gid]:+.0f}{', below' if v < lo else ', above' if v > hi else ', within'} "
              f"the JAX spread)")
        if host != v:
            raise AssertionError(f"l2a_dist: best cut {v} != host re-score {host} on {name}")
    for k in (sweep_k, flip_k):
        if counts[k] <= 0:
            raise AssertionError(f"l2a_dist did not launch {k}")
    wrong = [k for k in SWEEPS if k not in (sweep_k, flip_k) and counts[k]]
    if wrong or counts["sweep_1flip_f32"]:
        raise AssertionError(f"l2a_dist: other sweeps than the rule's ran: {wrong} sweep_1flip_f32 "
                             f"{counts['sweep_1flip_f32']}")

    # the path's two kernels against their plain versions at the path's own
    # shapes (the plain versions restored): the 1-flip kernel on a training
    # graph at cfg.num_sims chains, its ls_sweeps sweeps in a row, and K4 on
    # the eval's first instance at its 8192 candidates (the plain version on
    # the first DIST_PLAIN of them; the noise is keyed by seed and chain)
    graph, adj = l2d._sample_adj(cfg, 50_000, dev)
    flip = l2d._adj_sweep(adj, graph).engine
    flip_plain = wsw._sweep_1flip_plain if flip.weighted else sw._sweep_1flip_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    xk = torch.rand(cfg.num_sims, cfg.num_nodes, generator=gen, device=dev) < 0.5
    for i in range(cfg.ls_sweeps):
        out = flip.sweep(xk)
        require_equal(f"{flip_k} on {graph.name} ({cfg.num_sims} chains, sweep {i + 1} of {cfg.ls_sweeps})", out,
                      flip_plain(xk, flip.tables), errs, flip_k)
        xk = out
    g0 = graphs[0]
    eng0 = engine.FusedSweepEngine.build(g0, dev)
    cands = DIST_EVAL["num_sims"] * DIST_EVAL["num_repeats"]
    xk = torch.rand(cands, g0.num_nodes, generator=gen, device=dev) < 0.5
    out = eng0.sweep(4242, xk, DIST_EVAL["num_sweeps"])[:DIST_PLAIN]
    plain_fn = wsw._wsweep_plain if eng0.weighted else sw._sweep_plain
    plain = codec.unpack_bits(plain_fn(eng0.tables, codec.pack_bits(xk[:DIST_PLAIN]), g0.num_nodes,
                                       DIST_EVAL["num_sweeps"], 0.25, None, 4242), g0.num_nodes)
    require_equal(f"{sweep_k} on {g0.name} (first {DIST_PLAIN} of {cands} candidates, "
                  f"{DIST_EVAL['num_sweeps']} sweeps)", out, plain, errs, sweep_k)
    del flip, adj, xk, out, plain

    # where one training iteration and one eval round spend their time
    net, enc = bundle["net"], bundle["encoder"]
    steps = l2d._build_dist_steps(net, cfg, ClippedAdam(net.parameters(), cfg.lr))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    host_t = {}

    def train_iteration(seed=60_000):
        t = time.time()
        graph, adj = l2d._sample_adj(cfg, seed, dev)
        host_t["graph"] = time.time() - t
        t = time.time()
        sweep = l2d._adj_sweep(adj, graph)
        torch.cuda.synchronize()
        host_t["tables"] = time.time() - t
        seq = l2d._embed(enc, adj)
        xs = torch.rand(cfg.num_sims, cfg.num_nodes, generator=gen, device=dev) < 0.5
        steps.update(gen, adj, seq, xs, l2d._cut_value_adj(xs, adj), sweep)

    train_iteration(60_001)
    profile_device(f"one training iteration ({cfg.num_sims} sims, seq_len {cfg.seq_len}, N = {cfg.num_nodes})",
                   train_iteration)
    print(f"    of it on the host: the BA graph {1e3 * host_t['graph']:.1f} ms, its 1-flip tables "
          f"{1e3 * host_t['tables']:.1f} ms")
    adj0 = torch.from_numpy(g0.adjacency_dense()).to(dev)
    seq0 = l2d._embed(enc, adj0)
    xs0 = torch.rand(DIST_EVAL["num_sims"], g0.num_nodes, generator=gen, device=dev) < 0.5
    vs0 = l2d._cut_value_adj(xs0, adj0)

    def eval_round():
        l2d._guided_round(net, seq0, gen, eng0, adj0, xs0, vs0, num_repeats=DIST_EVAL["num_repeats"], top_k=cfg.top_k,
                          num_sweeps=DIST_EVAL["num_sweeps"])

    eval_round()
    profile_device(f"one eval round on {g0.name} ({DIST_EVAL['num_sims'] * DIST_EVAL['num_repeats']} candidates)",
                   eval_round)
    return counts


MULTI_CHAINS, MULTI_REPEATS = 256, 32  # mcpg_multi at full width: 8192 samples a round
MULTI_ROUNDS = 2  # depth cut from MultiMCPGConfig's 64 rounds
MULTI_PLAIN = 256  # of the 8192 chains, those K3's plain version checks
# DIST_TABLE's MCPG protocol, as scripts/quality_table.py:159-165 runs it
BATCH_CFG = dict(total_mcmc_num=256, repeat_times=32, num_ls=8, max_epoch_num=6, reset_epoch_num=64)
BATCH_EPOCHS_1000 = 2  # BA_1000's depth cut from 6 epochs, to leave the script's time limit room


def uniform_3sat(num_vars: int = 250, num_clauses: int = 1065, seed: int = 250):
    """A uniform random 3-SAT instance of SATLIB's uf250-1065 shape: each
    clause three distinct variables, each negated with probability 1/2,
    drawn by numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    clauses = []
    for _ in range(num_clauses):
        vs = rng.choice(num_vars, size=3, replace=False) + 1
        clauses.append([int(v) * int(s) for v, s in zip(vs, rng.choice((-1, 1), size=3))])
    return clauses


def run_mcpg_multi(dev, errs: dict) -> dict:
    """`solve_mcpg(sampler="fused")` at 256 chains x 32 repeats on each
    problem of the slice, MULTI_ROUNDS rounds each: prints s/round, K3's
    share of a round (K3 timed alone at the problem's shape), the best score
    beside its float64 host re-score (equal to f32 precision; exactly on
    integer data), the peak memory and the launches; K3 must launch in
    every solve and equal its plain version on the first MULTI_PLAIN chains
    at the problem's shape (into `errs`). Then the device time by kernel of
    one round of the +-1 QUBO and of MaxSAT. Returns the launches summed
    over the solves and K3's ms and bound at each problem's shape."""
    from rlsolver_tpu_torch.algos import mcpg_multi as mm
    from rlsolver_tpu_torch.core.generate import build_g22_like
    from rlsolver_tpu_torch.ops.kernels import build, codec, mh_sampler as mh
    from rlsolver_tpu_torch.problems import cheeger, maxsat, mimo, qubo, subset_sum
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    g = build_g22_like()
    adj = g.adjacency_dense(np.float64)
    e0, e1, ew = g.edges[:, 0], g.edges[:, 1], g.weights.astype(np.float64)
    q = qubo.maxcut_to_qubo(adj)
    clauses = uniform_3sat()
    sat_inst = maxsat.MaxSatInstance.from_clauses(250, clauses)
    mimo_inst = mimo.generate_mimo(k=400, m=400, snr_db=10.0, seed=0)
    rng = np.random.default_rng(2000)
    amounts, tags = rng.integers(-5000, 5001, 2000), rng.integers(0, 8, 2000)
    sat_env = maxsat.MaxSatEnv(sat_inst, dev)
    mimo_env = mimo.MimoEnv(mimo_inst, dev)

    def sat_host(x):
        lits = np.where(sat_inst.clause_signs > 0, x[sat_inst.clause_vars], ~x[sat_inst.clause_vars])
        return float((lits & (sat_inst.clause_signs != 0)).any(axis=1) @ sat_inst.weights.astype(np.float64))

    def cheeger_host(x):
        cut = float(ew[x[e0] != x[e1]].sum())
        size = int(x.sum())
        return -cut / min(size, g.num_nodes - size)

    def subset_host(x):
        comps = [x.sum(), abs(amounts @ x)] + [abs((amounts * (tags == t)) @ x) for t in range(8)]
        return float(comps[0] - sum(comps[1:]))

    sym = (q + q.T) / 2.0
    problems = [  # (name, problem, host re-score of bits, integer-valued)
        ("maxcut_edge on G22like", mm.maxcut_edge_problem(g, device=dev), lambda x: obj_maxcut(x.astype(np.int64), g),
         True),
        ("qubo +-1 on G22like", mm.qubo_problem(qubo.QuboEnv(q, dev)),
         lambda x: float((2.0 * x - 1) @ sym @ (2.0 * x - 1)), True),
        ("qubo binary on G22like", mm.qubo_problem(qubo.QuboEnv(q, dev), binary=True),
         lambda x: float(x.astype(np.float64) @ sym @ x), True),
        ("maxsat uf250-1065-like", mm.maxsat_problem(sat_env), sat_host, True),
        ("r-cheeger on G22like", mm.cheeger_problem(cheeger.CheegerEnv(g, device=dev)), cheeger_host, False),
        ("mimo 400x400 10 dB", mm.mimo_problem(mimo_env),
         lambda x: -float(np.sum((mimo_inst.y - mimo_inst.h @ (2.0 * x - 1)) ** 2)), False),
        ("subset_sum 2000 items 8 tags", subset_sum.subset_sum_problem(subset_sum.SubsetSumEnv(amounts, tags, device=dev)),
         subset_host, True),
    ]
    cfg = mm.MultiMCPGConfig(num_chains=MULTI_CHAINS, repeat_times=MULTI_REPEATS, num_rounds=MULTI_ROUNDS,
                             sampler="fused", seed=0)
    total = {k.name: 0 for k in build.KERNELS}
    k3_shapes = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    print(f"  MultiMCPGConfig: {MULTI_CHAINS} chains x {MULTI_REPEATS} repeats = {MULTI_CHAINS * MULTI_REPEATS} "
          f"samples a round, sampler fused (K3); depth cut to {MULTI_ROUNDS} of 64 rounds", flush=True)
    for name, prob, host_fn, integral in problems:
        rounds = mm.mh_rounds(prob, cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        secs = []
        res = mm.solve_mcpg(prob, cfg, device=dev, timings=secs)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in build.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            total[k] += v
        host = host_fn(res.best_bits.astype(bool))
        rel = abs(res.best_score - host) / max(1.0, abs(host))
        # K3 at the problem's shape: timed alone, and held against its plain version
        probs = torch.rand(prob.num_vars, generator=gen, device=dev) * 0.6 + 0.2
        chains = torch.rand(MULTI_CHAINS * MULTI_REPEATS, prob.num_vars, generator=gen, device=dev) < 0.5
        thr, words = mh.fused_thresholds(probs), codec.pack_bits(chains)
        k3_ms = cuda_ms(lambda: mh.MH_FUSED.launch(thr, words.clone(), chains.shape[0], words.shape[1], prob.num_vars,
                                                   rounds, 4321), 5) - cuda_ms(words.clone, 5)
        k3_bound = bound(2 * words.numel() * 4 + thr.numel() * 4, rounds * chains.shape[0] * K3_OPS, 0)
        k3_shapes.append(dict(problem=name, chains=chains.shape[0], n=prob.num_vars, rounds=rounds, ms=k3_ms,
                              bound_ms=k3_bound[0], bound_by=k3_bound[1]))
        out = mh.mh_sample_fused(4321, probs, chains, rounds)[:MULTI_PLAIN]
        plain = codec.unpack_bits(mh.mh_fused_plain(4321, thr, words[:MULTI_PLAIN], prob.num_vars, rounds),
                                  prob.num_vars)
        require_equal(f"K3 mh_sample_fused at {name}'s shape (first {MULTI_PLAIN} of {chains.shape[0]} chains, "
                      f"N = {prob.num_vars}, {rounds} rounds)", out, plain, errs, "mh_sample_fused")
        steady = secs[1:] or secs
        print(f"  {name}: N = {prob.num_vars}, {rounds} MH rounds; seconds per round {secs} (K3 {k3_ms:.4f} ms, "
              f"bound {k3_bound[0]:.4f} ms, {100 * k3_ms / 1e3 / np.mean(steady):.3f}% of a later round); best score "
              f"{res.best_score} host re-score {host} (relative difference {rel:.3g}); history {res.history}; "
              f"max_memory_allocated {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB that earlier phases hold; launches {counts}", flush=True)
        if counts["mh_sample_fused"] <= 0:
            raise AssertionError(f"mcpg_multi on {name} did not launch mh_sample_fused")
        if (integral and res.best_score != host) or not rel <= 1e-5:
            raise AssertionError(f"mcpg_multi on {name}: best score {res.best_score} != host re-score {host}")
        if name.startswith("mimo"):
            ber = lambda x: float(np.mean(x != mimo_inst.x_true))
            print(f"    bit error rate: MCPG {ber(np.where(res.best_bits, 1.0, -1.0))}, ZF "
                  f"{ber(mimo.detect_zf(mimo_inst))}, MMSE {ber(mimo.detect_mmse(mimo_inst))}")
        del chains, words, out, plain

    # where one round's device time goes: the dense-field QUBO and MaxSAT
    for name, prob, _, _ in (problems[1], problems[3]):
        policy, optimizer = mm.new_policy(prob.num_vars, cfg, dev)
        chains = torch.rand(MULTI_CHAINS, prob.num_vars, generator=gen, device=dev) < 0.5
        vs = prob.score(chains)

        def one_round():
            mm.round_step(prob, cfg, policy, optimizer, gen, chains, chains, vs)

        one_round()
        profile_device(f"one mcpg_multi round, {name} ({MULTI_CHAINS * MULTI_REPEATS} samples)", one_round)
    return total, k3_shapes


def run_mcpg_batch(dev) -> dict:
    """DIST_TABLE's MCPG protocol (BATCH_CFG) on BA_100_ID0..9 and
    BA_1000_ID0..9, each family in one batched call: prints the seconds,
    s/round, peak memory and each best cut beside its host re-score (equal)
    and the JAX run's (results_quality/dist_table.csv); then the device time
    of one BA_1000 round; then one round of MCPG's colored sweep mode on
    G22-like beside one of the sequential mode. Returns the launches."""
    from rlsolver_tpu_torch.algos import mcpg_batch as mb
    from rlsolver_tpu_torch.algos.mcpg import MCPGConfig, solve_maxcut_mcpg
    from rlsolver_tpu_torch.core.generate import build_g22_like, graph_from_name
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    full = MCPGConfig(**BATCH_CFG, seed=0)
    print(f"  MCPGConfig {BATCH_CFG}: {full.max_epoch_num} epochs of "
          f"{full.reset_epoch_num // full.sample_epoch_num} rounds, full depth on BA_100; BA_1000 cut to "
          f"{BATCH_EPOCHS_1000} epochs", flush=True)
    build.reset_counts()
    for n in (100, 1000):
        cfg = full if n == 100 else dataclasses.replace(full, max_epoch_num=BATCH_EPOCHS_1000)
        graphs = [graph_from_name(f"BA_{n}_ID{i}") for i in range(10)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        t0, secs = time.time(), []
        x, v, history = mb.solve_maxcut_mcpg_batched(graphs, cfg, device=dev, timings=secs)
        wall = time.time() - t0
        jax_cuts = dict(enumerate(jax_alg_runs("mcpg", n)[0]))  # the campaign's own run
        host = [obj_maxcut(x[i].astype(np.int64), gr) for i, gr in enumerate(graphs)]
        print(f"  BA_{n}_ID0..9: {wall:.2f} s in all; seconds per round: first {secs[0]:.4f}, then min "
              f"{min(secs[1:]):.4f} median {np.median(secs[1:]):.4f} max {max(secs[1:]):.4f}; max_memory_allocated "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB that "
              f"earlier phases hold; mean best by epoch "
              f"{[round(float(h['best'].mean()), 2) for h in history]}", flush=True)
        print(f"  BA_{n} cuts {v.tolist()} (mean {v.mean():.2f}); JAX {[jax_cuts[i] for i in range(10)]} (mean "
              f"{np.mean(list(jax_cuts.values())):.2f}, spread {min(jax_cuts.values())}-{max(jax_cuts.values())}); "
              f"port - JAX {[float(v[i] - jax_cuts[i]) for i in range(10)]}", flush=True)
        if host != v.tolist():
            raise AssertionError(f"mcpg_batch BA_{n}: best cuts {v.tolist()} != host re-scores {host}")
    counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  launches {counts} (mcpg_batch runs no kernel of the port: torch loops)")

    # where one BA_1000 round's device time goes
    sg = mb.StackedGraphs.build(graphs, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    start = torch.rand(10, cfg.total_mcmc_num * cfg.repeat_times, 1000, generator=gen, device=dev) < 0.5
    best_xs = start[:, : cfg.total_mcmc_num].clone()
    best_vs = mb.cut_values_stacked(best_xs, sg)
    logits, optimizer = mb.new_logits(10, 1000, cfg, dev)

    def batch_round():
        mh_b, ls_b, cuts_b = mb.sample_round(gen, logits, start, sg, cfg)
        mb.reduce_round(ls_b, cuts_b, best_xs.clone(), best_vs.clone(), cfg.repeat_times)
        mb.update_round(logits, optimizer, mh_b, cuts_b, sg, cfg.sample_epoch_num)

    batch_round()
    profile_device(f"one mcpg_batch round on BA_1000_ID0..9 (10 x {start.shape[1]} chains)", batch_round)
    del sg, start

    # MCPG's colored sweep mode, one round on G22-like beside the sequential mode
    g = build_g22_like()
    for mode in ("sequential", "colored"):
        one = MCPGConfig(max_epoch_num=1, reset_epoch_num=8, sweep_mode=mode, seed=0)
        torch.cuda.synchronize()
        x, v, ev = solve_maxcut_mcpg(g, one, device=dev)
        secs = ev.records[-1][2] - ev.records[0][2]
        host = obj_maxcut(x.astype(np.int64), g)
        print(f"  {mode} sweep mode on G22like ({one.total_mcmc_num} x {one.repeat_times} chains, {one.num_ls} "
              f"sweeps): one round {secs:.4f} s; best cut {v} host re-score {host} (warm start {ev.records[0][1]})",
              flush=True)
        if host != v:
            raise AssertionError(f"{mode} sweep mode: best cut {v} != host re-score {host}")
        if mode == "sequential":
            seq_cut = v
        elif not abs(v - seq_cut) <= 0.02 * seq_cut:
            raise AssertionError(f"colored sweep mode: best cut {v} is more than 2% off the sequential mode's "
                                 f"{seq_cut}")
    return counts


# Pattern I: ECO-DQN inference, S2V-DQN and Jumanji PPO at DIST_TABLE's
# protocols on BA_100 (and ECO on BA_1000), and bench.py's pattern1 datum
ECO_PKL = os.path.join(REPO, "results_quality", "eco_params_BA.pkl")
# ECO-DQN's instances: BA_1000 cut from ID0..9 to ID0..3 to
# leave the script's time limit room for the baselines phase
ECO_IDS = {100: 10, 1000: 4}
ECO_LIMITS = {100: 280.4}  # each size's mean: at least the JAX run's mean less 1% (BA_1000: over the same ids)
ECO_PROFILE_STEPS = 100
RANDOM_WALK_BA100 = 234.8  # DIST_TABLE's RandomWalk column, BA_100
P1_NODES, P1_BLOCK, P1_BLOCKS = 800, 32, 8  # bench.py's pattern1_peco: BA_800_ID0, blocks of 32 steps
P1_CANDIDATES = (512, 1024, 2048, 4096)
P1_FEATURES, P1_LAYERS, P1_OBS = 64, 3, 7


def phase_memory(label: str, base: int) -> None:
    torch.cuda.synchronize()
    print(f"  {label}: max_memory_allocated {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB that earlier phases hold; {smi_line()}", flush=True)


def check_cuts(label: str, cuts, host, jax_runs, least: float = None, above: float = None, expect_pct: float = 0.0):
    """Prints the cuts beside the JAX runs' and fails unless every cut
    equals its host re-score and the mean is at least `least` (or above
    `above`); a mean more than expect_pct% below the last JAX run's is
    printed as a miss, not a failure."""
    mean = float(np.mean(cuts))
    print(f"  {label}: cuts {cuts} (mean {mean:.2f})", flush=True)
    for run in jax_runs:
        print(f"    JAX run {run} (mean {np.mean(run):.2f}); port - JAX {[c - j for c, j in zip(cuts, run)]}")
    if host != cuts:
        raise AssertionError(f"{label}: best cuts {cuts} != host re-scores {host}")
    if least is not None and not mean >= least:
        raise AssertionError(f"{label}: mean cut {mean:.2f} below the required {least}")
    if above is not None and not mean > above:
        raise AssertionError(f"{label}: mean cut {mean:.2f} not above {above}")
    if expect_pct:
        ref = float(np.mean(jax_runs[-1]))
        status = "within" if mean >= ref * (1 - expect_pct / 100) else "MISSED: more than"
        print(f"  {label}: mean {mean:.2f} is {status} {expect_pct}% of the JAX run's {ref:.2f} "
              f"(expected, not enforced)", flush=True)


def host_cut(state, g):
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut
    b = int(state.best_score.argmax())
    return obj_maxcut((state.best_spins[b] > 0).cpu().numpy().astype(np.int64), g)


def run_eco(dev, sizes=(100, 1000)) -> None:
    """The committed ECO-DQN network (results_quality/eco_params_BA.pkl,
    loaded without JAX) in bf16 at scripts/eco_distribution.py's protocol:
    one greedy restart per instance on BA_100_ID0..9 and BA_1000_ID0..3."""
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv

    params = {k: v.to(dev) for k, v in convert.mpnn_state_dict(convert.load_flax_pickle(ECO_PKL)).items()}
    dcfg = DQNConfig(features=64, n_layers=3, dtype=torch.bfloat16)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for n in sizes:
        cfg = SpinSystemConfig(num_envs=50 if n <= 500 else 32, basin_reward=1.0 / n, stag_punishment=0.01)
        agent = DQNAgent(SpinSystemEnv(n, cfg), dcfg, device=dev)
        cuts, host, secs = [], [], []
        for i in range(ECO_IDS[n]):
            g = graph_from_name(f"BA_{n}_ID{i}")
            t0 = time.time()
            cuts.append(agent.evaluate_scan(params, g))
            secs.append(time.time() - t0)
            host.append(host_cut(agent.last_eval_state, g))
        steps = agent.env.max_steps
        print(f"  ECO-DQN BA_{n} ({cfg.num_envs} envs x {steps} steps, bf16): seconds per instance first "
              f"{secs[0]:.3f}, then median {np.median(secs[1:]):.3f} (min {min(secs[1:]):.3f}, max "
              f"{max(secs[1:]):.3f}); seconds per rollout step {np.median(secs[1:]) / steps:.6f}", flush=True)
        jax_run = jax_alg_runs("eco", n)[-1][: ECO_IDS[n]]
        check_cuts(f"eco BA_{n}", cuts, host, [jax_run], least=ECO_LIMITS.get(n, 0.99 * float(np.mean(jax_run))))
    phase_memory("eco", base)
    # the profiler's trace of all 2000 steps would hold about 0.7 M events,
    # minutes to gather: the first ECO_PROFILE_STEPS steps of a BA_1000
    # rollout (the same widths; a step's work does not change along the rollout)
    g = graph_from_name(f"BA_{sizes[-1]}_ID0")
    window = DQNAgent(SpinSystemEnv(g.num_nodes, dataclasses.replace(agent.env.config, max_steps=ECO_PROFILE_STEPS)),
                      dcfg, device=dev)
    window.evaluate_scan(params, g)
    profile_device(f"the first {ECO_PROFILE_STEPS} steps of an ECO-DQN rollout on {g.name} "
                   f"({agent.env.config.num_envs} envs, bf16)", lambda: window.evaluate_scan(params, g))


def run_s2v(dev, steps: int = 6144) -> None:
    """S2V-DQN at scripts/quality_table.py:228-284's protocol on BA_100:
    train_scan on generate_graph(BA, 100, seed=92000), then one greedy
    rollout per instance of BA_100_ID0..9."""
    from rlsolver_tpu_torch.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu_torch.envs.spin_system import (NUM_OBSERVABLES_S2V, RewardSignal, SpinSystemConfig,
                                                     SpinSystemEnv)

    n = 100
    cfg = SpinSystemConfig(num_envs=32, max_steps=n, reversible_spins=False, num_observables=NUM_OBSERVABLES_S2V,
                           reward_signal=RewardSignal.DENSE, norm_rewards=False)
    dcfg = DQNConfig(features=32, n_layers=2, buffer_capacity=2**12, eps_decay_steps=steps // 2)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    agent = DQNAgent(SpinSystemEnv(n, cfg), dcfg, device=dev)
    t0 = time.time()
    params, best, state = agent.train_scan(generate_graph(GraphType.BA, n, seed=92000), steps)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    print(f"  S2V-DQN training: {state.step_idx} loop steps x {cfg.num_envs} envs, {state.train_steps} SGD steps in "
          f"{train_s:.2f} s: {train_s / state.step_idx:.6f} s per loop step, {state.train_steps / train_s:.1f} SGD "
          f"steps/s; best training cut {best}", flush=True)
    cuts, host = [], []
    t0 = time.time()
    for i in range(10):
        g = graph_from_name(f"BA_{n}_ID{i}")
        cuts.append(agent.evaluate_scan(params, g))
        host.append(host_cut(agent.last_eval_state, g))
    print(f"  S2V-DQN eval: {(time.time() - t0) / 10:.3f} s per instance", flush=True)
    check_cuts("s2v BA_100", cuts, host, jax_alg_runs("s2v", n), above=RANDOM_WALK_BA100, expect_pct=2.0)
    phase_memory("s2v", base)


def run_jumanji(dev, iters: int = 100) -> None:
    """Jumanji PPO at scripts/quality_table.py:171-227's protocol on BA_100:
    train_spin_ppo on generate_graph(BA, 100, seed=91000), 128 envs, 200
    steps, 100 iterations, then make_greedy_evaluator at 64 envs on
    BA_100_ID0..9."""
    from rlsolver_tpu_torch.algos.jumanji_ppo import MPNNActorCritic, SpinPPOConfig, make_greedy_evaluator, train_spin_ppo
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv

    n = 100
    train_env = SpinSystemEnv(n, SpinSystemConfig(num_envs=128, max_steps=min(2 * n, 256), basin_reward=1.0 / n,
                                                  stag_punishment=0.01))
    eval_env = SpinSystemEnv(n, SpinSystemConfig(num_envs=64, basin_reward=1.0 / n, stag_punishment=0.01))
    cfg = SpinPPOConfig(num_iters=iters, features=32, n_layers=2, num_minibatches=1)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, hist = train_spin_ppo(train_env, generate_graph(GraphType.BA, n, seed=91000), cfg, device=dev)
    train_s = time.time() - t0
    print(f"  Jumanji PPO training: {cfg.num_iters} iterations of {train_env.config.num_envs} envs x "
          f"{train_env.max_steps} steps and {cfg.update_epochs} epochs in {train_s:.2f} s "
          f"({train_s / cfg.num_iters:.4f} s per iteration); training best cut by iteration "
          f"{hist['best_cut'][:3]}..{hist['best_cut'][-3:]}, loss {hist['loss'][0]:.4f}..{hist['loss'][-1]:.4f}",
          flush=True)
    evaluate = make_greedy_evaluator(eval_env, MPNNActorCritic(eval_env.config.num_observables, cfg.features,
                                                               cfg.n_layers, device=dev))
    cuts, host = [], []
    t0 = time.time()
    for i in range(10):
        g = graph_from_name(f"BA_{n}_ID{i}")
        cuts.append(evaluate(params, g))
        host.append(host_cut(evaluate.last_state, g))
    print(f"  Jumanji eval: {(time.time() - t0) / 10:.3f} s per instance", flush=True)
    check_cuts("jumanji BA_100", cuts, host, jax_alg_runs("jumanji", n), above=RANDOM_WALK_BA100, expect_pct=2.0)
    phase_memory("jumanji", base)


def pattern1_peco(dev, dtype=torch.float32, candidates=P1_CANDIDATES, cpu_twin=True) -> dict:
    """bench.py:38-268 on the port: the PECO hot loop (SpinSystemEnv step,
    MPNN Q forward, 5% epsilon-greedy acting) on BA_800_ID0 at the env
    count `find_best_num_sims` picks from `candidates` (blocks of 32
    steps), the env-only twin and the MPNN's share of a step, the analytic
    MPNN FLOPs per env step, the bf16 argmax agreement with f32, a
    single-env numpy twin on the host CPU, and double-DQN train steps/s at
    batch 64 over 50 steps. Random weights from seed 0."""
    from rlsolver_tpu_torch.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv
    from rlsolver_tpu_torch.eval.autotune import find_best_num_sims
    from rlsolver_tpu_torch.models.mpnn import MPNN

    n, f, layers, obs_dim = P1_NODES, P1_FEATURES, P1_LAYERS, P1_OBS
    graph = graph_from_name(f"BA_{n}_ID0")
    model = MPNN(obs_dim, f, layers, dtype=dtype, seed=0, device=dev)
    # the adjacency aggregations 2 N^2 (obs + L f) dominate; the dense layers add 2 N (...)
    flops = 2 * n * n * (obs_dim + layers * f) + 2 * n * (
        obs_dim * f + obs_dim * (f - 1) + f * f + layers * 2 * (2 * f) * f + f * f + 2 * f)

    def build(num_envs, with_net=True):
        env = SpinSystemEnv(n, SpinSystemConfig(num_envs=num_envs, basin_reward=1.0 / n))
        pe = env.params_from_graph(graph, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        state, obs = env.reset(pe, generator=gen)
        carry = {"state": state, "obs": obs, "env": env, "pe": pe}

        @torch.no_grad()
        def block():
            st, ob = carry["state"], carry["obs"]
            rews = []
            for _ in range(P1_BLOCK):
                rand_a = torch.randint(0, n, (num_envs,), generator=gen, device=dev)
                if with_net:
                    greedy = model(ob, pe.adj).argmax(dim=-1)
                    explore = torch.rand(num_envs, generator=gen, device=dev) < 0.05
                    action = torch.where(explore, rand_a, greedy)
                else:  # env-only twin: the step's cost without the network
                    action = rand_a
                st, ob, rew, _ = env.step(pe, st, action)
                rews.append(rew.mean())
            carry["state"], carry["obs"] = st, ob
            return torch.stack(rews).mean()

        carry["block"] = block
        return carry

    def time_block(block, blocks=P1_BLOCKS):
        block()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(blocks):
            r = block()
        float(r)
        return blocks * P1_BLOCK / (time.perf_counter() - t0)  # steps/s of the whole batch

    built = {}

    def run(num_envs):
        if num_envs not in built:
            built[num_envs] = build(num_envs)
        return built[num_envs]["block"]()

    best, results = find_best_num_sims(run, candidates, reps=4)
    sweep = {num: round(tp * P1_BLOCK, 1) for num, tp in results}
    built.clear()
    if not any(tp > 0 for _, tp in results):
        raise RuntimeError(f"pattern1 autotune: every env-count candidate failed ({sweep})")
    torch.cuda.empty_cache()
    full = build(best)
    steps_per_sec = time_block(full["block"]) * best
    env_only_rate = time_block(build(best, with_net=False)["block"]) * best
    out = {
        "steps_per_sec": steps_per_sec,
        "num_envs": best,
        "sweep": sweep,
        "mpnn_share": max(0.0, 1.0 - steps_per_sec / env_only_rate),
        "flops_per_env_step": flops,
        "achieved_mpnn_flops": steps_per_sec * flops,
        "full": full,
        "model": model,
    }
    obs, pe = full["obs"], full["pe"]
    if dtype != torch.float32:  # the same params in f32, the same observations
        model_f32 = MPNN(obs_dim, f, layers, device=dev)
        model_f32.load_state_dict(model.state_dict())
        with torch.no_grad():
            out["greedy_action_match_vs_f32"] = float(
                (model(obs, pe.adj).argmax(-1) == model_f32(obs, pe.adj).argmax(-1)).float().mean())

    if cpu_twin:
        # one env's MPNN forward shapes and rank-1 gain update in numpy on
        # the host (random weights; this measures throughput, not values)
        adj_np = pe.adj.cpu().numpy()
        rng = np.random.default_rng(0)
        w_in = rng.standard_normal((obs_dim, f), np.float32)
        w_msg = [rng.standard_normal((2 * f, f), np.float32) for _ in range(layers)]
        w_upd = [rng.standard_normal((2 * f, f), np.float32) for _ in range(layers)]
        w_out = rng.standard_normal((f, 1), np.float32)
        spins = np.ones(n, np.float32)
        gains = full["state"].gains[0].cpu().numpy()
        obs1 = obs[0].cpu().numpy().copy()
        max_r = float(pe.max_local_reward)
        cpu_steps = 30
        t0 = time.perf_counter()
        for _ in range(cpu_steps):
            h = np.maximum(obs1 @ w_in, 0.0)
            e = h
            for li in range(layers):
                m = np.maximum(np.concatenate([adj_np @ h, e], axis=-1) @ w_msg[li], 0.0)
                h = np.maximum(np.concatenate([h, m], axis=-1) @ w_upd[li], 0.0)
            a = int(np.argmax((h @ w_out)[:, 0]))
            gains = gains - 2.0 * (spins[a] * spins) * adj_np[a]
            spins[a] *= -1.0
            obs1[:, 1] = gains / max_r
        out["cpu_steps_per_sec"] = cpu_steps / (time.perf_counter() - t0)

    # double-DQN train steps/s at the reference batch of 64
    agent = DQNAgent(full["env"], DQNConfig(batch_size=64, dtype=dtype), device=dev)
    qp = agent.init_params(0)
    bsz = 64
    batch = (obs[:bsz], torch.zeros(bsz, dtype=torch.int64, device=dev), torch.zeros(bsz, device=dev), obs[:bsz],
             torch.zeros(bsz, dtype=torch.bool, device=dev))
    qp2, opt2, loss = agent.train_step(qp, qp, agent.new_opt_state(qp), batch, pe.adj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        qp2, opt2, loss = agent.train_step(qp2, qp, opt2, batch, pe.adj)
    float(loss)
    out["train_steps_per_sec"] = 50 / (time.perf_counter() - t0)
    return out


def same_state(a, b) -> tuple:
    """(leaves, equal leaves) of two training states, bit for bit: tensors
    by value, dtype and device, generators by state, the rest by ==."""
    if isinstance(a, torch.Generator):
        return 1, int(torch.equal(a.get_state(), b.get_state()) and a.device == b.device)
    if isinstance(a, torch.Tensor):
        return 1, int(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b))
    if isinstance(a, dict):
        pairs = [same_state(a[k], b[k]) for k in a] if a.keys() == b.keys() else [(1, 0)]
    elif isinstance(a, (list, tuple)):
        pairs = [same_state(x, y) for x, y in zip(a, b)] if len(a) == len(b) else [(1, 0)]
    else:
        return 1, int(a == b)
    return sum(p[0] for p in pairs), sum(p[1] for p in pairs)


def run_pattern1(dev) -> None:
    """bench.py's pattern1_peco on the port in f32 and in bf16 over the f32
    winner x1, x2 and x4 (one JSON line with bench.py's key names), the
    device time of one f32 block, then a DQN train_runner with a
    checkpoint mid-way whose restore must give the saved state bit for bit."""
    from rlsolver_tpu_torch.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv
    from rlsolver_tpu_torch.train.checkpoint import restore_checkpoint

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p1 = pattern1_peco(dev)
    print(f"  f32: env counts {p1['sweep']} env-steps/s, winner {p1['num_envs']}: {p1['steps_per_sec']:.1f} "
          f"env-steps/s, MPNN share {p1['mpnn_share']:.3f}, {p1['achieved_mpnn_flops'] / 1e12:.2f} TFLOP/s of MPNN "
          f"work", flush=True)
    full = p1.pop("full")
    model = p1.pop("model")
    profile_device(f"one pattern1 block (f32, {P1_BLOCK} steps x {p1['num_envs']} envs, BA_{P1_NODES}_ID0)", full["block"])
    del full, model
    torch.cuda.empty_cache()
    b = p1["num_envs"]
    p1_bf16 = pattern1_peco(dev, dtype=torch.bfloat16, candidates=(b, 2 * b, 4 * b), cpu_twin=False)
    del p1_bf16["full"], p1_bf16["model"]
    torch.cuda.empty_cache()
    smi = smi_line()
    print(json.dumps({
        "pattern1_env_steps_per_sec": round(p1["steps_per_sec"], 1),
        "pattern1_num_envs_autotuned": p1["num_envs"],
        "pattern1_autotune_sweep": p1["sweep"],
        "pattern1_mpnn_forward_share": round(p1["mpnn_share"], 3),
        "pattern1_cpu_single_env_steps_per_sec": round(p1["cpu_steps_per_sec"], 1),
        "pattern1_target_vs_cpu_single": 100.0,
        "pattern1_vs_cpu_single": round(p1["steps_per_sec"] / p1["cpu_steps_per_sec"], 1),
        "pattern1_vs_cpu_256core": round(p1["steps_per_sec"] / (256 * p1["cpu_steps_per_sec"]), 2),
        "dqn_train_steps_per_sec": round(p1["train_steps_per_sec"], 1),
        "pattern1_mpnn_flops_per_env_step": p1["flops_per_env_step"],
        "pattern1_achieved_tflops_f32": round(p1["achieved_mpnn_flops"] / 1e12, 2),
        "pattern1_bf16_env_steps_per_sec": round(p1_bf16["steps_per_sec"], 1),
        "pattern1_bf16_num_envs_autotuned": p1_bf16["num_envs"],
        "pattern1_bf16_autotune_sweep": p1_bf16["sweep"],
        "pattern1_bf16_speedup_vs_f32": round(p1_bf16["steps_per_sec"] / p1["steps_per_sec"], 2),
        "pattern1_bf16_achieved_tflops": round(p1_bf16["achieved_mpnn_flops"] / 1e12, 2),
        "pattern1_bf16_greedy_action_match_vs_f32": round(p1_bf16["greedy_action_match_vs_f32"], 4),
        "dqn_train_steps_per_sec_bf16": round(p1_bf16["train_steps_per_sec"], 1),
        "device": smi,
    }), flush=True)
    phase_memory("pattern1", base)

    # TrainLoop with torch.save checkpoints: a mid-way checkpoint restores bit for bit
    n = 100
    g = graph_from_name(f"BA_{n}_ID0")
    env = SpinSystemEnv(n, SpinSystemConfig(num_envs=32, basin_reward=1.0 / n, stag_punishment=0.01))
    dcfg = DQNConfig(features=32, n_layers=2, buffer_capacity=2**12, eps_decay_steps=300)
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        t0 = time.time()
        _, mid = DQNAgent(env, dcfg, device=dev).train_runner(g, 150, run_dir=os.path.join(d, "run"),
                                                               checkpoint_every=150, log_every=50)
        restored = restore_checkpoint(os.path.join(d, "run", "checkpoints", "step_150"), like=mid)
        leaves, equal = same_state(restored, mid)
        print(f"  train_runner on BA_{n}_ID0 (32 envs): 150 steps, {mid.train_steps} SGD steps in "
              f"{time.time() - t0:.2f} s; the step_150 checkpoint restores {equal} of {leaves} leaves bit for bit "
              f"(params, Adam state, replay ring, env state, the CUDA generator's state)", flush=True)
        if equal != leaves:
            raise AssertionError(f"checkpoint restore: {leaves - equal} of {leaves} leaves differ")
        _, resumed = DQNAgent(env, dcfg, device=dev).train_runner(g, 300, run_dir=os.path.join(d, "run"),
                                                                   checkpoint_every=150, resume=True, log_every=50)
        _, straight = DQNAgent(env, dcfg, device=dev).train_runner(g, 300, run_dir=os.path.join(d, "straight"),
                                                                    checkpoint_every=150, log_every=50)
        leaves, equal = same_state(resumed, straight)
        print(f"  resumed at 150 and run to 300 against the straight 300-step run: {equal} of {leaves} leaves "
              f"equal bit for bit ({resumed.train_steps} SGD steps)", flush=True)


# DIST_TABLE's baselines as scripts/quality_table.py:42-86 runs them (the
# instance id as the seed) and its ISCO, PI-GNN and specb cell protocols
# (:290-341); BLS at scripts/instance_wise.py:98-100's width on G22-like
BASE_1000_IDS = 4  # SA and GA on BA_1000_ID0..3
SPECB_CFG = dict(opt_iters=4000, lr=4.0, block_size=16, mu_halvings=10, certify_squarings=12)
BOUND_ALGS = ("specb", "milp_bound")  # dist_table.csv's rows that are bounds, not cuts
BLS_CHAINS, BLS_BUDGET_S = 1024, 15.0
# PI-GNN's cell from this many seeds: one cell's mean spreads by about 1.3%
# over seeds (the JAX package on a CPU: 278.4, 276.9, 277.5 for seeds 0-2;
# dist_table.csv's two runs average 279.25), so the column's mean is taken
# over PIGNN_SEEDS cells against JAX's over its runs
PIGNN_SEEDS = 3
SA_PROFILE_STEPS, ISCO_PROFILE_STEPS = 100, 20


def dist_rows(n: int, dist: str = "BA") -> dict:
    """{alg: {id: [obj, ...]}}: every row of results_quality/dist_table.csv
    on dist_n (an alg may have several runs)."""
    import csv
    out: dict = {}
    with open(os.path.join(REPO, "results_quality", "dist_table.csv")) as f:
        for r in csv.DictReader(f):
            if r["dist"] == dist and r["n"] == str(n):
                out.setdefault(r["alg"], {}).setdefault(int(r["id"]), []).append(float(r["obj"]))
    return out


def check_mean(label: str, cuts, jax_rows) -> None:
    """Prints the cuts beside the JAX package's (each instance's mean over
    its runs) and fails unless their mean is at least JAX's less 1%."""
    jax_means = [float(np.mean(r)) for r in jax_rows]
    ref, mean = float(np.mean(jax_means)), float(np.mean(cuts))
    print(f"  {label}: cuts {cuts} (mean {mean:.2f}); JAX {jax_means} (mean {ref:.2f}, {len(jax_rows[0])} run(s)); "
          f"port - JAX {[c - j for c, j in zip(cuts, jax_means)]}", flush=True)
    if not mean >= 0.99 * ref:
        raise AssertionError(f"{label}: mean cut {mean:.2f} below JAX's {ref:.2f} less 1%")


def require_launches(label: str, counts: dict, launched, not_launched) -> None:
    """Fails unless every kernel of `launched` launched and none of
    `not_launched` did."""
    print(f"  {label} launches: {({k: v for k, v in counts.items() if v}) or 'none'}", flush=True)
    missing = [k for k in launched if counts[k] <= 0]
    extra = [k for k in not_launched if counts[k] and k not in launched]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, launched but not expected {extra}")


def run_baselines(dev, errs: dict) -> dict:
    """DIST_TABLE's baselines on the card: RandomWalk, Greedy, SDP, SA and
    GA per instance on BA_100_ID0..9 (Greedy on BA_1000_ID0..9 too, SA and
    GA on BA_1000_ID0..3), the ISCO cell on both families, the PI-GNN and
    spectral-bound cells on BA_100, and BLS with the packed warm start on
    G22-like for BLS_BUDGET_S. Checks every best cut against its host
    re-score, Greedy's cuts against dist_table.csv's exactly, each column's
    mean against JAX's over the same instances less 1%, every certified
    bound against the largest cut dist_table.csv holds for its instance,
    and the launches (GA: K10 only; BLS: the 1-flip kernel the engine picks
    only; every other solver: no kernel); then holds K10 at GA's shape and
    K5 at BLS's warm-start shape against their plain versions (into
    `errs`), and profiles an SA and an ISCO window. Returns the launches of
    GA's and BLS's runs."""
    import re
    from rlsolver_tpu_torch.algos.isco import ISCOConfig, cell_sampler, solve_maxcut_isco_cell
    from rlsolver_tpu_torch.algos.pignn import PIGNNConfig, solve_maxcut_pignn_cell
    from rlsolver_tpu_torch.classical.bls import BLSConfig, solve_maxcut_bls
    from rlsolver_tpu_torch.classical.genetic import GAConfig, genetic_maxcut
    from rlsolver_tpu_torch.classical.greedy import greedy_maxcut
    from rlsolver_tpu_torch.classical.random_walk import random_walk_maxcut
    from rlsolver_tpu_torch.classical.sdp import SDPConfig, sdp_maxcut
    from rlsolver_tpu_torch.classical import simulated_annealing as sa
    from rlsolver_tpu_torch.classical.spectral_bound import SpectralBoundConfig, maxcut_upper_bound_cell
    from rlsolver_tpu_torch.core.generate import build_g22_like, graph_from_name
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.ops import cut
    from rlsolver_tpu_torch.ops.kernels import build, mcpg_sweep as sw, sweep_kernel as sk
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    graphs = {n: [graph_from_name(f"BA_{n}_ID{i}") for i in range(10)] for n in (100, 1000)}
    table = {n: dist_rows(n) for n in (100, 1000)}
    ours: dict = {}  # (alg, n) -> cuts by id
    path_launches: dict = {}

    def host_check(label, g, bits, value):
        host = obj_maxcut(np.asarray(bits).astype(np.int64), g)
        if host != value:
            raise AssertionError(f"{label} {g.name}: best cut {value} != host re-score {host}")

    def launches():
        return {k.name: k.launches for k in build.KERNELS}

    def no_kernel(label, counts):
        require_launches(label + " (its loops are torch)", counts, (), tuple(counts))

    def versus_jax(alg, n, ids):
        """(c): the mean over `ids` at least JAX's mean over them less 1%."""
        check_mean(f"{alg} BA_{n} ids {ids[0]}..{ids[-1]}", ours[(alg, n)], [table[n][alg][i] for i in ids])

    def per_instance(alg, n, ids, solve):
        cuts, secs = [], []
        build.reset_counts()
        for i in ids:
            g = graphs[n][i]
            t0 = time.time()
            bits, value = solve(g, i)
            secs.append(time.time() - t0)
            host_check(alg, g, bits, value)
            cuts.append(value)
        ours[(alg, n)] = cuts
        print(f"  {alg} BA_{n}: seconds per instance {[round(x, 3) for x in secs]}", flush=True)
        return launches()

    def cell(alg, n, solve):
        t0 = time.time()
        bits, vals = solve(graphs[n])
        secs = time.time() - t0
        for g, b, v in zip(graphs[n], bits, vals):
            host_check(alg, g, b, float(v))
        ours[(alg, n)] = [float(v) for v in vals]
        print(f"  {alg} cell BA_{n} (10 instances at once): {secs:.3f} s, {secs / 10:.3f} s per instance", flush=True)

    ids100, ids1000 = list(range(10)), list(range(BASE_1000_IDS))
    # Greedy: all zeros, no draws; the JAX package's cuts exactly (b)
    for n in (100, 1000):
        no_kernel("greedy", per_instance("greedy", n, list(range(10)), lambda g, i: greedy_maxcut(g, device=dev)))
        jax_greedy = [table[n]["greedy"][i][0] for i in range(10)]
        print(f"  greedy BA_{n}: cuts {ours[('greedy', n)]}; dist_table.csv {jax_greedy}", flush=True)
        if ours[("greedy", n)] != jax_greedy:
            raise AssertionError(f"greedy BA_{n}: {ours[('greedy', n)]} != dist_table.csv's {jax_greedy}")
    no_kernel("rw", per_instance("rw", 100, ids100, lambda g, i: random_walk_maxcut(g, seed=i, device=dev)))
    no_kernel("sdp", per_instance("sdp", 100, ids100, lambda g, i: sdp_maxcut(g, SDPConfig(seed=i), device=dev)))
    ga_counts = {}
    for n, ids in ((100, ids100), (1000, ids1000)):
        no_kernel("sa", per_instance("sa", n, ids, lambda g, i: sa.anneal_maxcut(
            g, sa.SAConfig(num_chains=256, num_steps=max(2000, 12 * g.num_nodes), seed=i), device=dev)))
        counts = per_instance("ga", n, ids, lambda g, i: genetic_maxcut(
            g, GAConfig(generations=40 if g.num_nodes <= 400 else 64, seed=i), device=dev))
        ga_counts = {k: ga_counts.get(k, 0) + v for k, v in counts.items()}
    require_launches("ga", ga_counts, ("sweep_1flip_f32",), SWEEPS)  # (e)
    for n in (100, 1000):
        build.reset_counts()
        cell("isco", n, lambda gs: solve_maxcut_isco_cell(gs, ISCOConfig(
            batch_size=256 if gs[0].num_nodes <= 800 else 96, chain_length=max(600, 2 * gs[0].num_nodes), seed=0),
            device=dev))
        no_kernel("isco", launches())
    build.reset_counts()
    pignn_runs = []
    for seed in range(PIGNN_SEEDS):
        cell("pignn", 100, lambda gs: solve_maxcut_pignn_cell(gs, PIGNNConfig(seed=seed), device=dev))
        pignn_runs.append(ours.pop(("pignn", 100)))
        print(f"  pignn seed {seed}: mean {np.mean(pignn_runs[-1]):.2f}", flush=True)
    ours[("pignn", 100)] = [float(np.mean(c)) for c in zip(*pignn_runs)]  # each instance's mean over the seeds
    t0 = time.time()
    bounds = maxcut_upper_bound_cell(graphs[100], SpectralBoundConfig(**SPECB_CFG), device=dev)
    print(f"  specb cell BA_100 ({SPECB_CFG}): {time.time() - t0:.3f} s", flush=True)
    no_kernel("pignn and specb", launches())
    for alg in ("rw", "sdp", "sa", "ga", "isco", "pignn"):
        versus_jax(alg, 100, ids100)
    for alg, ids in (("sa", ids1000), ("ga", ids1000), ("isco", list(range(10)))):
        versus_jax(alg, 1000, ids)
    # (d): each certified bound at or above every cut known for its instance
    for i, b in enumerate(bounds):
        known = max([max(v[i]) for a, v in table[100].items() if a not in BOUND_ALGS and i in v] +
                    [cuts[i] for (a, n), cuts in ours.items() if n == 100 and i < len(cuts)] +
                    [run[i] for run in pignn_runs])
        if not b >= known:
            raise AssertionError(f"specb BA_100_ID{i}: certified bound {b} below the cut {known}")
    jax_specb = float(np.mean([np.mean(table[100]["specb"][i]) for i in ids100]))
    print(f"  specb BA_100: bounds {[round(float(b), 3) for b in bounds]} (mean {np.mean(bounds):.3f}); JAX "
          f"{[table[100]['specb'][i][0] for i in ids100]} (mean {jax_specb:.2f})", flush=True)
    if not np.mean(bounds) <= 1.01 * jax_specb:
        raise AssertionError(f"specb BA_100: mean bound {np.mean(bounds):.3f} above JAX's {jax_specb:.2f} plus 1%")

    # BLS on G22-like with the packed warm start, for a time budget
    g22 = build_g22_like()
    with open(os.path.join(REPO, "scripts", "instance_wise.py")) as f:
        n_iw, m_iw, seed_iw = map(int, re.search(r'"G22like": \((\d+), (\d+), (\d+)', f.read()).groups())
    if (n_iw, m_iw) != (g22.num_nodes, g22.num_edges) or seed_iw != 22:
        raise AssertionError(f"instance_wise.py's G22like is gnm({n_iw}, {m_iw}, seed {seed_iw}), not build_g22_like()")
    print(f"  G22like: scripts/instance_wise.py's gnm({n_iw}, {m_iw}, seed={seed_iw}), the graph of "
          f"build_g22_like() (gnm_edges(2000, 19990, seed=22), held equal to networkx's by the tests)", flush=True)
    curve = []
    build.reset_counts()
    t0 = time.time()
    bits, best, hist = solve_maxcut_bls(g22, BLSConfig(num_chains=BLS_CHAINS, num_rounds=100000, seed=0,
                                                       packed_sweep=True),
                                        record=lambda i, b: curve.append((time.time() - t0, b)),
                                        time_budget=BLS_BUDGET_S, device=dev)
    bls_counts = launches()
    host_check("bls", g22, bits, best)
    print(f"  bls G22like ({BLS_CHAINS} chains, packed warm start, {BLS_BUDGET_S} s): {len(hist)} rounds of 512 "
          f"steps in {curve[-1][0]:.2f} s, {curve[-1][0] / (512 * len(hist)) * 1e3:.4f} ms a step; best {best}",
          flush=True)
    import csv
    with open(os.path.join(REPO, "results_quality", "instance_wise.csv")) as f:
        jax_curve = [(float(r["seconds"]), float(r["obj"])) for r in csv.DictReader(f)
                     if r["instance"] == "G22like" and r["alg"] == "bls"]
    t_first = jax_curve[0][0]
    for t, b in curve[:: max(1, len(curve) // 12)] + curve[-1:]:
        jax_b = max(o for s_, o in jax_curve if s_ - t_first <= t - curve[0][0]) if t >= curve[0][0] else None
        print(f"    {t:8.2f} s: port {b}; instance_wise.csv at the same seconds after its first record: {jax_b}")
    print(f"    instance_wise.csv's G22like bls curve: {jax_curve[0][1]} at its first record, {jax_curve[-1][1]} "
          f"{jax_curve[-1][0] - t_first:.1f} s later", flush=True)
    env22 = MaxcutEnv(g22, dev, packed_sweep=True)
    picked = "sweep_1flip" if not env22.flip_engine.weighted else FLIP_KERNELS[env22.flip_engine.levels]
    print(f"  the engine's 1-flip kernel for G22like: {picked}", flush=True)
    require_launches("bls", bls_counts, ("sweep_1flip",),
                     tuple(k for k in SWEEPS + ("sweep_1flip_f32",) if k != "sweep_1flip"))
    path_launches = {k: ga_counts[k] + bls_counts[k] for k in ga_counts}

    # (f) K10 at GA's shape and K5 at BLS's warm-start shape, against their plain versions
    gen = torch.Generator(device=dev).manual_seed(11)
    env = MaxcutEnv(graphs[1000][0], dev)
    xs = env.random_xs(gen, GAConfig().population)
    s, gains, vs = cut.signs_from_bits(xs), env.gains(xs), env.obj(xs)
    k_out = sk.sweep_1flip_f32(env.cg.adj, s, gains, vs, env.f32_lists)
    p_out = sk.sweep_1flip_f32_plain(env.cg.adj, s, gains, vs)
    for name, a, b in zip(("s", "gains", "vs"), k_out, p_out):
        require_equal(f"K10 at GA's shape ({xs.shape[0]} chains, {env.graph.name}) {name}", a, b, errs,
                      "sweep_1flip_f32")
    warm = env22.random_xs(gen, BLS_CHAINS)
    require_equal(f"K5 at BLS's warm-start shape ({BLS_CHAINS} chains, G22like)", env22.flip_engine.sweep(warm),
                  sw._sweep_1flip_plain(warm, env22.flip_engine.tables), errs, "sweep_1flip")
    # their wrappers' times at these shapes (CUDA events; with the wrapper's
    # copies of the state, K5's with the bit codec), beside the plain versions'
    k10 = (cuda_ms(lambda: sk.sweep_1flip_f32(env.cg.adj, s, gains, vs, env.f32_lists), 10),
           cuda_ms(lambda: sk.sweep_1flip_f32_plain(env.cg.adj, s, gains, vs), 1, warmup=False))
    k5 = (cuda_ms(lambda: env22.flip_engine.sweep(warm), 10),
          cuda_ms(lambda: sw._sweep_1flip_plain(warm, env22.flip_engine.tables), 1, warmup=False))
    print(f"  K10 wrapper at GA's shape {k10[0]:.4f} ms (plain {k10[1]:.1f} ms); K5 wrapper at BLS's warm-start "
          f"shape {k5[0]:.4f} ms (plain {k5[1]:.1f} ms)", flush=True)

    # where an SA step and an ISCO step spend their time
    g = graphs[1000][0]
    cg = cut.CutGraph.build(g, dev)
    sa_cfg = sa.SAConfig(num_chains=256, num_steps=max(2000, 12 * g.num_nodes))
    temps = torch.from_numpy(sa.temperatures(sa_cfg)[:SA_PROFILE_STEPS]).to(dev)
    xs = torch.rand(256, g.num_nodes, generator=gen, device=dev) < 0.5
    nodes = torch.randint(0, g.num_nodes, (SA_PROFILE_STEPS, 256), generator=gen, device=dev)
    u = torch.rand(SA_PROFILE_STEPS, 256, generator=gen, device=dev)
    sa.anneal_chains(cg, xs, nodes, u, temps)
    profile_device(f"{SA_PROFILE_STEPS} SA steps on {g.name} (256 chains)",
                   lambda: sa.anneal_chains(cg, xs, nodes, u, temps))
    icfg = ISCOConfig(batch_size=96, chain_length=2000, seed=0)
    smp = cell_sampler(graphs[1000], icfg, dev)
    carry = smp.init_carry(gen, (10, icfg.batch_size, 1000), dev)
    itemps = torch.from_numpy(smp.temperatures(icfg.chain_length)[:ISCO_PROFILE_STEPS]).to(dev)
    smp.run_segment(carry, itemps, gen)
    profile_device(f"{ISCO_PROFILE_STEPS} ISCO steps of the BA_1000 cell (10 x 96 chains)",
                   lambda: smp.run_segment(carry, itemps, gen))
    return path_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rlsolver_tpu_torch.algos import l2a
    from rlsolver_tpu_torch.algos.mcpg import GSET_PRESETS_40G, _build_steps, new_policy, solve_maxcut_mcpg
    from rlsolver_tpu_torch.algos.local_search_solver import LocalSearchConfig, solve_maxcut_local_search
    from rlsolver_tpu_torch.core.generate import (build_complete_f32, build_d2000_like, build_f22_like, build_g22_like,
                                                  build_w22_like, build_w70_like)
    from rlsolver_tpu_torch.core.graph import Graph
    from rlsolver_tpu_torch.device import resolve_device
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.models.transformer import PolicyTrsWithValue
    from rlsolver_tpu_torch.ops import cut
    from rlsolver_tpu_torch.ops.kernels import build, codec, engine, mcpg_sweep as sw, mh_sampler as mh
    from rlsolver_tpu_torch.ops.kernels import sweep_kernel as sk, weighted_sweep as wsw
    from rlsolver_tpu_torch.optim import ClippedAdam
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    dev = resolve_device("cuda")
    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 1. build ------------------------------------------------------------
    t0 = time.time()
    logs = build.build_all()
    for src, log in logs.items():
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines() if "Used " in ln]
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill stores" not in ln})
        print(f"  {src}: {len(regs)} kernels, at most {max(regs)} registers, spills: {spills or 'none'}")
    phase("build", t0)

    # 2. kernel checks at the main path's shapes ---------------------------
    t0 = time.time()
    g = build_g22_like()
    n, w = g.num_nodes, codec.num_words(g.num_nodes)
    preset = GSET_PRESETS_40G["gset_22"]
    B = preset.total_mcmc_num * preset.repeat_times  # 2^20 chains
    B_WARM = preset.total_mcmc_num  # the warm start's 1-flip sweep
    S = preset.num_ls
    ROUNDS = 2 * (n // 10)  # MH rounds per MCPG round
    B_PLAIN_SWEEP = 8192  # the plain sweep's Python loop is slow: fewer chains
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    probs = torch.rand(n, generator=gen, device=dev) * 0.6 + 0.2
    bits = torch.rand(B, n, generator=gen, device=dev) < 0.5
    tables = sw.PackedSweepTables.build(g, dev)
    adj = sw.pack_adjacency(g, dev)
    thr = mh.fused_thresholds(probs)
    errs = {}
    B70 = W70_CHAINS * W70_REPEATS  # the W70-like path's chains
    B_PLAIN_W = 2048  # the plain weighted sweeps' chains in the checks (S * N Python steps)

    def proposal_stream():
        """K2's int32 [ROUNDS, B] stream, 16 rounds of random bits at a time."""
        out = torch.empty(ROUNDS, B, dtype=torch.int32, device=dev)
        for r in range(0, ROUNDS, 16):
            raw = torch.randint(0, 2**32, (min(16, ROUNDS - r), B), generator=gen, device=dev, dtype=torch.int64)
            out[r : r + 16] = mh.make_proposal_stream(raw, probs)
        return out

    stream = proposal_stream()
    k2_out = mh.mh_sample_stream(stream, bits)
    require_equal("K2 mh_sample_stream", k2_out,
                  codec.unpack_bits(mh.mh_stream_plain(stream, codec.pack_bits(bits)), n), errs, "mh_sample_stream")

    out = mh.mh_sample_fused(12345, probs, bits, ROUNDS)
    plain = codec.unpack_bits(mh.mh_fused_plain(12345, thr, codec.pack_bits(bits), n, ROUNDS), n)
    require_equal("K3 mh_sample_fused", out, plain, errs, "mh_sample_fused")
    zeros = torch.zeros(8192, n, dtype=torch.bool, device=dev)
    marg = mh.mh_sample_fused(7, probs, zeros, 20 * n).float().mean(0)
    err = float((marg - probs).abs().max())
    print(f"  K3 marginals after {20 * n} rounds from all-zero chains: max |mean - p| = {err:.4f} (limit 0.03)")
    if not err < 0.03:
        raise AssertionError("K3 does not reach the policy's marginals")

    noise = torch.randint(0, 65536, (S * n, 8192), generator=gen, device=dev, dtype=torch.int32)
    sub = bits[:8192].contiguous()
    out = sw.mcpg_sweep_packed(noise, sub, tables, num_sweeps=S)
    plain = codec.unpack_bits(sw._sweep_plain(tables, codec.pack_bits(sub), n, S, 0.25, noise, 0), n)
    require_equal("K4 mcpg_sweep_packed (injected noise)", out, plain, errs, "mcpg_sweep")
    out = sw.mcpg_sweep_fused(777, bits, tables, num_sweeps=S)
    sub = bits[:B_PLAIN_SWEEP].contiguous()
    plain = codec.unpack_bits(sw._sweep_plain(tables, codec.pack_bits(sub), n, S, 0.25, None, 777), n)
    require_equal(f"K4 mcpg_sweep_fused (first {B_PLAIN_SWEEP} of {B} chains)", out[:B_PLAIN_SWEEP], plain,
                  errs, "mcpg_sweep")

    # K4 on a unit hub with isolated nodes (Hub3000's topology): a step with
    # a list of many words, steps with none; unit and +-1 weights
    hub = build_hub_graph()
    for name_h, w_h in (("Hub3000unit", np.ones_like(hub.weights)), ("Hub3000pm1", np.sign(hub.weights))):
        g_h = Graph(hub.num_nodes, hub.edges, w_h.astype("float32"), name_h)
        t_h, n_h = sw.PackedSweepTables.build(g_h, dev), g_h.num_nodes
        lens = (t_h.word_offsets[1:] - t_h.word_offsets[:-1]).long()
        print(f"  {name_h}: N={n_h}, word lists of {float(lens.float().mean()):.1f} words on average, the largest "
              f"{int(lens.max())} of {codec.num_words(n_h)}, {int((lens == 0).sum())} empty", flush=True)
        sub_h = torch.rand(B_PLAIN_W, n_h, generator=gen, device=dev) < 0.5
        noise_h = torch.randint(0, 65536, (2 * n_h, B_PLAIN_W), generator=gen, device=dev, dtype=torch.int32)
        plain = codec.unpack_bits(sw._sweep_plain(t_h, codec.pack_bits(sub_h), n_h, 2, 0.25, noise_h, 0), n_h)
        require_equal(f"K4 mcpg_sweep_packed on {name_h} (injected noise)",
                      sw.mcpg_sweep_packed(noise_h, sub_h, t_h, num_sweeps=2), plain, errs, "mcpg_sweep")
        bits_h = torch.rand(B70, n_h, generator=gen, device=dev) < 0.5
        out = sw.mcpg_sweep_fused(31, bits_h, t_h, num_sweeps=3)
        plain = codec.unpack_bits(sw._sweep_plain(t_h, codec.pack_bits(bits_h[:B_PLAIN_W]), n_h, 3, 0.25, None, 31),
                                  n_h)
        require_equal(f"K4 mcpg_sweep_fused on {name_h} (first {B_PLAIN_W} of {B70} chains, 3 sweeps)",
                      out[:B_PLAIN_W], plain, errs, "mcpg_sweep")
    del t_h, sub_h, noise_h, bits_h

    # K5 (signed lists in a level schedule, in shared memory) on G22-like, a
    # +-1 G22-like, Hub3000's topology with unit and
    # +-1 weights and a 10,000-node unit path (10,000 levels), each against
    # the sequential plain sweep, the f32 sweep and K8b on the same weights
    warm = bits[:B_WARM].contiguous()
    env32 = MaxcutEnv(g, dev)
    rng_pm = torch.Generator().manual_seed(3)
    signs = (torch.randint(0, 2, (g.num_edges,), generator=rng_pm) * 2 - 1).numpy().astype("float32")
    g_pm = Graph(g.num_nodes, g.edges, signs, "G22like_pm1")
    path = build_path_graph()
    k5_checks = [(g, adj, warm, ""), (g_pm, None, warm, "")]
    k5_checks += [(Graph(gk.num_nodes, gk.edges, wk.astype("float32"), nk), None, None, "")
                  for gk, wk, nk in ((hub, np.ones_like(hub.weights), "Hub3000unit"),
                                     (hub, np.sign(hub.weights), "Hub3000pm1"),
                                     (path, np.ones_like(path.weights), "Path10000unit"))]
    for gk, adj_k, xk, note in k5_checks:
        adj_k = adj_k if adj_k is not None else sw.pack_adjacency(gk, dev)
        xk = xk if xk is not None else torch.rand(W70_CHAINS, gk.num_nodes, generator=gen, device=dev) < 0.5
        lv = adj_k.levels
        print(f"  K5 on {gk.name} {note}: {lv.positions} nodes with a neighbour in {lv.depth} levels, "
              f"{lv.num_entries} entries, a table of {lv.table_bytes} bytes; 1-flip plan "
              f"{engine.plan_1flip(gk, engine.l2_bytes(dev))}", flush=True)
        out = sw.sweep_1flip_packed(xk, adj_k)
        name = f"K5 on {gk.name} {note}".rstrip()
        require_equal(f"{name} vs the sequential plain sweep", out, sw._sweep_1flip_plain(xk, adj_k), errs,
                      "sweep_1flip")
        env_k = env32 if gk is g else MaxcutEnv(gk, dev)
        f32_bits, f32_vs = env_k.sweep_1flip(xk, env_k.obj(xk))
        require_equal(f"{name} vs the f32 incremental-gain sweep", out, f32_bits, errs, "sweep_1flip")
        if not torch.equal(env_k.obj(out), f32_vs):
            raise AssertionError(f"{name}: cut values differ from the f32 sweep's")
        require_equal(f"{name} vs K8b", out,
                      wsw.sweep_1flip_weighted(xk, wsw.WeightedAdjPlanes.build(gk, dev), levels=True), errs,
                      "sweep_1flip")
        del env_k, adj_k, lv
    # the engine's 1-flip choice on a dense unit graph (D2000-like's topology)
    d2000 = build_d2000_like()
    d_unit = Graph(d2000.num_nodes, d2000.edges, np.ones(d2000.num_edges, np.float32), "D2000unit")
    flip_du = engine.FlipSweepEngine.build(d_unit, dev)
    kernel_du = FLIP_KERNELS[flip_du.levels] if flip_du.weighted else "sweep_1flip"
    print(f"  {d_unit.name}: {2 * d_unit.num_edges / d_unit.num_nodes:.1f} neighbours a node, K5 table at most "
          f"{sw.level_table_bytes(d_unit)} bytes; the engine runs {kernel_du}", flush=True)
    require_equal(f"the engine's 1-flip sweep ({kernel_du}) on {d_unit.name} vs K5's plain version",
                  flip_du.sweep(warm), sw._sweep_1flip_plain(warm, sw.pack_adjacency(d_unit, dev)), errs, kernel_du)
    del flip_du

    # K6-K8b on the weighted stand-ins, at their paths' shapes
    w22, w70 = build_w22_like(), build_w70_like()
    l2 = engine.l2_bytes(dev)
    chunk70 = engine.plan_sweep(w70, l2).node_chunk
    if not engine.plan_1flip(w70, l2).levels:
        raise AssertionError("the engine should take K8b on W70-like")
    for gw, chunk, name in ((w22, None, "K6"), (w70, chunk70, "K7")):
        nw, tw = gw.num_nodes, wsw.WeightedSweepTables.build(gw, dev)
        sub = torch.rand(B_PLAIN_W, nw, generator=gen, device=dev) < 0.5
        noise_w = torch.randint(0, 65536, (2 * nw, B_PLAIN_W), generator=gen, device=dev, dtype=torch.int32)
        out = wsw.mcpg_sweep_weighted(noise_w, sub, tw, num_sweeps=2, node_chunk=chunk)
        plain = codec.unpack_bits(wsw._wsweep_plain(tw, codec.pack_bits(sub), nw, 2, 0.25, noise_w, 0), nw)
        key = "mcpg_sweep_weighted" + ("_chunked" if chunk else "")
        require_equal(f"{name} on {gw.name} (injected noise, chunk {chunk})", out, plain, errs, key)
    tw22 = wsw.WeightedSweepTables.build(w22, dev)
    out = wsw.mcpg_sweep_weighted_fused(4242, bits, tw22, num_sweeps=2)
    sub = bits[:B_PLAIN_W].contiguous()
    plain = codec.unpack_bits(wsw._wsweep_plain(tw22, codec.pack_bits(sub), n, 2, 0.25, None, 4242), n)
    require_equal(f"K6 fused on W22like (first {B_PLAIN_W} of {B} chains)", out[:B_PLAIN_W], plain, errs,
                  "mcpg_sweep_weighted")
    forced = FORCED_STAGE
    require_equal(f"K7 fused (forced stage of {forced} entries) vs K6 fused on W22like",
                  wsw.mcpg_sweep_weighted_fused(4242, bits, tw22, num_sweeps=2, node_chunk=forced), out, errs,
                  "mcpg_sweep_weighted_chunked")
    tw70 = wsw.WeightedSweepTables.build(w70, dev)
    bits70 = torch.rand(B70, w70.num_nodes, generator=gen, device=dev) < 0.5
    require_equal(f"K7 fused (chunk {chunk70}) vs K6 fused on W70like, {B70} chains",
                  wsw.mcpg_sweep_weighted_fused(99, bits70, tw70, num_sweeps=2, node_chunk=chunk70),
                  wsw.mcpg_sweep_weighted_fused(99, bits70, tw70, num_sweeps=2), errs, "mcpg_sweep_weighted_chunked")
    del tw70, bits70
    # a hub whose list spans several stages, nodes with empty lists
    th = wsw.WeightedSweepTables.build(hub, dev)
    degs = (th.offsets[1:] - th.offsets[:-1]).long()
    print(f"  {hub.name}: N={hub.num_nodes}, largest list {int(degs.max())} entries, {int((degs == 0).sum())} empty "
          f"lists, stages of {FORCED_STAGE} and {chunk70} entries")
    sub_h = torch.rand(B_PLAIN_W, hub.num_nodes, generator=gen, device=dev) < 0.5
    noise_h = torch.randint(0, 65536, (2 * hub.num_nodes, B_PLAIN_W), generator=gen, device=dev, dtype=torch.int32)
    plain_h = codec.unpack_bits(wsw._wsweep_plain(th, codec.pack_bits(sub_h), hub.num_nodes, 2, 0.25, noise_h, 0),
                                hub.num_nodes)
    for chunk in (None, FORCED_STAGE, chunk70):
        key = "mcpg_sweep_weighted" + ("_chunked" if chunk else "")
        require_equal(f"{'K7' if chunk else 'K6'} on {hub.name} (injected noise, stage {chunk})",
                      wsw.mcpg_sweep_weighted(noise_h, sub_h, th, num_sweeps=2, node_chunk=chunk), plain_h, errs, key)
    bits_h = torch.rand(B70, hub.num_nodes, generator=gen, device=dev) < 0.5
    k6_h = wsw.mcpg_sweep_weighted_fused(31, bits_h, th, num_sweeps=3)
    for chunk in (FORCED_STAGE, chunk70):
        require_equal(f"K7 fused (stage {chunk}) vs K6 fused on {hub.name}, {B70} chains, 3 sweeps",
                      wsw.mcpg_sweep_weighted_fused(31, bits_h, th, num_sweeps=3, node_chunk=chunk), k6_h, errs,
                      "mcpg_sweep_weighted_chunked")
    del th, sub_h, plain_h, bits_h, k6_h, noise_h
    require_equal("K6 fused vs K4 fused on G22like with random +-1 signs",
                  wsw.mcpg_sweep_weighted_fused(5, bits, wsw.WeightedSweepTables.build(g_pm, dev), num_sweeps=S),
                  sw.mcpg_sweep_fused(5, bits, sw.PackedSweepTables.build(g_pm, dev), num_sweeps=S), errs,
                  "mcpg_sweep_weighted")
    # K8a on W22-like (forced), Hub3000 and D2000-like; K8b on the same and
    # on W70-like and a 10,000-node path (a schedule of 10,000 levels); each
    # against the sequential plain sweep, the other kernel and the f32 sweep
    flip_checks = ((w22, B_WARM, (False, True)), (w70, W70_CHAINS, (True,)), (hub, W70_CHAINS, (False, True)),
                   (path, W70_CHAINS, (True,)), (d2000, B_WARM, (False, True)))
    for gw, b_warm, modes in flip_checks:
        aw = wsw.WeightedAdjPlanes.build(gw, dev)
        print(f"  {gw.name}: N={gw.num_nodes}, {aw.entries.shape[0]} list entries, a level schedule of depth "
              f"{aw.depth}, {aw.word_entries.shape[0] - 1} word entries ({(aw.word_entries.shape[0] - 1) / gw.num_nodes:.1f}"
              f" a row); 1-flip plan {engine.plan_1flip(gw, l2)}", flush=True)
        warm_w = torch.rand(b_warm, gw.num_nodes, generator=gen, device=dev) < 0.5
        plain_w = wsw._sweep_1flip_plain(warm_w, aw)
        env_w = MaxcutEnv(gw, dev)
        f32_bits, f32_vs = env_w.sweep_1flip(warm_w, env_w.obj(warm_w))
        for levels in modes:
            name, key = ("K8b", "sweep_1flip_weighted_levels") if levels else ("K8a", "sweep_1flip_weighted")
            out = wsw.sweep_1flip_weighted(warm_w, aw, levels=levels)
            require_equal(f"{name} on {gw.name} vs the sequential plain sweep", out, plain_w, errs, key)
            require_equal(f"{name} on {gw.name} vs the f32 incremental-gain sweep", out, f32_bits, errs, key)
            if not torch.equal(env_w.obj(out), f32_vs):
                raise AssertionError(f"{name}: cut values differ from the f32 sweep's")
        if len(modes) == 2:
            require_equal(f"K8a vs K8b on {gw.name}", wsw.sweep_1flip_weighted(warm_w, aw),
                          wsw.sweep_1flip_weighted(warm_w, aw, levels=True), errs, "sweep_1flip_weighted")
        del env_w, aw, plain_w

    # K10 at L2A's shapes (256 sims x 8 repeats), on integer and real weights
    B_L2A = l2a.L2AConfig().num_sims * l2a.L2AConfig().num_repeats
    if B_L2A != B_WARM:
        raise AssertionError("K10 is checked against K5 on the warm start's chains: L2A's count must match")
    k10_cases = {}
    for gk, env_k, xs_k in ((g, env32, warm), (build_f22_like(), None, None), (build_complete_f32(), None, None)):
        if env_k is None:
            env_k = MaxcutEnv(gk, dev)
            xs_k = torch.rand(B_L2A, gk.num_nodes, generator=gen, device=dev) < 0.5
        args = (env_k.cg.adj, cut.signs_from_bits(xs_k), env_k.gains(xs_k), env_k.obj(xs_k))
        out_k = sk.sweep_1flip_f32(*args, env_k.f32_lists)
        for part, a, b in zip(("s", "gains", "vs"), out_k, sk.sweep_1flip_f32_plain(*args)):
            require_equal(f"K10 sweep_1flip_f32 on {gk.name}: {part}", a, b, errs, "sweep_1flip_f32")
        k10_cases[gk.name] = (args, env_k.f32_lists, out_k[0] != args[1])
        lens = (env_k.f32_lists.offsets[1:] - env_k.f32_lists.offsets[:-1]).float()
        print(f"  K10 on {gk.name}: {int(k10_cases[gk.name][2].sum())} accepted flips in {B_L2A} chains, lists of "
              f"{float(lens.mean()):.1f} entries on average", flush=True)
        if gk is g:
            require_equal("K10 vs K5 on G22like", out_k[0] > 0, sw.sweep_1flip_packed(warm, adj), errs,
                          "sweep_1flip_f32")
    del env_k, out_k

    # K11 and K12 (one ring kernel) at the MH shapes of bench.py, at 1001
    # chains x 1000 rounds (neither a multiple of its tile, of 4 or of its
    # ring's chunk) with nodes -1 and N among the proposals, and at N = 10000
    def check_injected(label, nd, uu, p, x):
        """K11 and K12 on the same draws, each bit for bit against its plain
        version; returns their outputs."""
        nn, wx = x.shape[1], codec.pack_bits(x)
        a2 = mh.make_round_accepts(nd.clamp(0, nn - 1), uu, p)  # any acc2 for an out-of-range node
        o11, o12 = mh.mh_sample_onehot(nd, uu, p, x), mh.mh_sample_packed(nd, a2, x)
        require_equal(f"K11 {label}", o11, codec.unpack_bits(mh.mh_onehot_plain(nd, uu, p, wx, nn), nn), errs,
                      "mh_sample_onehot")
        require_equal(f"K12 {label}", o12, codec.unpack_bits(mh.mh_packed_plain(nd, a2, wx, nn), nn), errs,
                      "mh_sample_packed")
        return o11, o12

    mh_bits = bits[:MH_CHAINS].contiguous()
    nodes, u = mh.make_round_randoms(gen, MH_ROUNDS, MH_CHAINS, n)
    acc2 = mh.make_round_accepts(nodes, u, probs)
    k11_out, k12_out = check_injected(f"at {MH_CHAINS} chains x {MH_ROUNDS} rounds", nodes, u, probs, mh_bits)
    nd, uu = mh.make_round_randoms(gen, 1000, 1001, n)
    pick = torch.rand(1000, 1001, generator=gen, device=dev)
    nd = torch.where(pick < 0.05, -1, torch.where(pick > 0.95, n, nd)).to(torch.int32)
    check_injected("on 1001 chains x 1000 rounds, nodes -1 and N mixed in", nd, uu, probs, bits[:1001].contiguous())
    n10 = 10000
    p10 = torch.rand(n10, generator=gen, device=dev) * 0.6 + 0.2
    x10 = torch.rand(MH_CHAINS, n10, generator=gen, device=dev) < 0.5
    nd, uu = mh.make_round_randoms(gen, MH_ROUNDS, MH_CHAINS, n10)
    check_injected(f"at N = {n10}", nd, uu, p10, x10)
    # where the ring shrinks beside a 32-chain tile: 2 stages at N = 52,000,
    # 1 at 55,000, and at 58,000 none (the stream read from device memory)
    for n_big in (52000, 55000, 58000):
        p_big = torch.rand(n_big, generator=gen, device=dev) * 0.6 + 0.2
        x_big = torch.rand(130, n_big, generator=gen, device=dev) < 0.5
        nd, uu = mh.make_round_randoms(gen, 300, 130, n_big)
        check_injected(f"at N = {n_big} (130 chains x 300 rounds)", nd, uu, p_big, x_big)
    del x10, p10, pick, p_big, x_big
    grid = torch.round(probs * 65536.0) / 65536.0  # 1 - (1 - p) == p in f32 on this grid
    require_equal("K11 vs K12 on probs of the 2^-16 grid", mh.mh_sample_onehot(nodes, u, grid, mh_bits),
                  mh.mh_sample_packed(nodes, mh.make_round_accepts(nodes, u, grid), mh_bits), errs, "mh_sample_onehot")
    print(f"  K11 vs K12 on the policy's own probs: {int((k11_out != k12_out).sum())} bits differ "
          f"of {k11_out.numel()} (one f32 rounding apart; PERF.md)")
    marg = zeros
    for _ in range(10):
        nd, uu = mh.make_round_randoms(gen, 2 * n, MH_CHAINS, n)
        marg = mh.mh_sample_onehot(nd, uu, probs, marg)
    err = float((marg.float().mean(0) - probs).abs().max())
    print(f"  K11 marginals after {20 * n} rounds from all-zero chains: max |mean - p| = {err:.4f} (limit 0.03)")
    if not err < 0.03:
        raise AssertionError("K11 does not reach the policy's marginals")
    del noise, noise_w, out, plain, sub, marg, nd, uu
    torch.cuda.synchronize()
    phase("check", t0)

    # 3. the stream path: K2 alone, on the chains and stream of the checks ------
    t0 = time.time()
    build.reset_counts()
    out = mh.mh_sample_stream(stream, bits)
    torch.cuda.synchronize()
    stream_counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  mh_sample_stream: {ROUNDS} rounds on {B} chains; launches {stream_counts}")
    if stream_counts["mh_sample_stream"] <= 0:
        raise AssertionError("stream path did not launch mh_sample_stream")
    if not torch.equal(out, k2_out):
        raise AssertionError("stream path: K2 gave another result on the same inputs")
    del stream, out, k2_out
    phase("stream", t0)

    # the injected (node, u) samplers: K11 and K12 alone, on their check's inputs
    t0 = time.time()
    build.reset_counts()
    out_a = mh.mh_sample_onehot(nodes, u, probs, mh_bits)
    out_b = mh.mh_sample_packed(nodes, acc2, mh_bits)
    torch.cuda.synchronize()
    injected_counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  mh_sample_onehot, mh_sample_packed: {MH_ROUNDS} rounds on {MH_CHAINS} chains; launches {injected_counts}")
    for k in ("mh_sample_onehot", "mh_sample_packed"):
        if injected_counts[k] <= 0:
            raise AssertionError(f"injected path did not launch {k}")
    if not (torch.equal(out_a, k11_out) and torch.equal(out_b, k12_out)):
        raise AssertionError("injected path: K11/K12 gave another result on the same inputs")
    del out_a, out_b
    phase("injected", t0)

    # 4. main path: MCPG --fast at 2^20 chains ------------------------------
    t0 = time.time()
    fast_cfg = dataclasses.replace(preset, sampler="fused", sweep_mode="packed", max_epoch_num=1,
                                   reset_epoch_num=32, seed=0)
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    best_x, best_v, ev = solve_maxcut_mcpg(g, fast_cfg, device=dev)
    torch.cuda.synchronize()
    fast_counts = {k.name: k.launches for k in build.KERNELS}
    host = obj_maxcut(best_x.astype("int64"), g)
    times = [b[2] - a[2] for a, b in zip(ev.records, ev.records[1:])]
    print(f"  C={fast_cfg.total_mcmc_num} R={fast_cfg.repeat_times} -> {B} chains, N={n}, "
          f"num_ls={S}, {ROUNDS} MH rounds per round; cut to max_epoch_num=1, {len(times)} rounds")
    print(f"  best cut {best_v} host re-score {host} seconds/round {times} samples/s {[B / t for t in times]}")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB launches {fast_counts}")
    if host != best_v:
        raise AssertionError(f"main: best cut {best_v} != host re-score {host}")
    for k in ("mh_sample_fused", "mcpg_sweep", "sweep_1flip"):
        if fast_counts[k] <= 0:
            raise AssertionError(f"main path did not launch {k}")
    phase("main", t0)

    # 5, 6. MCPG --fast on the weighted stand-ins ------------------------------
    weighted_counts, weighted_cfgs = {}, {}
    for gw, cfg_w, sweep_k in (
        (w22, dataclasses.replace(fast_cfg, reset_epoch_num=16), "mcpg_sweep_weighted"),
        (w70, dataclasses.replace(GSET_PRESETS_40G["gset_70"], repeat_times=W70_REPEATS, sampler="fused",
                                  sweep_mode="packed", max_epoch_num=1, reset_epoch_num=16, seed=0),
         "mcpg_sweep_weighted_chunked"),
    ):
        t0 = time.time()
        sweep_eng, flip_eng = engine.plan_sweep(gw, l2), engine.plan_1flip(gw, l2)
        flip_k = FLIP_KERNELS[flip_eng.levels]
        print(f"  {gw.name}: sweep plan {sweep_eng}, 1-flip plan {flip_eng}")
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        best_x, best_v, ev = solve_maxcut_mcpg(gw, cfg_w, device=dev)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in build.KERNELS}
        weighted_counts[gw.name] = counts
        host = obj_maxcut(best_x.astype("int64"), gw)
        times = [b[2] - a[2] for a, b in zip(ev.records, ev.records[1:])]
        bw = cfg_w.total_mcmc_num * cfg_w.repeat_times
        print(f"  C={cfg_w.total_mcmc_num} R={cfg_w.repeat_times} -> {bw} chains, N={gw.num_nodes}, "
              f"num_ls={cfg_w.num_ls}; {len(times)} rounds")
        print(f"  best cut {best_v} host re-score {host} seconds/round {times} samples/s {[bw / t for t in times]}")
        print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB launches {counts}")
        if host != best_v:
            raise AssertionError(f"{gw.name}: best cut {best_v} != host re-score {host}")
        for k in ("mh_sample_fused", sweep_k, flip_k):
            if counts[k] <= 0:
                raise AssertionError(f"{gw.name} path did not launch {k}")
        wrong = [k for k in SWEEPS if k not in (sweep_k, flip_k) and counts[k]]
        if wrong:
            raise AssertionError(f"{gw.name}: the engine chose other kernels than expected: {wrong}")
        weighted_cfgs[gw.name] = cfg_w
        phase(gw.name.lower().replace("like", ""), t0)

    # parallel local search with the packed 1-flip sweep on D2000-like -------
    t0 = time.time()
    ls_cfg = LocalSearchConfig(num_sims=B_WARM, packed_sweep=True, seed=0)
    flip_d = engine.plan_1flip(d2000, l2)
    print(f"  {d2000.name}: {d2000.num_edges} edges, {2 * d2000.num_edges / d2000.num_nodes:.1f} neighbours a node; "
          f"1-flip plan {flip_d}")
    build.reset_counts()
    best_x, best_v, ev = solve_maxcut_local_search(d2000, ls_cfg, device=dev)
    torch.cuda.synchronize()
    d2000_counts = {k.name: k.launches for k in build.KERNELS}
    host = obj_maxcut(best_x.astype("int64"), d2000)
    print(f"  {ls_cfg.num_sims} chains, {ls_cfg.num_iters} iterations: best cut {best_v} host re-score {host}; "
          f"launches {d2000_counts}")
    if host != best_v:
        raise AssertionError(f"d2000: best cut {best_v} != host re-score {host}")
    ran = [k for k in SWEEPS if d2000_counts[k]]
    if ran != [FLIP_KERNELS[flip_d.levels]]:
        raise AssertionError(f"d2000: the packed 1-flip sweeps {ran} ran, the rule picks {FLIP_KERNELS[flip_d.levels]}")
    if not any(c["sweep_1flip_weighted"] for c in (*weighted_counts.values(), d2000_counts)):
        raise AssertionError("K8a launched on no solver path")
    phase("d2000", t0)

    # where one --fast round's device time goes (torch.profiler) -------------
    t0 = time.time()

    def profile_round(gr, cfg_r, chains):
        env = MaxcutEnv(gr, dev, packed_sweep=True)
        steps = _build_steps(env, None, cfg_r)
        policy, optimizer = new_policy(gr.num_nodes, cfg_r, dev)
        best_xs = chains[: cfg_r.total_mcmc_num].clone()

        def one_round():
            probs_r = policy().detach()
            mh_r, ls_r, cuts_r = steps.sample_step(gen, probs_r, chains)
            steps.reduce_step(ls_r, cuts_r, best_xs.clone(), env.obj(best_xs))
            steps.update_step(policy, optimizer, mh_r, cuts_r)
            torch.cuda.synchronize()

        one_round()
        profile_device(f"one --fast round on {gr.name} at {chains.shape[0]} chains", one_round)

    profile_round(g, fast_cfg, bits)
    profile_round(w22, weighted_cfgs["W22like"], bits)
    cfg70 = weighted_cfgs["W70like"]
    profile_round(w70, cfg70, torch.rand(cfg70.total_mcmc_num * cfg70.repeat_times, w70.num_nodes, generator=gen,
                                         device=dev) < 0.5)
    # the G22-like and W70-like solves' warm starts, as solve_maxcut_mcpg runs
    # them: local search rounds on C chains, each ending in a 1-flip sweep
    # (K5 on G22-like, K8b on W70-like)
    for gr, cfg_r in ((g, fast_cfg), (w70, cfg70)):
        env_r = MaxcutEnv(gr, dev, packed_sweep=True)
        xs_r = env_r.random_xs(gen, cfg_r.total_mcmc_num)

        def warm_start():
            xs, vs = xs_r, env_r.obj(xs_r)
            for _ in range(cfg_r.warmup_ls_rounds):
                xs, vs = env_r.local_search(gen, xs, vs)

        warm_start()
        profile_device(f"the {gr.name} solve's warm start ({cfg_r.warmup_ls_rounds} local-search rounds on "
                       f"{cfg_r.total_mcmc_num} chains)", warm_start)
        del env_r, xs_r
    phase("profile", t0)

    # 8. L2A on G22-like at the default widths ------------------------------
    t0 = time.time()
    full_cfg = l2a.L2AConfig()
    l2a_cfg = dataclasses.replace(full_cfg, pretrain_steps=20, num_iters=2, seq_len=4, seed=0)
    print(f"  L2AConfig widths: num_sims {l2a_cfg.num_sims}, num_repeats {l2a_cfg.num_repeats}, top_k "
          f"{l2a_cfg.top_k}, num_searchers {l2a_cfg.num_searchers}, ls_iters {l2a_cfg.ls_iters}, embed_dim "
          f"{l2a_cfg.embed_dim}, num_heads {l2a_cfg.num_heads}, update_times {l2a_cfg.update_times}; depth cut: "
          f"pretrain_steps {full_cfg.pretrain_steps}->{l2a_cfg.pretrain_steps}, num_iters {full_cfg.num_iters}->"
          f"{l2a_cfg.num_iters}, seq_len {full_cfg.seq_len}->{l2a_cfg.seq_len}")

    def plain_f32_sweep_on_the_card(*args):
        raise AssertionError("the plain f32 1-flip loop ran on the card")

    plain_f32 = sk.sweep_1flip_f32_plain
    sk.sweep_1flip_f32_plain = plain_f32_sweep_on_the_card
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    l2a_times = {}
    try:
        best_x, best_v, ev = l2a.solve_maxcut_l2a(g, l2a_cfg, device=dev, timings=l2a_times)
        torch.cuda.synchronize()
    finally:
        sk.sweep_1flip_f32_plain = plain_f32
    l2a_counts = {k.name: k.launches for k in build.KERNELS}
    host = obj_maxcut(best_x.astype("int64"), g)
    print(f"  G22like: {l2a_cfg.num_sims} x {l2a_cfg.num_repeats} = {B_L2A} candidates per step; pretrain "
          f"{l2a_times['pretrain'][0]:.3f} s; seconds per rollout step {l2a_times['rollout']}; seconds per PPO "
          f"update {l2a_times['ppo']}")
    print(f"  best cut {best_v} host re-score {host} (cuts by iteration {[r[1] for r in ev.records]})")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB launches {l2a_counts}")
    if host != best_v:
        raise AssertionError(f"l2a: best cut {best_v} != host re-score {host}")
    if l2a_counts["sweep_1flip_f32"] <= 0:
        raise AssertionError("the l2a path did not launch sweep_1flip_f32")
    wrong = [k for k in SWEEPS if l2a_counts[k]]
    if wrong:
        raise AssertionError(f"l2a: packed sweeps launched without packed_sweep/fused_ls: {wrong}")
    phase("l2a", t0)

    # where an L2A rollout step and a PPO update spend their device time
    t0 = time.time()
    env_l = MaxcutEnv(g, dev)
    gen_l = torch.Generator(device=dev)
    gen_l.manual_seed(1)
    _, seq_graph = l2a.pretrain_graph_encoder(g, dataclasses.replace(l2a_cfg, pretrain_steps=1), gen_l, dev)
    net = PolicyTrsWithValue(l2a_cfg.embed_dim, l2a_cfg.num_heads, seed=1, device=dev)
    steps_l = l2a._build_l2a_steps(env_l, net, seq_graph, l2a_cfg, ClippedAdam(net.parameters(), l2a_cfg.lr))
    xs_l = env_l.random_xs(gen_l, l2a_cfg.num_sims)
    vs_l = env_l.obj(xs_l)
    states, rewards, logprobs = [xs_l], [], []
    for _ in range(l2a_cfg.seq_len):
        xs_l, vs_l, r, lp = steps_l.rollout_step(gen_l, xs_l, vs_l)
        states.append(xs_l)
        rewards.append(r)
        logprobs.append(lp)
    batch = l2a.RolloutBatch(torch.stack(states), torch.stack(rewards), torch.stack(logprobs))
    steps_l.ppo_update(gen_l, batch)
    profile_device(f"one L2A rollout step ({B_L2A} candidates)", lambda: steps_l.rollout_step(gen_l, xs_l, vs_l))
    profile_device(f"one PPO update ({l2a_cfg.update_times} minibatches of {l2a_cfg.num_sims}, T = "
                   f"{l2a_cfg.seq_len})", lambda: steps_l.ppo_update(gen_l, batch))
    del env_l, net, steps_l, batch, states, seq_graph
    phase("l2a_profile", t0)

    # distribution-wise L2A at BA_1000's widths ----------------------------------
    t0 = time.time()
    dist_counts = run_l2a_dist(dev, errs)
    phase("l2a_dist", t0)

    # MCPG across problems and batched MCPG ------------------------------------
    t0 = time.time()
    multi_counts, k3_shapes = run_mcpg_multi(dev, errs)
    phase("mcpg_multi", t0)
    t0 = time.time()
    batch_counts = run_mcpg_batch(dev)
    phase("mcpg_batch", t0)
    t0 = time.time()
    baseline_counts = run_baselines(dev, errs)
    phase("baselines", t0)

    # Pattern I: ECO-DQN, S2V-DQN, Jumanji PPO, bench.py's pattern1 datum -------
    build.reset_counts()
    for name, run in (("eco", run_eco), ("s2v", run_s2v), ("jumanji", run_jumanji), ("pattern1", run_pattern1)):
        t0 = time.time()
        run(dev)
        phase(name, t0)
    pattern_i_counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  launches in eco, s2v, jumanji and pattern1: {pattern_i_counts} (no kernel of the port lies on "
          f"the Pattern I path: the MPNN's GEMMs and the env's elementwise ops are torch)", flush=True)

    # 9. CLI ------------------------------------------------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=REPO) as data_dir:
        with open(os.path.join(data_dir, "W22like.txt"), "w") as f:  # gset format, 1-indexed
            f.write(f"{w22.num_nodes} {w22.num_edges}\n")
            f.writelines(f"{a + 1} {b + 1} {int(x)}\n" for (a, b), x in zip(w22.edges.tolist(), w22.weights))
        runs = [(["--alg", "mcpg", "--fast", "--data-dir", data_dir, "--prefixes", "W22like"], 2)]
        runs += [(["--alg", alg] + fast, 1) for alg in ("l2a", "local_search") for fast in ([], ["--fast"])]
        for args, count in runs:
            proc = subprocess.run([sys.executable, "-m", "rlsolver_tpu_torch", *args, "--graphs", "BA_100_ID0"],
                                  capture_output=True, text=True, cwd=REPO, timeout=600)
            print("  " + proc.stdout.strip().replace("\n", "\n  "), flush=True)
            if proc.returncode != 0 or proc.stdout.count("obj=") != count:
                raise AssertionError(f"CLI {args} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    # the baselines' entries in this process (the module entry point above
    # starts a new process, about 8 s each)
    import contextlib
    import io
    from rlsolver_tpu_torch.run import main as cli_main
    for alg in ("sa", "isco", "ga"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["--alg", alg, "--graphs", "BA_100_ID0"])
        print("  " + out.getvalue().strip(), flush=True)
        if rc != 0 or out.getvalue().count("obj=") != 1:
            raise AssertionError(f"CLI --alg {alg} failed ({rc}): {out.getvalue()}")
    phase("cli", t0)

    # 10. timings at each path's shapes ---------------------------------------
    t0 = time.time()
    words = codec.pack_bits(bits)
    warm_words = codec.pack_bits(warm)
    stream = proposal_stream()
    thr1, thr2 = sw._noisy_thresholds(tables, 0.25)
    word_bytes = 2 * B * w * 4  # chains read and written once
    # K4: sweep 1 meets m_proc and m_unproc (and their negative planes),
    # later sweeps m_all (and its negative plane)
    sp = 2 if tables.signed else 1
    first_w, later_w = 2 * sp * n * w, sp * n * w
    k4_first, k4_later = tables.masks[: 2 * sp], tables.masks[2 * sp : 4 * sp]
    k4_work = scan_work(B, S, (nonzero(k4_first), nonzero(k4_later)), (first_w, later_w),
                        (plane_reads(k4_first), plane_reads(k4_later)))
    k4_steps = B * n * S * (STEP_OPS + PHILOX_OPS // 4)
    # K6 on G22-like's own neighbour lists (k = 1 plane), the same sweeps: a
    # yardstick for K4 (K6 gives K4's bits)
    tw_g22 = wsw.WeightedSweepTables.build(g, dev)
    t1_g22, t2_g22 = sw._noisy_thresholds(tw_g22, 0.25)
    k5_planes = torch.stack([adj.pos] + ([adj.neg] if adj.neg is not None else []))
    k5_work = scan_work(B_WARM, 1, (nonzero(k5_planes), 0), (k5_planes.numel(), 0), (plane_reads(k5_planes), 0))
    lv22 = adj.levels
    k5_layout = lv22.layout
    aw22 = wsw.WeightedAdjPlanes.build(g, dev)  # G22-like's natural-order lists, for the list reckoning and K8b
    k5_list_work = (2 * B_WARM * w * 4 + lv22.table_bytes, NBR_INT_OPS * B_WARM * lv22.num_entries + B_WARM * n * STEP_OPS,
                    -(-B_WARM // 32) * list_reads(aw22.offsets, aw22.entries))
    rows = [
        dict(name="mh_sample_stream", kernel=mh.MH_STREAM, launches=stream_counts["mh_sample_stream"],
             run=lambda: mh.MH_STREAM.launch(stream, words, B, w, ROUNDS),
             plain=lambda: mh.mh_stream_plain(stream, words), plain_chains=B, reps=10,
             bytes=word_bytes + stream.numel() * 4, step_ops=ROUNDS * B * K2_OPS),
        dict(name="mh_sample_fused", kernel=mh.MH_FUSED, launches=fast_counts["mh_sample_fused"],
             run=lambda: mh.MH_FUSED.launch(thr, words, B, w, n, ROUNDS, 12345),
             plain=lambda: mh.mh_fused_plain(12345, thr, words, n, ROUNDS), plain_chains=B, reps=10,
             bytes=word_bytes + thr.numel() * 4, step_ops=ROUNDS * B * K3_OPS),
        dict(name="mcpg_sweep", kernel=sw.MCPG_SWEEP, launches=fast_counts["mcpg_sweep"],
             run=lambda: sw.MCPG_SWEEP.launch(tables.nodes, thr1, thr2, tables.word_offsets, tables.word_entries, 0,
                                              None, 1, 777, 0.25 / 65536.0, words, B, w, n, S),
             plain=lambda: sw._sweep_plain(tables, words[:B_PLAIN_SWEEP], n, S, 0.25, None, 777),
             plain_chains=B_PLAIN_SWEEP, reps=2,
             bytes=word_bytes + (tables.word_entries.numel() + tables.word_offsets.numel() + 3 * n) * 4, work=k4_work,
             step_ops=k4_steps,
             yardstick=("k6_on_the_same_graph_ms",
                        lambda: wsw.launch_sweep(tw_g22, words, t1_g22, t2_g22, None, 777, 0.25, S, None))),
        dict(name="sweep_1flip", kernel=sw.SWEEP_1FLIP, launches=fast_counts["sweep_1flip"],
             run=lambda: sw.SWEEP_1FLIP.launch(lv22.table, k5_layout[2], lv22.depth, k5_layout[0], k5_layout[1],
                                               warm_words, B_WARM, w),
             plain=lambda: sw._sweep_1flip_plain(warm, adj), plain_chains=B_WARM, reps=10,
             bytes=2 * B_WARM * w * 4 + k5_planes.numel() * 4 + n * 4, work=k5_work, step_ops=B_WARM * n * STEP_OPS,
             list_work=k5_list_work,
             yardstick=("k8b_on_the_same_graph_ms",
                        lambda: wsw.WSWEEP_1FLIP_LEVELS.launch(aw22.offsets, aw22.entries, aw22.level_nodes,
                                                               aw22.level_offsets, aw22.wdeg, warm_words, B_WARM, w,
                                                               aw22.depth))),
    ]

    def weighted_sweep_row(name, kernel, tab, wds, chunk, launches):
        """K6/K7 at a path's shapes (fused, S sweeps; K7 with its transposes);
        the plain version with injected noise on B_PLAIN_W chains and 2
        sweeps. Two reckonings of the bound: the bit-plane one (popcounts
        of the non-zero words) and the neighbour-list one."""
        nn, bb, ww = tab.num_nodes, wds.shape[0], wds.shape[1]
        e, m = tab.planes[0], tab.planes[1:]
        # sweep 1 needs pc(x & m & e) and pc(x & m & ~e), later sweeps pc(x & m)
        first = torch.cat([m & e, m & ~e])
        work = scan_work(bb, S, (nonzero(first), nonzero(m)), (2 * m.numel(), m.numel()),
                         (plane_reads(first), plane_reads(m)))
        steps = bb * nn * S * (STEP_OPS + PHILOX_OPS // 4)
        entries = tab.entries.shape[0]
        list_bytes = tab.entries.numel() * 4 + tab.offsets.numel() * 4
        list_work = (2 * bb * ww * 4 + list_bytes + 3 * nn * 4, NBR_INT_OPS * bb * S * entries + steps,
                     -(-bb // 32) * S * list_reads(tab.offsets, tab.entries))
        t1, t2 = sw._noisy_thresholds(tab, 0.25)
        nz = torch.randint(0, 65536, (2 * nn, B_PLAIN_W), generator=gen, device=dev, dtype=torch.int32)
        return dict(name=name, kernel=kernel, launches=launches,
                    run=lambda: wsw.launch_sweep(tab, wds, t1, t2, None, 777, 0.25, S, chunk),
                    plain=lambda: wsw._wsweep_plain(tab, wds[:B_PLAIN_W], nn, 2, 0.25, nz, 0),
                    plain_chains=B_PLAIN_W, plain_sweeps=2, reps=1 if chunk is None else 5,
                    bytes=2 * bb * ww * 4 + tab.planes.numel() * 4 + 3 * nn * 4, work=work, list_work=list_work,
                    step_ops=steps)

    def weighted_flip_row(name, kernel, aw, bits_w, levels, launches, reps):
        """K8a (each row's non-zero plane words) or K8b (lists in the level
        schedule). K8a's bound is the bit-plane reckoning (a popcount per
        chain per non-zero table word), its bytes the word entries; K8b's is
        the least of that and the neighbour-list reckoning (a bit extract
        and a multiply-add per neighbour, a step's own work, the list's
        bytes and reads)."""
        nn, bb = aw.num_nodes, bits_w.shape[0]
        ww = codec.num_words(nn)
        wds = codec.pack_bits(bits_w)
        work = scan_work(bb, 1, (nonzero(aw.planes), 0), (aw.planes.numel(), 0), (plane_reads(aw.planes), 0))
        words_tab = (aw.word_offsets, aw.word_entries, aw.wdeg)
        row = dict(name=name, kernel=kernel, launches=launches,
                   run=lambda: kernel.launch(*words_tab, aw.word_entries.shape[0] - 1, wds, bb, ww, nn),
                   plain=lambda: wsw._sweep_1flip_plain(bits_w, aw), plain_chains=bb, reps=reps,
                   bytes=2 * bb * ww * 4 + sum(t.numel() for t in words_tab) * 4, work=work,
                   step_ops=bb * nn * STEP_OPS)
        if levels:
            tabs = (aw.offsets, aw.entries, aw.level_nodes, aw.level_offsets, aw.wdeg)
            row["run"] = lambda: kernel.launch(*tabs, wds, bb, ww, aw.depth)
            row["bytes"] = 2 * bb * ww * 4 + aw.planes.numel() * 4 + nn * 4  # the planes K8b's bit-plane twin reads
            row["list_work"] = (2 * bb * ww * 4 + sum(t.numel() for t in tabs) * 4,
                                NBR_INT_OPS * bb * aw.entries.shape[0] + bb * nn * STEP_OPS,
                                -(-bb // 32) * list_reads(aw.offsets, aw.entries))
        return row

    def flip_pair_ms(aw, bits_w):
        """K8a's and K8b's ms on the same chains, in the order K8a K8b K8b K8a
        (each the mean of 5 launches)."""
        nn, bb = aw.num_nodes, bits_w.shape[0]
        ww = codec.num_words(nn)
        wds = codec.pack_bits(bits_w)
        k8a = lambda: wsw.WSWEEP_1FLIP.launch(aw.word_offsets, aw.word_entries, aw.wdeg, aw.word_entries.shape[0] - 1,
                                              wds, bb, ww, nn)
        k8b = lambda: wsw.WSWEEP_1FLIP_LEVELS.launch(aw.offsets, aw.entries, aw.level_nodes, aw.level_offsets,
                                                     aw.wdeg, wds, bb, ww, aw.depth)
        a1, b1, b2, a2 = (cuda_ms(f, 5) for f in (k8a, k8b, k8b, k8a))
        return (a1 + a2) / 2, (b1 + b2) / 2

    c22, c70 = weighted_counts["W22like"], weighted_counts["W70like"]
    n70 = w70.num_nodes

    def path_launches(key):
        """A 1-flip kernel's launches over the solver paths that run it."""
        return sum(c[key] for c in (c22, c70, d2000_counts))

    rows += [
        weighted_sweep_row("mcpg_sweep_weighted", wsw.WSWEEP, tw22, words, None, c22["mcpg_sweep_weighted"]),
        weighted_sweep_row("mcpg_sweep_weighted_chunked", wsw.WSWEEP_CHUNKED, wsw.WeightedSweepTables.build(w70, dev),
                           codec.pack_bits(torch.rand(B70, n70, generator=gen, device=dev) < 0.5), chunk70,
                           c70["mcpg_sweep_weighted_chunked"]),
        weighted_flip_row("sweep_1flip_weighted", wsw.WSWEEP_1FLIP, wsw.WeightedAdjPlanes.build(d2000, dev),
                          torch.rand(B_WARM, d2000.num_nodes, generator=gen, device=dev) < 0.5, False,
                          path_launches("sweep_1flip_weighted"), 10),
        weighted_flip_row("sweep_1flip_weighted_levels", wsw.WSWEEP_1FLIP_LEVELS,
                          wsw.WeightedAdjPlanes.build(w70, dev),
                          torch.rand(W70_CHAINS, n70, generator=gen, device=dev) < 0.5, True,
                          path_launches("sweep_1flip_weighted_levels"), 10),
    ]
    # K8a beside K8b on D2000-like (10% density) and W22-like, 2048 chains
    flip_pairs = {}
    for gw in (d2000, w22):
        aw = wsw.WeightedAdjPlanes.build(gw, dev)
        ta, tb = flip_pair_ms(aw, torch.rand(B_WARM, gw.num_nodes, generator=gen, device=dev) < 0.5)
        flip_pairs[gw.name] = dict(k8a_ms=ta, k8b_ms=tb, k8b_depth=aw.depth,
                                   word_entries_per_row=(aw.word_entries.shape[0] - 1) / gw.num_nodes,
                                   neighbours_per_node=2 * gw.num_edges / gw.num_nodes)
        print(f"  {gw.name}, {B_WARM} chains: K8a {ta:.3f} ms, K8b {tb:.3f} ms (depth {aw.depth}); "
              f"{flip_pairs[gw.name]['word_entries_per_row']:.1f} word entries a row, "
              f"{flip_pairs[gw.name]['neighbours_per_node']:.1f} neighbours a node", flush=True)
        del aw
    # K10 on the G22-like check's chains: each timed launch first restores
    # the input state (timed alone and taken off)
    (adj22, s22, g22, v22), lists22, accepted22 = k10_cases["G22like"]
    ws, wg, wv = s22.clone(), g22.clone(), v22.clone()
    # the listed neighbours of every accepted flip: one f32 FMA each
    listed22 = float((accepted22.float() @ (lists22.offsets[1:] - lists22.offsets[:-1]).float()).sum())
    state_bytes = 2 * (2 * B_L2A * n * 4 + B_L2A * 4)  # s, gains and vs in and out

    def k10_restore():
        ws.copy_(s22)
        wg.copy_(g22)
        wv.copy_(v22)

    def k10_run():
        k10_restore()
        sk.SWEEP_1FLIP_F32.launch(lists22.offsets, lists22.entries, ws, wg, wv, B_L2A, n)

    mh_w = codec.pack_bits(mh_bits)
    w_mh = codec.num_words(n)
    rows += [
        dict(name="sweep_1flip_f32", kernel=sk.SWEEP_1FLIP_F32, launches=l2a_counts["sweep_1flip_f32"],
             run=k10_run, restore=k10_restore, plain=lambda: sk.sweep_1flip_f32_plain(adj22, s22, g22, v22),
             plain_chains=B_L2A, reps=10, step_ops=0,
             bytes=state_bytes + (lists22.entries.numel() + lists22.offsets.numel()) * 4,
             # the f32 updates the accepted flips' lists need, and those of
             # every rank-1 update (with the dense rows' bytes)
             f32=(listed22 * K10_F32_OPS + B_L2A * n * K10_STEP_OPS,
                  B_L2A * n * n * K10_F32_OPS + B_L2A * n * K10_STEP_OPS),
             dense_bytes=state_bytes + n * n * 4, list_bytes_read=listed22 * 8),
        dict(name="mh_sample_onehot", kernel=mh.MH_ONEHOT, launches=injected_counts["mh_sample_onehot"],
             run=lambda: mh.MH_ONEHOT.launch(nodes, u, probs, mh_w, MH_CHAINS, MH_CHAINS, w_mh, n, MH_ROUNDS),
             plain=lambda: mh.mh_onehot_plain(nodes, u, probs, mh_w, n), plain_chains=MH_CHAINS, reps=10,
             bytes=2 * MH_CHAINS * w_mh * 4 + MH_ROUNDS * MH_CHAINS * 8 + n * 4,
             step_ops=MH_ROUNDS * MH_CHAINS * K11_OPS,
             chain_floor=True),
        dict(name="mh_sample_packed", kernel=mh.MH_PACKED, launches=injected_counts["mh_sample_packed"],
             run=lambda: mh.MH_PACKED.launch(nodes, acc2, mh_w, MH_CHAINS, MH_CHAINS, w_mh, n, MH_ROUNDS),
             plain=lambda: mh.mh_packed_plain(nodes, acc2, mh_w, n), plain_chains=MH_CHAINS, reps=10,
             bytes=2 * MH_CHAINS * w_mh * 4 + MH_ROUNDS * MH_CHAINS * 8, step_ops=MH_ROUNDS * MH_CHAINS * K2_OPS),
    ]
    kernels = []
    for row in rows:
        ms = cuda_ms(row["run"], row["reps"])
        if "restore" in row:
            ms -= cuda_ms(row["restore"], row["reps"])
        plain_ms = cuda_ms(row["plain"], 1, warmup=False)  # slow; warmed up by the checks
        # the bound counts the popcounts (K10: the f32 updates) the data
        # needs; the dense bound, kept beside it, those of a scan of every
        # table word (K10: of every rank-1 update)
        popc, dense_popc, warp_reads = row.get("work", (0, 0, 0))
        f32_ops, dense_f32 = row.get("f32", (0, 0))
        bound_ms, bound_by = bound(row["bytes"], WORD_INT_OPS * popc + row["step_ops"], popc, warp_reads, f32_ops)
        k = row["kernel"]
        kernels.append(dict(
            name=row["name"], route="cuda", source=f"rlsolver_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=row["launches"], max_abs_err=errs[row["name"]], ms=ms, plain_ms=plain_ms,
            plain_chains=row["plain_chains"], bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ))
        if "work" in row:
            kernels[-1]["dense_bound_ms"] = bound(row["bytes"], WORD_INT_OPS * dense_popc + row["step_ops"],
                                                  dense_popc)[0]
            kernels[-1]["needed_over_dense_popcounts"] = popc / dense_popc
        if "list_work" in row:
            list_ms, list_by = bound(row["list_work"][0], row["list_work"][1], 0, row["list_work"][2])
            kernels[-1].update(bitplane_bound_ms=bound_ms, bitplane_bound_by=bound_by, list_bound_ms=list_ms,
                               list_bound_by=list_by)
            print(f"  {row['name']}: bit-plane reckoning {bound_ms:.3f} ms ({bound_by}), neighbour-list "
                  f"reckoning {list_ms:.3f} ms ({list_by})")
            if list_ms < bound_ms:
                kernels[-1].update(bound_ms=list_ms, bound_by=list_by)
                bound_ms, bound_by = list_ms, list_by
        if "f32" in row:
            kernels[-1]["dense_bound_ms"] = bound(row["dense_bytes"], row["step_ops"], 0, 0, dense_f32)[0]
            kernels[-1]["needed_over_dense_f32_ops"] = f32_ops / dense_f32
            # each warp reads the lists of its chain's accepted flips
            kernels[-1]["list_bytes_read"] = row["list_bytes_read"]
            print(f"  {row['name']}: list entries read per launch {row['list_bytes_read'] / 1e9:.4f} GB "
                  f"({row['list_bytes_read'] / ms / 1e9:.3f} TB/s), {f32_ops:.4g} f32 operations, "
                  f"{row['bytes'] / 1e6:.1f} MB of state and lists")
        if "plain_sweeps" in row:
            kernels[-1]["plain_sweeps"] = row["plain_sweeps"]
        if row.get("chain_floor"):
            floor_ms = 1e3 * MH_ROUNDS * K11_CHAIN_ACCESSES * SMEM_LATENCY_CYCLES / BOOST_CLOCK_HZ
            print(f"  {row['name']}: chain floor {floor_ms:.4f} ms, assumed, not measured ({MH_ROUNDS} dependent "
                  f"rounds of {K11_CHAIN_ACCESSES} shared-memory accesses at an assumed {SMEM_LATENCY_CYCLES} cycles)")
        if "yardstick" in row:
            key, fn = row["yardstick"]
            kernels[-1][key] = cuda_ms(fn, row["reps"])
            print(f"  {row['name']}: {ms:.3f} ms beside {key} {kernels[-1][key]:.3f} ms")
        print(f"  {row['name']}: {ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}; dense bound "
              f"{kernels[-1].get('dense_bound_ms', bound_ms):.3f} ms); "
              f"plain {plain_ms:.1f} ms on {row['plain_chains']} chains", flush=True)
    for k in kernels:
        k["l2a_dist_launches"] = dist_counts[k["name"]]
        k["mcpg_multi_launches"] = multi_counts[k["name"]]
        if k["name"] == "mh_sample_fused":
            k["mcpg_multi_shapes"] = k3_shapes
        k["mcpg_batch_launches"] = batch_counts[k["name"]]
        k["baselines_launches"] = baseline_counts[k["name"]]
        k["pattern_i_launches"] = pattern_i_counts[k["name"]]
        if k["name"] == "sweep_1flip_weighted":
            k["beside_k8b"] = flip_pairs
    phase("time", t0)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
