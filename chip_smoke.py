"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  1. build   — nvcc builds every kernel source in rlsolver_tpu_torch/csrc for
               sm_90a, one compiler per source, all at once;
  2. check   — every kernel's wrapper runs on the card at its path's shapes
               and is held bit for bit against its plain PyTorch version:
               K2-K5 on the G22-like graph (N = 2000; 2^20 chains for the
               sampler and the sweep, 2048 for the warm start's 1-flip
               sweep); K2 (the stream through the bulk-copy ring) also on
               1001 chains (rows padded to 1004) with words W and past it
               among the proposals; K3 in the form `fused_form` picks (the
               chain form at 2^20), and both its forms on the wide path
               (N = 2^15 + 3, 4099 chains, 101 rounds); K5 (signed
               neighbour lists in a level schedule, copied into shared
               memory) also on a +-1 G22-like, on Hub3000's topology with unit and +-1
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
               ring shrinks to 2 stages, 1 and none; K2 beside a 32-chain
               tile on 130 chains at N = 52,000, 57,500, 57,700 and 58,000
               (its ring's 4 stages, 2, 1 and none); K11 against K12 on
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
               and the plain f32 loop is made to raise for the run;
     runners — the solvers on the training runtime (`run_runners`):
               `solve_maxcut_mcpg_runner` with gset_22's GSET_PRESETS widths
               (2048 x 224 chains), fused/packed, on G22-like, 4 rounds with a
               checkpoint every 2, straight and killed after round 2 then
               resumed; `solve_maxcut_l2a_runner` at the l2a phase's config,
               2 iterations with a checkpoint each, then resumed from the
               straight run's iteration-1 checkpoint; each resumed state equal
               to the straight one leaf by leaf, bit for bit, each best cut
               equal to its host re-score, K3 (the chain form at 458,752
               chains, timed there), K4 and K5 (MCPG) and K10 (L2A)
               launched, no other sweep, their plain versions made to raise;
               the checkpoint's bytes and the seconds per round beside the
               main phase's; then the device time by kernel of one rollout
               step and of the first 4 of a PPO update's 16 minibatches of
               the L2A runner's steps;
     problems — the CLI's problem axis (`run_problems`): greedy MIS, MVC and
               partitioning and the four colorings on BA_1000_ID0..2 (each
               re-scored, each coloring proper); knapsack on
               generate_knapsack(1000, 0): DP on the card equal to branch and
               bound, FPTAS at least 0.9 DP, SA and greedy at most DP; set
               cover on an instance of OR-Library's scp4 shape (200 rows, 1000
               columns, 2%): anneal_set_cover at least as good as greedy, and
               the device time of a 100-step window; anneal_partition beside
               Karmarkar-Karp on 1000 integers; then `cli_main` in this
               process for every new --problem/--alg pair with --write, the
               comparison CSV of `eval.statistics` over the results (MILP
               stopped at 2 s for partitioning and set cover, cut from 5 s),
               and `--alg milp --milp-time-limit 5` on maxcut;
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
               subset-sum with 8 tags: K3 must launch in every solve (the
               split form, which `fused_form` picks at 8192 chains), equal
               its plain version on the first 256 chains at each problem's
               (N, 8192 chains, MH rounds), timed there beside the chain
               form, and every best score its float64 host re-score (the
               edge-pair sweep replays chunks of 512 edges as CUDA graphs,
               held bit for bit to its eager loop over two chunks); then
               the device time by kernel of one QUBO and
               one MaxSAT round (`run_mcpg_multi`);
     mcpg_batch — `solve_maxcut_mcpg_batched` with DIST_TABLE's MCPG protocol
               (256 x 32 chains, 8 sweeps, 6 epochs of 8 rounds) at full
               depth on BA_100_ID0..9 and, cut to 2 epochs, on
               BA_1000_ID0..9, each family in one call: best cuts equal to
               their host re-scores, printed
               beside the JAX run's (results_quality/dist_table.csv); the
               device time of one BA_1000 round (its MH rounds and each
               sweep replayed as CUDA graphs) and the graphed round bit for
               bit equal to the eager loops'; then one round of MCPG's
               colored sweep mode on G22-like beside one of the sequential
               mode, their best cuts within 2% (`run_mcpg_batch`);
     baselines — DIST_TABLE's classical columns, ISCO and PI-GNN at
               scripts/quality_table.py's budgets and cell protocols
               (`run_baselines`): Greedy on BA_100_ID0..9 and BA_1000_ID0..9,
               each cut equal to dist_table.csv's; RandomWalk, SDP, SA (256
               chains x max(2000, 12 N) steps, replayed as CUDA graphs of 250
               steps, held bit for bit to the eager loop over a BA_100 run) and GA (40 / 64 generations, K10
               each generation) on BA_100_ID0..9, SA and GA also on
               BA_1000_ID0..3; the ISCO cell (256 x 600 on BA_100, 96 x 2000 on
               BA_1000_ID0..9); the PI-GNN cell (its training replayed as
               CUDA graphs of 100 steps, held bit for bit to the eager steps
               over 500) and the spectral-bound cell
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
               first 100 steps of a BA_1000 rollout, graphed and eager (the
               rollouts replay CUDA graphs of 100 steps, one per step offset,
               held leaf for leaf to the eager rollout on BA_100_ID0) (`run_eco`);
     s2v     — S2V-DQN at scripts/quality_table.py:228-284's protocol on BA_100
               at full depth (`train_scan` of 6144 loop steps, 32 envs, the
               irreversible S2V env), then one greedy rollout on each of
               BA_100_ID0..9: cuts equal to their host re-scores, mean above
               the RandomWalk column's 234.8, printed beside the JAX run's
               (within 2% expected, not enforced) (`run_s2v`);
     jumanji — `train_spin_ppo` at scripts/quality_table.py:171-227's protocol
               on BA_100 (128 envs x 200 steps), its 100 iterations cut to
               JUMANJI_ITERS = 30 to leave room for the tsp and l2o phases,
               then `make_greedy_evaluator` at 64 envs on BA_100_ID0..9,
               with the s2v phase's checks (`run_jumanji`);
     pattern1 — bench.py:38-268's `pattern1_peco` on the port (BA_800_ID0,
               MPNN(64, 3), env counts 512-4096 through `find_best_num_sims`,
               the env-only twin, the host CPU twin, DQN train steps/s; then
               bf16 over the f32 winner x1, x2, x4), one JSON line with
               bench.py's key names, the device time of one f32 block, and a
               DQN `train_runner` whose mid-way `torch.save` checkpoint must
               restore bit for bit (`run_pattern1`); no kernel of the port
               lies on these four phases' path, and their launches are
               counted and printed;
     tnco    — TNCO at random_circuit_nodes(53, 12, seed=0), Sycamore N53's
               12-layer shape (418 tensors, 677 bonds, 6770 bits; after
               baselines, `run_tnco`): K3 (the split form) bit for bit
               against its plain version at MCPG's 128 chains x 6770 bits x
               64 rounds and timed there beside the chain form, with a
               chain's serial floor (one chain's launches);
               `solve_tnco_mcpg` at TncoMcpgConfig's widths (32 x
               4 chains, 64 MH rounds, 4 local-search iterations), 4 of 30
               rounds, with sampler="fused" (K3 must launch) and "scan" (no
               kernel); `solve_tnco_local_search` at its defaults, 2 of 30
               rounds; every order a permutation of the bonds, every cost its
               float64 re-score within 1e-4, every history non-increasing,
               every cost below the best of 128 random orders; an
               evaluation's CUDA graph equal to the eager step loop; s/round,
               s/evaluation, the device time of one fused round, peak
               memory; then MCPG (scan, 30 rounds) at random_circuit_nodes(12,
               14) for seeds 0-2, their mean within the JAX package's CPU
               runs' range (JAX_TNCO_SMALL) widened by 0.1;
     ppo     — flip-MDP PPO on G22-like at PPOConfig's widths (128 envs x 64
               steps, 4 minibatches x 4 epochs), PPO_ITERS iterations, the
               device time of one; A2C; a warm start from greedy's cut as a
               start_str (every env at it); an untrained S2V constructive
               policy's greedy and sampled rollouts on BA_100_ID0..9 (each
               cut its host re-score); a PER round at DQN's replay capacity
               (8192 adds, unequal priorities written, 4096 draws whose
               frequencies and weights follow them, a sample of 64, its
               update); losses finite, how far PPO moved its policy in
               PPO_ITERS iterations (KL from the start, entropy drop) within
               JAX's seeds' range, the same run at lr = 0 outside it; no
               kernel launched (`run_ppo`);
     beamforming — `train_beamforming` at its defaults (4 users x 4
               antennas, batch 256, episode 6, 300 steps) for seeds 0-2, the
               mean final rate within JAX's seeds' range (JAX_BEAMFORMING)
               widened by 0.1; the trained policy at least MMSE less 0.3 on
               a held-out batch, ZF nulling interference, MMSE at least ZF at
               low SNR, the relay's rates finite and positive
               (`run_beamforming`);
     tsp     — the TSP axis (`run_tsp`; no kernel on its path): POMO at
               POMOConfig's widths (embed 128, 4 heads, 3 layers, batch 64,
               TSP20, 200 steps; seed 0, TSP_PORT_SEEDS), x8 greedy inference
               on generate_tsp_coords(128, 20, seed=20) (every tour a
               permutation, every length its float64 re-score), the mean within
               the JAX package's CPU seeds 0-2's range (JAX_POMO) widened by
               their spread, an lr = 0 control (its parameters checked unmoved)
               outside it, the device time of one training step; a width-4 beam search; a sampled rollout and x8
               inference at TSP100 (batch 64, P = 100), timed; TSPEnv.anneal
               at its defaults (5000 steps) on 1024 random tours of the TSP100
               instance generate_tsp_coords(1, 100, seed=100), then
               two_opt_descent (both replayed as CUDA graphs of 100 steps,
               held equal to the eager loops bit for bit over a 200-step
               window), the best lengths' float64 re-scores within JAX's seeds
               0-2's range widened by their spread, the window profiled
               eager; 3-opt, or-opt, tabu search and the GA there,
               each no longer than its start; the CLI's --problem tsp with nn,
               christofides, karp_steele and cheapest_insertion on that
               instance and on generate_tsp_coords(1, 1000, seed=1000), written
               as .tsp files, each length equal to JAX's CPU run's within 1e-4
               (JAX_TSP_CLI); train_reinforce with the rollout baseline (40
               steps, at least one t-test swap) and with the S2V maxcut adapter
               on BA_100 (30 steps; greedy cuts equal to their host re-scores),
               every loss finite; peak memory;
     l2o     — `--alg seq2seq` and `--alg l2o` through the CLI in this process
               on BA_100_ID0 at their default configs, seeds 0-2, each mean at
               least JAX's less 1%; RUN-CSP's maxcut language trained on
               BA_100_ID0..3 and boosted (8 starts) on each, seeds 0-5 (cut
               from 0-9 for room), the mean at least JAX's over the same seeds
               less 1%; DCS at its
               defaults, seeds 0-2, the mean recovery error within JAX's range
               widened by its spread, every untrained error above it
               (`run_l2o`; the JAX numbers come from
               scripts/jax_tsp_l2o_reference.py);
     rlor    — tests/test_rlor_rl.py's protocols with the scorers on the card
               and the LPs on the host (`run_rlor`): the cut policy at its
               own parameters (60 updates x 8 episodes, 3 rounds, the
               deceptive knapsacks, greedy on seeds 0-19), branching on set
               cover 20 x 40 (strong-branching samples on 8 instances, IL
               then RL cut to 10 x 6 episodes, 10 eval instances up to 3000
               nodes) twice: a replay from the JAX package's seed-0 initial
               parameters, which must give JAX seed 0's node counts, where
               rl < il < mf holds, and a run from the port's own seed-0
               draw, its rl and il within JAX's seeds 0-2 and il < mf; then
               pricing cut to 10 x 6 (30 cutting-stock instances): learned
               bound below max-violation's, every B&B objective equal to
               scipy's milp, pricing tying exact pricing's integer value in
               fewer iterations; the headlines within JAX's seeds 0-2
               (RLOR_*, JAX_RLOR; scripts/jax_rlor_agents_reference.py);
               seconds per LP solve, per scoring call and per B&B node, the
               device idle share of one RL update; no kernel launched;
     agents  — DDPG, TD3 and SAC at OffPolicyConfig's widths on
               PointChasingEnv (1024 envs x 32 steps into the ring, 300
               updates), each rollout reward after training above the one
               before and within JAX's seeds' range widened by
               AGENT_REWARD_MARGIN; EmbedDQN on the contextual bandit at
               its config's batch, seeds 0-2 (mean accuracy above 0.9); VDN, QMIX, MAPPO and MADDPG on
               tests/test_multi_agent.py's goal env with its assertions;
               StockTradingEnv.random_walk(252, 30) at 4096 envs for 251
               steps under a SAC actor (never short, never overspent beyond
               f32 rounding, rewards summing to the float64 asset change
               within 1e-3); seconds per update and the idle share of one
               update for each agent; no kernel launched (`run_agents`);
     parallel — the data-parallel layer (`run_parallel`): world size 1 over
               NCCL in this process, then `dryrun_multichip(2)`, whose two
               spawned ranks share the card over gloo (the backend chosen by
               `parallel.launch.choose_backend`, printed) and then run the
               forms at world size 2: solve_tnco_mcpg_sharded at the tnco
               phase's Sycamore N53 shape (4 rounds, the chains sharded, the
               MH scan), train_ppo_sharded at PPOConfig's widths on G22-like
               (the ppo phase's 40 iterations), data-parallel L2A at
               L2AConfig's widths on G22-like (the l2a phase's depth cut;
               K10 on every rank, its plain version made to raise) and POMO
               steps at POMOConfig's widths (graphed; at world size 2 also
               eager); world size 1 equal to the unsharded runs bit for bit;
               the replicated state equal across ranks bit for bit after
               every step, every reduced metric the host's reduction of the
               ranks' own values and the one the solver returned, every best
               cost or cut its host re-score, POMO's tour lengths within
               1e-5 of the host's float64 re-score of its tours; K10 at a
               rank's shard shape (1024 chains of G22-like) bit for bit;
               s/step beside the unsharded step and one all-reduce of each
               path's gradient buffer, over NCCL and over gloo;
  9. cli     — `python -m rlsolver_tpu_torch --alg mcpg --fast` on BA_100_ID0
               and on W22-like written as a gset file; then the CLI's `main`
               in this process with `--alg l2a` and `--alg local_search` on
               BA_100_ID0 with and without `--fast`, `--alg sa`, `--alg isco`
               and `--alg ga` on BA_100_ID0 and `--alg vqe` on BA_16_ID0 (each
               re-scored by the CLI, which raises on a mismatch);
 10. time    — kernel, plain-version and bound times at each path's shapes
               (K7's with its transposes; K8a on D2000-like, the d2000
               phase's graph and chains; K3's chain form at 2^20 chains
               and its split form at mcpg_multi's 8192 chains x 1000
               rounds on G22-like, each with a chain's serial floor: R x
               one round's dependent latency from one chain's launches),
               K6 on G22-like's own lists beside
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

import contextlib
import copy
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
SPLIT_CHAINS, SPLIT_ROUNDS = 8192, 1000  # mcpg_multi's K3 shape on G22-like (256 x 32 chains, N = 2000)
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


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms of fn() over `reps` calls captured in one CUDA graph
    and replayed, so that no host time falls between the launches (K3's
    short launches), after one eager call."""
    fn()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):  # by hand: torch.cuda.graph would gc.collect and empty_cache at each capture
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    graph.replay()
    return cuda_ms(graph.replay, 1, warmup=False) / reps


FORM_SECONDS: dict = {}  # by phase: the wall seconds of K2's ring checks and K3's two forms' checks and timings


@contextlib.contextmanager
def form_seconds(key: str):
    """Adds the block's wall seconds, the card synchronised at both ends, to
    FORM_SECONDS[key]: what the checks and timings of K2's ring and of K3's
    two forms take of the script's time limit."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    yield
    torch.cuda.synchronize()
    FORM_SECONDS[key] = FORM_SECONDS.get(key, 0.0) + time.perf_counter() - t


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


def k3_serial(thr, n: int, rounds: int, probe: int = 2000) -> dict:
    """A chain's serial floor in K3 at `rounds` rounds: one chain's launch of
    `probe` and of 2 x `probe` rounds in each form, whose difference over
    `probe` is one round's dependent latency (the launch's own cost
    cancels); the floor is `rounds` x the lesser of the forms' latencies."""
    from rlsolver_tpu_torch.ops.kernels import codec, mh_sampler as mh
    words = torch.zeros(1, codec.num_words(n), dtype=torch.int32, device=thr.device)
    lat = {}
    for k in (mh.MH_FUSED, mh.MH_FUSED_SPLIT):
        t1, t2 = (graph_ms(lambda r=r: mh.launch_fused(k, thr, words, n, r, 99)) for r in (probe, 2 * probe))
        lat[k.name] = 1e3 * (t2 - t1) / probe
    return dict(serial_round_us=lat, serial_floor_ms=rounds * min(lat.values()) / 1e3)


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


def plains_raise(pairs):
    """Makes each (module, name) plain kernel version raise where it is
    called (a run whose kernels must all launch on the card); returns the
    originals for `restore`."""
    def plain_on_the_card(*args, **kwargs):
        raise AssertionError(f"a plain kernel version ran on the card: one of {[a for _, a in pairs]}")

    saved = [getattr(m, a) for m, a in pairs]
    for m, a in pairs:
        setattr(m, a, plain_on_the_card)
    return saved


def restore(pairs, saved) -> None:
    for (m, a), fn in zip(pairs, saved):
        setattr(m, a, fn)


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

    plains = [(sk, "sweep_1flip_f32_plain"), (sw, "_sweep_1flip_plain"), (wsw, "_sweep_1flip_plain"),
              (sw, "_sweep_plain"), (wsw, "_wsweep_plain")]
    saved = plains_raise(plains)
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
        restore(plains, saved)
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
MULTI_EDGE_CHUNKS = 2  # edge-pair sweep chunks held to the eager loop (graph against eager)
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
        k3 = mh.fused_kernel(chains.shape[0], words.shape[1], dev)
        scratch = words.clone()
        with form_seconds("mcpg_multi"):
            k3_ms, chain_ms = (graph_ms(lambda: mh.launch_fused(kern, thr, scratch, prob.num_vars, rounds, 4321))
                               for kern in (k3, mh.MH_FUSED))
        k3_bound = bound(2 * words.numel() * 4 + thr.numel() * 4, rounds * chains.shape[0] * K3_OPS, 0)
        k3_shapes.append(dict(problem=name, chains=chains.shape[0], n=prob.num_vars, rounds=rounds, form=k3.name,
                              ms=k3_ms, chain_form_ms=chain_ms, bound_ms=k3_bound[0], bound_by=k3_bound[1]))
        out = mh.mh_sample_fused(4321, probs, chains, rounds)[:MULTI_PLAIN]
        plain = codec.unpack_bits(mh.mh_fused_plain(4321, thr, words[:MULTI_PLAIN], prob.num_vars, rounds),
                                  prob.num_vars)
        require_equal(f"K3 {k3.name} at {name}'s shape (first {MULTI_PLAIN} of {chains.shape[0]} chains, "
                      f"N = {prob.num_vars}, {rounds} rounds)", out, plain, errs, k3.name)
        steady = secs[1:] or secs
        print(f"  {name}: N = {prob.num_vars}, {rounds} MH rounds; seconds per round {secs} (K3 {k3.name} "
              f"{k3_ms:.4f} ms, the chain form {chain_ms:.4f} ms, bound {k3_bound[0]:.4f} ms, "
              f"{100 * k3_ms / 1e3 / np.mean(steady):.3f}% of a later round); best score "
              f"{res.best_score} host re-score {host} (relative difference {rel:.3g}); history {res.history}; "
              f"max_memory_allocated {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB that earlier phases hold; launches {counts}", flush=True)
        if counts[k3.name] <= 0:
            raise AssertionError(f"mcpg_multi on {name} did not launch {k3.name}")
        if (integral and res.best_score != host) or not rel <= 1e-5:
            raise AssertionError(f"mcpg_multi on {name}: best score {res.best_score} != host re-score {host}")
        if name.startswith("mimo"):
            ber = lambda x: float(np.mean(x != mimo_inst.x_true))
            print(f"    bit error rate: MCPG {ber(np.where(res.best_bits, 1.0, -1.0))}, ZF "
                  f"{ber(mimo.detect_zf(mimo_inst))}, MMSE {ber(mimo.detect_mmse(mimo_inst))}")
        del chains, words, out, plain

    # the edge-pair sweep's chunk graphs against its eager loop, on the first
    # MULTI_EDGE_CHUNKS chunks (one graph replayed at each chunk's edges)
    from rlsolver_tpu_torch.ops import sweeps as sw_ops

    edges = sw_ops.EdgeSweepData.build(g, dev)
    edges_eager = edges._replace(graphs=sw_ops.Graphs(enabled=False))
    bits = torch.rand(MULTI_CHAINS * MULTI_REPEATS, g.num_nodes, generator=gen, device=dev) < 0.5
    u = torch.rand(MULTI_EDGE_CHUNKS * sw_ops.EDGE_CHUNK, 4, bits.shape[0], generator=gen, device=dev)
    part = [edges._replace(ends=edges.ends[: u.shape[0]]), edges_eager._replace(ends=edges.ends[: u.shape[0]])]
    graphed, eager = (sw_ops.edge_pair_sweep(None, bits, d, 1, 0.1, noise=u) for d in part)
    if not torch.equal(graphed, eager):
        raise AssertionError("mcpg_multi: the edge-pair sweep's chunk graphs differ from its eager loop")
    print(f"  the edge-pair sweep's chunk graphs equal its eager loop bit for bit over the first "
          f"{u.shape[0]} edges of G22like ({MULTI_EDGE_CHUNKS} chunks of {sw_ops.EDGE_CHUNK})", flush=True)
    del edges, edges_eager, part, bits, u

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
    from rlsolver_tpu_torch.capture import Graphs
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

    loops = Graphs()

    def batch_round():
        mh_b, ls_b, cuts_b = mb.sample_round(gen, logits, start, sg, cfg, graphs=loops)
        mb.reduce_round(ls_b, cuts_b, best_xs.clone(), best_vs.clone(), cfg.repeat_times)
        mb.update_round(logits, optimizer, mh_b, cuts_b, sg, cfg.sample_epoch_num)

    batch_round()
    profile_device(f"one mcpg_batch round on BA_1000_ID0..9 (10 x {start.shape[1]} chains, MH rounds and sweeps "
                   f"as CUDA graphs)", batch_round)
    # the graphed MH rounds and sweeps against the eager loops, from one generator state
    state = gen.get_state()
    with torch.no_grad():
        graphed = mb.sample_round(gen, logits, start, sg, cfg, graphs=loops)
        gen.set_state(state)
        t_eager = time.time()
        eager = mb.sample_round(gen, logits, start, sg, cfg)
        torch.cuda.synchronize()
        t_eager = time.time() - t_eager
    for name, a, b in zip(("MH samples", "swept bits", "cuts"), graphed, eager):
        if not torch.equal(a, b):
            raise AssertionError(f"mcpg_batch: the graphed round's {name} differ from the eager loop's")
    print(f"  the graphed BA_1000 round (MH rounds and {cfg.num_ls} sweeps) equals the eager loops' bit for bit; the "
          f"eager sample {t_eager:.3f} s", flush=True)
    del sg, start, graphed, eager, loops

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
JUMANJI_ITERS = 30  # depth cut from quality_table.py's 100 iterations: room for the tsp and l2o phases
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
    from rlsolver_tpu_torch.algos.dqn import ROLLOUT_GRAPH_STEPS, DQNAgent, DQNConfig
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
        if n == sizes[0]:  # the rollouts replay CUDA graphs: the eager rollout's final state, leaf for leaf
            g = graph_from_name(f"BA_{n}_ID0")
            t0 = time.time()
            agent.evaluate_scan(params, g)
            graphed, graph_s = agent.last_eval_state, time.time() - t0
            t0 = time.time()
            agent.evaluate_scan(params, g, cuda_graph=False)
            eager_s = time.time() - t0
            if not all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for a, b in zip(graphed, agent.last_eval_state)):
                raise AssertionError(f"ECO-DQN {g.name}: the CUDA graphs' rollout differs from the eager one")
            print(f"  ECO-DQN {g.name}: the rollout as CUDA graphs of {ROLLOUT_GRAPH_STEPS} steps equals the eager "
                  f"rollout leaf for leaf ({eager_s:.3f} s eager, {graph_s:.3f} s graphed)", flush=True)
    phase_memory("eco", base)
    # the profiler's trace of all 2000 steps would hold about 0.7 M events,
    # minutes to gather: the first ECO_PROFILE_STEPS steps of a BA_1000
    # rollout (the same widths; a step's work does not change along the rollout)
    g = graph_from_name(f"BA_{sizes[-1]}_ID0")
    window = DQNAgent(SpinSystemEnv(g.num_nodes, dataclasses.replace(agent.env.config, max_steps=ECO_PROFILE_STEPS)),
                      dcfg, device=dev)
    window.evaluate_scan(params, g)
    profile_device(f"the first {ECO_PROFILE_STEPS} steps of an ECO-DQN rollout on {g.name} "
                   f"({agent.env.config.num_envs} envs, bf16, one CUDA graph replay)",
                   lambda: window.evaluate_scan(params, g))
    profile_device(f"the same {ECO_PROFILE_STEPS} steps, eager", lambda: window.evaluate_scan(params, g, cuda_graph=False))


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


def run_jumanji(dev, iters: int = JUMANJI_ITERS) -> None:
    """Jumanji PPO at scripts/quality_table.py:171-227's protocol on BA_100:
    train_spin_ppo on generate_graph(BA, 100, seed=91000), 128 envs, 200
    steps, `iters` iterations (the protocol's 100 cut to JUMANJI_ITERS),
    then make_greedy_evaluator at 64 envs on BA_100_ID0..9."""
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
    # SA's loop replays CUDA graphs of sa.GRAPH_STEPS steps: the same chains
    # as the eager loop, bit for bit, over a whole BA_100 run's 2000 steps
    g, sa_gen = graphs[100][0], torch.Generator(device=dev).manual_seed(7)
    cg = cut.CutGraph.build(g, dev)
    sa_steps = sa.SAConfig(num_chains=256).num_steps
    xs = torch.rand(256, g.num_nodes, generator=sa_gen, device=dev) < 0.5
    nodes = torch.randint(0, g.num_nodes, (sa_steps, 256), generator=sa_gen, device=dev)
    u = torch.rand(sa_steps, 256, generator=sa_gen, device=dev)
    temps = torch.from_numpy(sa.temperatures(sa.SAConfig(num_chains=256))).to(dev)
    sa_wall = {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        t0 = time.time()
        sa_wall[graphed] = sa.anneal_chains(cg, xs, nodes, u, temps, cuda_graph=graphed)
        torch.cuda.synchronize()
        sa_wall[graphed] += (time.time() - t0,)
    if not all(torch.equal(a, b) for a, b in zip(sa_wall[True][:2], sa_wall[False][:2])):
        raise AssertionError("SA: the CUDA graphs' chains differ from the eager loop's")
    print(f"  SA on {g.name} (256 chains x {sa_steps} steps): CUDA graphs of {sa.GRAPH_STEPS} steps equal the eager "
          f"loop bit for bit; {sa_wall[True][2]:.3f} s graphed, {sa_wall[False][2]:.3f} s eager", flush=True)
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
    # the cell's training replays CUDA graphs of pignn.GRAPH_STEPS steps: the
    # eager steps' results bit for bit over one chunk of 500
    from rlsolver_tpu_torch.algos import pignn
    runs, walls = [], []
    for graphed in (True, False):
        torch.cuda.synchronize()
        t0 = time.time()
        runs.append(pignn.train_pignn_cell(graphs[100], PIGNNConfig(max_steps=500), device=dev, cuda_graph=graphed))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("PI-GNN: the CUDA graphs' training differs from the eager steps")
    print(f"  PI-GNN cell BA_100, 500 steps: CUDA graphs of {pignn.GRAPH_STEPS} steps equal the eager steps bit for "
          f"bit; {walls[0]:.3f} s graphed (two warm-up blocks and the capture included), {walls[1]:.3f} s eager",
          flush=True)
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
    profile_device(f"{SA_PROFILE_STEPS} SA steps on {g.name} (256 chains, eager)",
                   lambda: sa.anneal_chains(cg, xs, nodes, u, temps))
    temps = torch.from_numpy(sa.temperatures(sa_cfg)[:sa.GRAPH_STEPS]).to(dev)
    nodes = torch.randint(0, g.num_nodes, (sa.GRAPH_STEPS, 256), generator=gen, device=dev)
    u = torch.rand(sa.GRAPH_STEPS, 256, generator=gen, device=dev)
    sa.anneal_chains(cg, xs, nodes, u, temps)
    profile_device(f"{sa.GRAPH_STEPS} SA steps on {g.name} (256 chains, one CUDA graph replay)",
                   lambda: sa.anneal_chains(cg, xs, nodes, u, temps))
    icfg = ISCOConfig(batch_size=96, chain_length=2000, seed=0)
    smp = cell_sampler(graphs[1000], icfg, dev)
    carry = smp.init_carry(gen, (10, icfg.batch_size, 1000), dev)
    itemps = torch.from_numpy(smp.temperatures(icfg.chain_length)[:ISCO_PROFILE_STEPS]).to(dev)
    smp.run_segment(carry, itemps, gen)
    profile_device(f"{ISCO_PROFILE_STEPS} ISCO steps of the BA_1000 cell (10 x 96 chains)",
                   lambda: smp.run_segment(carry, itemps, gen))
    return path_launches


# The runners on the training runtime: MCPG at gset_22's GSET_PRESETS widths
# (2048 x 224 chains) with K3/K4/K5, rounds cut to RUNNER_ROUNDS (a checkpoint
# every RUNNER_CKPT), and L2A at L2AConfig's widths with the l2a phase's depth
# cut (K10), 2 iterations with a checkpoint each
RUNNER_ROUNDS, RUNNER_CKPT = 4, 2
RUNNER_PLAIN_SWEEP = 8192  # of the runner's chains, those K4's plain version checks (its Python loop is slow)
L2A_CUT = dict(pretrain_steps=20, num_iters=2, seq_len=4, seed=0)
L2A_PROFILE_UPDATES = 4  # of the PPO update's 16 minibatches, those profiled


def _metrics_rows(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_runners(dev, g, main_seconds, errs: dict, k3_at: dict) -> dict:
    """`solve_maxcut_mcpg_runner` and `solve_maxcut_l2a_runner` on G22-like
    through TrainLoop, each straight and killed-and-resumed, the resumed
    state held leaf by leaf against the straight one (bit for bit), every
    best cut against its host re-score, the launches (MCPG: K3, K4, K5 and
    no other sweep; L2A: K10 and no packed sweep), with the plain versions
    of those kernels made to raise; prints the checkpoint's bytes and the
    seconds per round beside the main phase's (`main_seconds`). Then holds
    K3 and K4 against their plain versions at the MCPG runner's shape, on
    its last round's restart rows and policy (into `errs`; K3 timed there
    into `k3_at`), and prints the
    device time of one rollout step and of the first L2A_PROFILE_UPDATES
    minibatches of a PPO update of the L2A runner's steps. Returns the
    launches of both runners."""
    import shutil
    from rlsolver_tpu_torch.algos import l2a, mcpg
    from rlsolver_tpu_torch.ops.kernels import build, codec, engine, mcpg_sweep as sw, mh_sampler as mh
    from rlsolver_tpu_torch.ops.kernels import sweep_kernel as sk
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    cfg = dataclasses.replace(mcpg.GSET_PRESETS["gset_22"], sampler="fused", sweep_mode="packed", seed=0)
    chains = cfg.total_mcmc_num * cfg.repeat_times
    print(f"  MCPG runner: gset_22 preset {cfg.total_mcmc_num} x {cfg.repeat_times} = {chains} chains, "
          f"fused/packed, {RUNNER_ROUNDS} of {cfg.max_epoch_num * cfg.reset_epoch_num // cfg.sample_epoch_num} "
          f"rounds, checkpoint every {RUNNER_CKPT}", flush=True)
    plains = [(mh, "mh_fused_plain"), (sw, "_sweep_plain"), (sw, "_sweep_1flip_plain"),
              (sk, "sweep_1flip_f32_plain")]
    with tempfile.TemporaryDirectory(dir=REPO) as root:
        saved = plains_raise(plains)
        build.reset_counts()
        try:
            t0 = time.time()
            bx, bv, straight = mcpg.solve_maxcut_mcpg_runner(g, cfg, os.path.join(root, "straight"),
                                                             total_rounds=RUNNER_ROUNDS,
                                                             checkpoint_every=RUNNER_CKPT, device=dev)
            torch.cuda.synchronize()
            t_straight = time.time() - t0
            t0 = time.time()
            mcpg.solve_maxcut_mcpg_runner(g, cfg, os.path.join(root, "part"), total_rounds=RUNNER_CKPT,
                                          checkpoint_every=RUNNER_CKPT, device=dev)
            _, _, resumed = mcpg.solve_maxcut_mcpg_runner(g, cfg, os.path.join(root, "part"),
                                                          total_rounds=RUNNER_ROUNDS, checkpoint_every=RUNNER_CKPT,
                                                          resume=True, device=dev)
            torch.cuda.synchronize()
            t_resume = time.time() - t0
        finally:
            restore(plains, saved)
        mcpg_counts = {k.name: k.launches for k in build.KERNELS}
        rows = _metrics_rows(os.path.join(root, "straight"))
        ckpt = os.path.join(root, "straight", "checkpoints", f"step_{RUNNER_ROUNDS}", "state.pt")
        ckpt_bytes = os.path.getsize(ckpt)
        leaves, equal = same_state(resumed, straight)
        host = obj_maxcut(bx.astype("int64"), g)
        per_round = [b["time"] - a["time"] for a, b in zip(rows, rows[1:])]
        print(f"  straight {t_straight:.2f} s, killed at round {RUNNER_CKPT} and resumed {t_resume:.2f} s; "
              f"resumed state equal to the straight one on {equal} of {leaves} leaves", flush=True)
        print(f"  best cut {bv} host re-score {host}; best_cut by round {[r['best_cut'] for r in rows]}; seconds per "
              f"round {per_round} (main phase, 2^20 chains: {main_seconds}); samples/s "
              f"{[chains / t for t in per_round]}; checkpoint {ckpt_bytes} bytes", flush=True)
        if equal != leaves:
            raise AssertionError(f"MCPG runner: {leaves - equal} of {leaves} leaves differ after the resume")
        if host != bv:
            raise AssertionError(f"MCPG runner: best cut {bv} != host re-score {host}")
        k3 = mh.fused_kernel(chains, codec.num_words(g.num_nodes), dev)
        require_launches("MCPG runner", mcpg_counts, (k3.name, "mcpg_sweep", "sweep_1flip"),
                         [k for k in SWEEPS if k not in ("mcpg_sweep", "sweep_1flip")])

        # K3 and K4 at the runner's shape: the next round's restart rows (R
        # copies of the C chains) under the last round's policy, K3's MH
        # rounds as the runner's (`mcpg._build_steps`), then K4 on K3's output
        # with the runner's engine and sweeps (the plain K4 on the first
        # RUNNER_PLAIN_SWEEP chains; the noise is keyed by seed and chain)
        n = g.num_nodes
        policy, _ = mcpg.new_policy(n, cfg, dev)
        with torch.no_grad():
            policy.logits.copy_(straight.logits)
            probs = policy()
        rows = straight.start_xs.repeat(cfg.repeat_times, 1)
        rounds = max(cfg.num_ls, 2 * (cfg.change_times or max(1, n // 10)))
        out = mh.mh_sample_fused(4321, probs, rows, rounds)
        thr, words = mh.fused_thresholds(probs), codec.pack_bits(rows)
        plain = codec.unpack_bits(mh.mh_fused_plain(4321, thr, words, n, rounds), n)
        require_equal(f"K3 {k3.name} at the MCPG runner's shape ({rows.shape[0]} chains, {rounds} rounds)",
                      out, plain, errs, k3.name)
        with form_seconds("runners"):
            k3_at["runner"] = dict(chains=rows.shape[0], n=n, rounds=rounds, form=k3.name,
                                   ms=graph_ms(lambda: mh.launch_fused(k3, thr, words, n, rounds, 4321), 5))
        print(f"  K3 at the MCPG runner's shape: {k3_at['runner']}", flush=True)
        eng = engine.FusedSweepEngine.build(g, dev)
        if eng.weighted:
            raise AssertionError("the MCPG runner's engine on G22-like is expected to be K4's, not the weighted one")
        swept = eng.sweep(8765, out, cfg.num_ls)[:RUNNER_PLAIN_SWEEP]
        plain = codec.unpack_bits(sw._sweep_plain(eng.tables, codec.pack_bits(out[:RUNNER_PLAIN_SWEEP].contiguous()),
                                                  n, cfg.num_ls, 0.25, None, 8765), n)
        require_equal(f"K4 mcpg_sweep_fused at the MCPG runner's shape (first {RUNNER_PLAIN_SWEEP} of "
                      f"{out.shape[0]} chains, {cfg.num_ls} sweeps)", swept, plain, errs, "mcpg_sweep")
        del rows, out, plain, swept

        # L2A through the runner: 2 iterations, then a resume from iteration 1's checkpoint
        l2a_cfg = dataclasses.replace(l2a.L2AConfig(), **L2A_CUT)
        saved = plains_raise(plains)
        build.reset_counts()
        times = {}
        try:
            full_dir, res_dir = os.path.join(root, "l2a"), os.path.join(root, "l2a_resume")
            t0 = time.time()
            bx, bv, full = l2a.solve_maxcut_l2a_runner(g, l2a_cfg, full_dir, checkpoint_every=1, device=dev,
                                                       timings=times)
            torch.cuda.synchronize()
            t_full = time.time() - t0
            shutil.copytree(os.path.join(full_dir, "checkpoints", "step_1"),
                            os.path.join(res_dir, "checkpoints", "step_1"))
            t0 = time.time()
            _, _, res = l2a.solve_maxcut_l2a_runner(g, l2a_cfg, res_dir, checkpoint_every=1, resume=True,
                                                    device=dev)
            torch.cuda.synchronize()
            t_res = time.time() - t0
        finally:
            restore(plains, saved)
        l2a_counts = {k.name: k.launches for k in build.KERNELS}
        rows = _metrics_rows(full_dir)
        leaves, equal = same_state(res, full)
        host = obj_maxcut(bx.astype("int64"), g)
        print(f"  L2A runner: {l2a_cfg.num_sims} x {l2a_cfg.num_repeats} candidates, {L2A_CUT}; straight {t_full:.2f} "
              f"s (pretrain {times['pretrain'][0]:.3f} s, rollout steps {times['rollout']}, PPO updates "
              f"{times['ppo']}); resumed from iteration 1 in {t_res:.2f} s; {equal} of {leaves} leaves equal; "
              f"metrics {[(r['best_cut'], round(r['ppo_loss'], 6)) for r in rows]}; checkpoint "
              f"{os.path.getsize(os.path.join(full_dir, 'checkpoints', 'step_2', 'state.pt'))} bytes", flush=True)
        if equal != leaves:
            raise AssertionError(f"L2A runner: {leaves - equal} of {leaves} leaves differ after the resume")
        if host != bv:
            raise AssertionError(f"L2A runner: best cut {bv} != host re-score {host}")
        require_launches("L2A runner", l2a_counts, ("sweep_1flip_f32",), SWEEPS)

    # where one rollout step and one PPO update of the runner's steps spend
    # their device time: the runner's setup (the same seed: the same
    # encoder features and steps) with the resumed run's weights, Adam state
    # and incumbents, the batch of one rollout from them
    # (the update profiled over its first L2A_PROFILE_UPDATES of
    # update_times minibatches: each is the same work, and the profiler's
    # trace of all 16 took about 50 s)
    setup = l2a._l2a_setup(g, dataclasses.replace(l2a_cfg, update_times=L2A_PROFILE_UPDATES), dev)
    setup.net.load_state_dict(res.params)
    setup.optimizer.load_state_dict(res.opt_state)
    xs, vs, batch = l2a._rollout(setup.steps, res.generator, res.best_xs, res.best_vs, l2a_cfg.seq_len,
                                 l2a._Timings(dev, None))
    candidates = l2a_cfg.num_sims * l2a_cfg.num_repeats
    profile_device(f"one L2A runner rollout step ({candidates} candidates)",
                   lambda: setup.steps.rollout_step(res.generator, xs, vs))
    profile_device(f"one L2A runner PPO update, its first {L2A_PROFILE_UPDATES} of {l2a_cfg.update_times} "
                   f"minibatches of {l2a_cfg.num_sims}, T = {l2a_cfg.seq_len}",
                   lambda: setup.steps.ppo_update(res.generator, batch))
    return {k: mcpg_counts[k] + l2a_counts[k] for k in mcpg_counts}


# TNCO at Sycamore N53's 12-layer shape: MCPG at TncoMcpgConfig's widths, its
# depth cut from 30 rounds, both samplers; the local-search solver at its
# defaults, its depth cut likewise
TNCO_ROUNDS = 4
TNCO_LS_ROUNDS = 2
TNCO_RANDOM = 128  # random orders whose best cost every MCPG run must beat
# The JAX package's solve_tnco_mcpg (sampler="scan", TncoMcpgConfig's
# defaults, 30 rounds) at random_circuit_nodes(12, 14, seed=0), seeds 0-2,
# its train_beamforming (defaults; the mean of the last 10 rates), seeds
# 0-2, and the PPO runs below, on the CPU:
#   JAX_PLATFORMS=cpu python scripts/jax_tnco_beamforming_reference.py
JAX_TNCO_SMALL = (6.663870811462402, 6.524714469909668, 6.589798927307129)
JAX_BEAMFORMING = (8.251940631866455, 8.278915214538575, 8.247726821899414)
SPREAD_MARGIN = 0.1  # the port's mean must lie within JAX's seeds' range widened by this
# ... and its PPO on G22-like (PPOConfig's defaults, the step size annealed
# over 100 iterations), seeds 0-2: how far the policy moved in its first
# PPO_ITERS iterations, on the start observations (the envs' reset bits):
# the mean KL(pi_40 || pi_0) and the entropy of pi_0 less that of pi_40
JAX_PPO_KL = (0.24228733777999878, 0.21176251769065857, 0.18738308548927307)
JAX_PPO_ENTROPY_DROP = (0.14546585083007812, 0.11854410171508789, 0.14081859588623047)
# widened by about the KL's seed range: lr = 0 gives 0 and 0, at least 0.069
# below either band (PERF.md, PR 13)
PPO_MOVE_MARGIN = 0.05
PPO_ITERS, A2C_ITERS = 40, 10  # cut from PPOConfig's 100 iterations (the step size still annealed over 100)
PER_TD = (0.1, 1.0, 4.0, 16.0)  # |TD error| of slot k: PER_TD[k % 4]
PER_DRAWS = 4096  # draws whose frequencies are held to the priorities
VQE_GRAPH = "BA_16_ID0"  # the statevector VQE takes n <= 16 (2^16 amplitudes)


def within_spread(label: str, values, jax_values, margin: float = SPREAD_MARGIN) -> None:
    """Fails unless the mean of `values` lies in [min, max] of `jax_values`
    widened by `margin` on both sides."""
    mean, lo, hi = float(np.mean(values)), min(jax_values) - margin, max(jax_values) + margin
    print(f"  {label}: port {list(values)} (mean {mean:.4f}); JAX {list(jax_values)} (mean "
          f"{float(np.mean(jax_values)):.4f}); allowed [{lo:.4f}, {hi:.4f}]", flush=True)
    if not lo <= mean <= hi:
        raise AssertionError(f"{label}: the port's mean {mean:.4f} is outside [{lo:.4f}, {hi:.4f}]")


def policy_movement(model0, model, obs) -> tuple:
    """(mean KL(pi || pi_0), mean entropy of pi_0 less that of pi) over the
    rows of obs, pi_0 and pi the actor policies of model0 and model (as
    `scripts/jax_tnco_beamforming_reference.py:policy_movement`)."""
    with torch.no_grad():
        lp0 = torch.log_softmax(model0(obs)[0], dim=-1)
        lp = torch.log_softmax(model(obs)[0], dim=-1)
        kl = torch.sum(lp.exp() * (lp - lp0), dim=-1).mean()
        drop = torch.sum(lp.exp() * lp, dim=-1).mean() - torch.sum(lp0.exp() * lp0, dim=-1).mean()
    return float(kl), float(drop)


def check_order(label: str, env, order, cost: float, history, worse_than: float = None) -> None:
    """An order must be a permutation of the run edges, its cost equal to the
    float64 host twin's within 1e-4, its history non-increasing and, where
    given, its cost below `worse_than`."""
    if sorted(order.tolist()) != list(range(env.run_edges)):
        raise AssertionError(f"{label}: the returned order is not a permutation of the {env.run_edges} run edges")
    acc = float(env.log10_multiple_times_accurate(order[None])[0])
    if not abs(acc - cost) < 1e-4:
        raise AssertionError(f"{label}: cost {cost} but the float64 twin gives {acc}")
    if any(b > a for a, b in zip(history, history[1:])):
        raise AssertionError(f"{label}: the history increases: {history}")
    if worse_than is not None and not cost < worse_than:
        raise AssertionError(f"{label}: cost {cost} not below the best random order's {worse_than}")
    print(f"  {label}: log10 cost {cost:.6f} (float64 twin {acc:.6f}); history {[round(h, 4) for h in history]}",
          flush=True)


def run_tnco(dev, errs: dict):
    """TNCO on random_circuit_nodes(53, 12, seed=0), Sycamore N53's 12-layer
    shape (418 tensors, 677 bonds, 6770 bits): K3 bit for bit against its
    plain version at MCPG's shape (128 chains x 6770 bits x 64 rounds); MCPG
    with sampler="fused" (K3, the phase's main path, its launches counted)
    and "scan"; the local-search solver; every order a permutation, every
    cost its float64 re-score, every history non-increasing, both MCPG runs
    below the best of 128 random orders; s/round, s/evaluation, the idle
    share of one round, peak memory, K3's ms; then the quality check on
    random_circuit_nodes(12, 14) against JAX's seeds. Returns (the phase's
    launches, K3's timing at TNCO's shape)."""
    from rlsolver_tpu_torch.algos.tnco_solver import (TncoMcpgConfig, TncoSearchConfig, init_tnco_mcpg_state,
                                                      make_tnco_mcpg_step, solve_tnco_local_search, solve_tnco_mcpg)
    from rlsolver_tpu_torch.envs.tnco import TensorNetwork, TncoEnv, random_circuit_nodes
    from rlsolver_tpu_torch.ops.kernels import build, codec, mh_sampler as mh

    net = TensorNetwork.from_nodes_list(*random_circuit_nodes(53, 12, seed=0), name="circuit_n53_m12_shape")
    env = TncoEnv(net, dev)
    cfg = TncoMcpgConfig()
    b, n = cfg.num_chains * cfg.repeat_times, net.num_bits
    print(f"  {net.name}: {net.num_nodes} tensors, {net.num_edges} bonds, {n} bits ({net.num_bases} a bond); MCPG "
          f"{cfg.num_chains} x {cfg.repeat_times} chains, {cfg.mh_rounds} MH rounds, {cfg.ls_iters} local-search "
          f"iterations, lr {cfg.lr}, {TNCO_ROUNDS} of {cfg.num_rounds} rounds", flush=True)
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(53)

    # K3 at TNCO's shape, bit for bit, and its time there
    probs = torch.rand(n, generator=gen, device=dev) * 0.6 + 0.2
    bits = env.random_xs(gen, b)
    thr, words = mh.fused_thresholds(probs), codec.pack_bits(bits)
    w = codec.num_words(n)
    plain = codec.unpack_bits(mh.mh_fused_plain(4242, thr, words, n, cfg.mh_rounds), n)
    k3_kernel = mh.fused_kernel(b, w, dev)
    require_equal(f"K3 {k3_kernel.name} at TNCO's shape ({b} chains x {n} bits x {cfg.mh_rounds} rounds)",
                  mh.mh_sample_fused(4242, probs, bits, cfg.mh_rounds), plain, errs, k3_kernel.name)
    with form_seconds("tnco"):
        k3 = dict(tnco_shape=[b, n, cfg.mh_rounds], tnco_form=k3_kernel.name,
                  tnco_ms=graph_ms(lambda: mh.launch_fused(k3_kernel, thr, words, n, cfg.mh_rounds, 4242)),
                  tnco_chain_form_ms=graph_ms(lambda: mh.launch_fused(mh.MH_FUSED, thr, words, n, cfg.mh_rounds,
                                                                      4242)))
        k3.update({f"tnco_{key}": v for key, v in k3_serial(thr, n, cfg.mh_rounds).items()})
    k3["tnco_plain_ms"] = cuda_ms(lambda: mh.mh_fused_plain(4242, thr, words, n, cfg.mh_rounds), 1, warmup=False)
    k3["tnco_bound_ms"], k3["tnco_bound_by"] = bound(2 * b * w * 4 + thr.numel() * 4, cfg.mh_rounds * b * K3_OPS, 0)
    print(f"  K3 at TNCO's shape: {k3_kernel.name} {k3['tnco_ms']:.4f} ms, the chain form "
          f"{k3['tnco_chain_form_ms']:.4f} ms (bound {k3['tnco_bound_ms']:.5f} ms, {k3['tnco_bound_by']}; serial "
          f"floor {k3['tnco_serial_floor_ms']:.5f} ms, a round {k3['tnco_serial_round_us']} us; plain "
          f"{k3['tnco_plain_ms']:.1f} ms)", flush=True)

    # the best of 128 random orders; one evaluation's CUDA graph (captured at
    # its first call) against the eager step loop, bit for bit, and the
    # seconds of each
    sorts = env.random_edge_sorts(gen, b)
    t0 = time.time()
    pows = env.contraction_pow_counts(sorts)
    torch.cuda.synchronize()
    capture_s = time.time() - t0
    eager = env._pow_counts_steps(sorts)
    if not torch.equal(pows, eager):
        raise AssertionError("TNCO: the CUDA graph's contraction counts differ from the eager step loop's")

    def seconds(fn):
        out = []
        for _ in range(3):
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            out.append(time.time() - t0)
        return out

    eval_s, eager_s = seconds(lambda: env.log10_multiple_times(sorts)), seconds(lambda: env._pow_counts_steps(sorts))
    random_best = float(env.log10_multiple_times(env.random_edge_sorts(gen, TNCO_RANDOM)).min())
    print(f"  contraction counts of {b} orders ({net.run_edges} steps): the CUDA graph equals the eager loop bit "
          f"for bit; first call (capture) {capture_s:.3f} s; seconds per evaluation {eval_s}, eager "
          f"{eager_s}; best of {TNCO_RANDOM} random orders {random_best:.4f}", flush=True)

    counts = {}
    for sampler in ("fused", "scan"):
        run_cfg = dataclasses.replace(cfg, num_rounds=TNCO_ROUNDS, sampler=sampler)
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        times = []
        order, cost, hist = solve_tnco_mcpg(env, run_cfg, timings=times)
        torch.cuda.synchronize()
        counts[sampler] = {k.name: k.launches for k in build.KERNELS}
        if sampler == "scan":  # the unsharded counterpart of the parallel phase's world of one
            UNSHARDED["tnco"] = dict(order=order, cost=cost, best=hist, secs=times)
        print(f"  MCPG sampler={sampler}: seconds per round {times}; max_memory_allocated "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above the phase's start", flush=True)
        check_order(f"MCPG sampler={sampler}", env, order, cost, hist, worse_than=random_best)
    require_launches("TNCO MCPG sampler=fused", counts["fused"], (k3_kernel.name,), [k for k in counts["fused"]])
    require_launches("TNCO MCPG sampler=scan", counts["scan"], (), [k for k in counts["scan"]])

    # where one fused round's time goes
    state = init_tnco_mcpg_state(env, dataclasses.replace(cfg, sampler="fused"))
    step = make_tnco_mcpg_step(env, dataclasses.replace(cfg, sampler="fused"))
    state, _ = step(state)
    torch.cuda.synchronize()
    profile_device(f"one TNCO MCPG round (fused, {b} chains, {cfg.ls_iters + 1} evaluations)", lambda: step(state))

    ls_cfg = dataclasses.replace(TncoSearchConfig(), num_rounds=TNCO_LS_ROUNDS)
    t0 = time.time()
    build.reset_counts()
    order, cost, hist = solve_tnco_local_search(env, ls_cfg)
    ls_counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  local search: {ls_cfg.num_chains} chains, {ls_cfg.ls_iters} iterations a round, {TNCO_LS_ROUNDS} of "
          f"{TncoSearchConfig().num_rounds} rounds in {time.time() - t0:.2f} s", flush=True)
    check_order("local search", env, order, cost, hist, worse_than=random_best)
    require_launches("TNCO local search", ls_counts, (), [k for k in ls_counts])

    # quality against the JAX package's CPU runs, same network, sampler, seeds
    small = TncoEnv(TensorNetwork.from_nodes_list(*random_circuit_nodes(12, 14, seed=0)), dev)
    costs = []
    t0 = time.time()
    for s in range(len(JAX_TNCO_SMALL)):
        order, cost, hist = solve_tnco_mcpg(small, TncoMcpgConfig(sampler="scan", seed=s))
        check_order(f"random_circuit_nodes(12, 14) MCPG scan seed {s}", small, order, cost, hist)
        costs.append(cost)
    print(f"  random_circuit_nodes(12, 14): {small.num_nodes} tensors, {small.num_edges} bonds, "
          f"{TncoMcpgConfig().num_rounds} rounds x {len(costs)} seeds in {time.time() - t0:.2f} s", flush=True)
    within_spread("TNCO MCPG (scan) at random_circuit_nodes(12, 14), log10 cost", costs, JAX_TNCO_SMALL)
    phase_memory("tnco", base)
    return {k: counts["fused"][k] + counts["scan"][k] + ls_counts[k] for k in counts["fused"]}, k3


def run_ppo(dev) -> dict:
    """Flip-MDP PPO on G22-like at PPOConfig's widths (128 envs, horizon 64,
    4 minibatches, 4 epochs; the step size annealed over the full 100
    iterations), PPO_ITERS iterations; A2C (one full-batch update a
    rollout) for A2C_ITERS; a warm start from greedy's cut as a start_str;
    then S2V rollouts with an untrained `S2VConstructivePolicy` on
    BA_100_ID0..9 (each cut its host re-score) and a PER round at DQN's
    replay capacity. Losses must be finite, and how far the PPO run moved
    its policy (`policy_movement`) within the JAX package's seeds' range
    widened by PPO_MOVE_MARGIN, where the same run at lr = 0 must fall
    outside. PER samples after unequal priorities are written: the weights
    equal the host's, the frequencies follow the priorities. Returns the
    phase's launches."""
    from rlsolver_tpu_torch.algos.dqn import DQNConfig
    from rlsolver_tpu_torch.algos.ppo import PPOConfig, a2c_config, init_ppo_state, make_ppo_iteration
    from rlsolver_tpu_torch.classical.greedy import greedy_maxcut
    from rlsolver_tpu_torch.core.encode import SolutionCodec
    from rlsolver_tpu_torch.core.generate import build_g22_like, graph_from_name
    from rlsolver_tpu_torch.envs.flip_mdp import FlipMdpEnv
    from rlsolver_tpu_torch.models.s2v_policy import S2VConstructivePolicy, rollout_s2v_maxcut
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut
    from rlsolver_tpu_torch.train.replay import PrioritizedReplay, per_add, per_sample, per_update

    g = build_g22_like()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()

    def train(label, cfg, iters, profile=False):
        env = FlipMdpEnv(g, horizon=cfg.horizon, device=dev)
        iteration = make_ppo_iteration(env, cfg)
        state = init_ppo_state(env, cfg, cfg.num_envs)
        start_cut = float(state.env_state.cut.mean())
        obs0, model0 = state.obs.clone(), copy.deepcopy(state.model)
        hist, times = [], []
        for _ in range(iters):
            t0 = time.time()
            state, m = iteration(state)
            hist.append({k: float(v) for k, v in m.items()})
            times.append(time.time() - t0)
        print(f"  {label}: {cfg.num_envs} envs x {cfg.horizon} steps, {cfg.num_minibatches} minibatches x "
              f"{cfg.update_epochs} epochs, {iters} of {cfg.num_iterations} iterations; seconds per iteration "
              f"{[round(t, 4) for t in times]}; start mean cut {start_cut:.2f}; mean cut by iteration "
              f"{[round(h['mean_cut'], 2) for h in hist]}; best {[h['best_cut'] for h in hist]}; loss "
              f"{[round(h['loss'], 5) for h in hist]}", flush=True)
        if not all(np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"{label}: a loss is not finite")
        move = policy_movement(model0, state.model, obs0)
        if profile:  # the PPO run: the unsharded counterpart of the parallel phase's world of one
            UNSHARDED["ppo"] = dict(history=hist, secs=times, state=_par_flat(state.optimizer.state_tensors()))
            profile_device(f"one {label} iteration", lambda: iteration(state))
        return move, hist

    def move_within(label, move):
        """Whether (KL, entropy drop) both lie in JAX's seeds' ranges widened
        by PPO_MOVE_MARGIN."""
        ok = True
        for name, value, ref in (("KL(pi_40 || pi_0)", move[0], JAX_PPO_KL),
                                 ("entropy drop", move[1], JAX_PPO_ENTROPY_DROP)):
            lo, hi = min(ref) - PPO_MOVE_MARGIN, max(ref) + PPO_MOVE_MARGIN
            ok = ok and lo <= value <= hi
            print(f"  {label}: {name} on the start observations {value:.6f}; JAX {list(ref)}; allowed "
                  f"[{lo:.4f}, {hi:.4f}]", flush=True)
        return ok

    # the policy is the thing PPO changes at this depth (neither package's
    # PPO raises the cut here within 100 iterations): how far it moved must
    # match JAX's, and the same run at lr = 0 (no update) must fail that
    cfg = PPOConfig()
    move, hist = train("PPO on G22like", cfg, PPO_ITERS, profile=True)
    print(f"  PPO mean reward a step over the run {float(np.mean([h['mean_reward'] for h in hist])):.6f}, mean "
          f"cut {float(np.mean([h['mean_cut'] for h in hist])):.2f}", flush=True)
    if not move_within("PPO", move):
        raise AssertionError("PPO: the policy did not move as JAX's does in as many iterations")
    move0, _ = train("PPO at lr = 0 (control)", dataclasses.replace(cfg, lr=0.0), PPO_ITERS)
    if move_within("PPO at lr = 0 (control)", move0):
        raise AssertionError("PPO: the lr = 0 control passes the policy-movement check, which cannot tell learning")
    train("A2C on G22like", a2c_config(cfg), A2C_ITERS)
    bits, cut = greedy_maxcut(g, device=dev)
    warm = dataclasses.replace(cfg, start_str=SolutionCodec(g.num_nodes).bits_to_str(np.asarray(bits).astype(bool)))
    env = FlipMdpEnv(g, horizon=cfg.horizon, device=dev)
    st = init_ppo_state(env, warm, cfg.num_envs)
    host = obj_maxcut(np.asarray(bits).astype(np.int64), g)
    if not (bool((st.env_state.xs == st.env_state.xs[:1]).all()) and float(st.env_state.cut.min()) == host == cut):
        raise AssertionError(f"PPO warm start: envs do not all start at the greedy cut {host}")
    st, m = make_ppo_iteration(env, warm)(st)
    print(f"  warm start from greedy's cut {host}: every env at it; after one iteration mean cut "
          f"{float(m['mean_cut']):.2f}, loss {float(m['loss']):.5f}", flush=True)

    # S2V rollouts, untrained, on BA_100_ID0..9 at once
    graphs = [graph_from_name(f"BA_100_ID{i}") for i in range(10)]
    adj = torch.from_numpy(np.stack([gr.adjacency_dense() for gr in graphs])).to(dev)
    model = S2VConstructivePolicy().to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for greedy in (True, False):
        t0 = time.time()
        with torch.no_grad():
            xs, logp, cuts = rollout_s2v_maxcut(model, adj, gen, greedy=greedy)
        cuts = cuts.tolist()
        host = [obj_maxcut(x.astype(np.int64), gr) for x, gr in zip(xs.cpu().numpy(), graphs)]
        print(f"  S2V rollout ({'greedy' if greedy else 'sampled'}, untrained) on BA_100_ID0..9 in "
              f"{time.time() - t0:.2f} s: cuts {cuts}", flush=True)
        if cuts != host:
            raise AssertionError(f"S2V rollout: cuts {cuts} != host re-scores {host}")
        if not (bool(torch.isfinite(logp).all()) and bool((xs.sum(dim=1) == 50).all())):
            raise AssertionError("S2V rollout: each solution must move 50 nodes with a finite log-probability")

    # PER at DQN's replay capacity and batch; the items' priorities set to
    # (|td| + 1e-6)^alpha with |td| in PER_TD by slot, so that the sample's
    # frequencies and weights are tested
    dq = DQNConfig()
    t0 = time.time()
    example = (torch.zeros(100, 7, device=dev), torch.zeros((), dtype=torch.int64, device=dev),
               torch.zeros((), device=dev))
    buf = PrioritizedReplay.create(example, dq.buffer_capacity)
    for i in range(dq.buffer_capacity):
        buf = per_add(buf, (torch.full((100, 7), float(i % 97), device=dev), torch.tensor(i % 100, device=dev),
                            torch.tensor(float(i), device=dev)))
    add_s = time.time() - t0
    slots = torch.arange(dq.buffer_capacity, device=dev)
    buf = per_update(buf, slots, torch.tensor(PER_TD, device=dev)[slots % len(PER_TD)])
    prio = buf.priorities.double()
    _, fidx, fw = per_sample(buf, gen, PER_DRAWS)
    host_w = (dq.buffer_capacity * prio[fidx] / prio.sum()) ** -0.4
    host_w = host_w / host_w.max()
    freq = torch.bincount(fidx % len(PER_TD), minlength=len(PER_TD)).double() / PER_DRAWS
    share = torch.stack([prio[k::len(PER_TD)].sum() for k in range(len(PER_TD))]) / prio.sum()
    sigma = torch.sqrt(share * (1 - share) / PER_DRAWS)
    print(f"  PER: {PER_DRAWS} draws after priorities from |td| {list(PER_TD)}: frequencies "
          f"{[round(float(f), 4) for f in freq]}, expected {[round(float(x), 4) for x in share]}; weights "
          f"{float(fw.min()):.4f}..{float(fw.max()):.4f}, max off the host's "
          f"{float((fw.double() - host_w).abs().max()):.2e}", flush=True)
    if not (bool(((freq - share).abs() <= 5 * sigma).all()) and float((fw.double() - host_w).abs().max()) <= 1e-5
            and float(fw.min()) < 0.5):
        raise AssertionError("PER: the sample's frequencies or weights do not follow the priorities")
    t0 = time.time()
    batch, idx, wts = per_sample(buf, gen, dq.batch_size)
    td = torch.randn(dq.batch_size, generator=gen, device=dev)
    buf = per_update(buf, idx, td)
    torch.cuda.synchronize()
    print(f"  PER: {dq.buffer_capacity} adds in {add_s:.2f} s, one sample of {dq.batch_size} and its update in "
          f"{time.time() - t0:.4f} s; weights {float(wts.min()):.4f}..{float(wts.max()):.4f}", flush=True)
    expect = (torch.abs(td) + 1e-6) ** buf.alpha
    last = {int(i): k for k, i in enumerate(idx.tolist())}
    if not (float(wts.max()) == 1.0 and float(wts.min()) > 0 and bool((batch[2] == idx.float()).all())
            and all(float(buf.priorities[i]) == float(expect[k]) for i, k in last.items())):
        raise AssertionError("PER: the sample's items, weights or the updated priorities are wrong")
    counts = {k.name: k.launches for k in build.KERNELS}
    require_launches("ppo phase", counts, (), list(counts))
    phase_memory("ppo", base)
    return counts


def run_beamforming(dev) -> dict:
    """`train_beamforming` at its defaults (4 users x 4 antennas, batch 256,
    episode 6, 300 steps: full depth) for seeds 0-2; the final rate (the
    mean of the last 10) within JAX's seeds' range widened by SPREAD_MARGIN;
    on a held-out batch the trained policy's mean rate at least MMSE's less
    0.3 (`tests/test_beamforming.py:118-129`); ZF nulls interference, MMSE
    beats ZF at low SNR, the relay's rates are finite and positive.
    Returns the phase's launches."""
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.problems import beamforming as bf

    spec, cfg = bf.BeamformingSpec(), bf.BeamformingTrainConfig()
    build.reset_counts()
    finals, policy = [], None
    for s in range(len(JAX_BEAMFORMING)):
        times = []
        pol, hist = bf.train_beamforming(spec, dataclasses.replace(cfg, seed=s), device=dev, timings=times)
        finals.append(float(np.mean(hist[-10:])))
        if policy is None:
            policy = pol
        print(f"  beamforming seed {s}: {cfg.num_steps} steps of batch {cfg.batch} x episode {cfg.episode_length}, "
              f"{float(np.median(times)):.5f} s a step (median; first {times[0]:.3f} s); rate {hist[0]:.4f} -> "
              f"{finals[-1]:.4f}", flush=True)
        if not np.isfinite(hist).all():
            raise AssertionError("beamforming: a rate is not finite")
    within_spread("beamforming final rate (mean of the last 10 steps)", finals, JAX_BEAMFORMING)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    h = bf.random_channels(gen, spec, 128, device=dev)
    with torch.no_grad():
        w = bf.mmse_beamformer(h, spec)
        r_mmse = float(bf.sum_rate(h, w, spec.noise_power).mean())
        for _ in range(cfg.episode_length):
            w = policy(h, w)
        r_policy = float(bf.sum_rate(h, w, spec.noise_power).mean())
        hw = torch.einsum("bkn,bnj->bkj", h, bf.zf_beamformer(h, spec))
        off = float((hw - torch.diag_embed(torch.diagonal(hw, dim1=1, dim2=2))).abs().max())
        low = bf.BeamformingSpec(total_power=1.0)
        r_zf_low = float(bf.sum_rate(h, bf.zf_beamformer(h, low), low.noise_power).mean())
        r_mmse_low = float(bf.sum_rate(h, bf.mmse_beamformer(h, low), low.noise_power).mean())
        rspec = bf.RelaySpec()
        g_r, h_r = bf.random_relay_channels(gen, rspec, 128, device=dev)
        rates = bf.relay_sum_rate(h_r, bf.identity_relay(rspec, 128, device=dev), g_r, rspec)
    print(f"  held-out 128 channels: policy {r_policy:.4f}, MMSE {r_mmse:.4f}; ZF's largest interference term "
          f"{off:.2e}; at P = 1 MMSE {r_mmse_low:.4f}, ZF {r_zf_low:.4f}; relay (identity) mean rate "
          f"{float(rates.mean()):.4f}", flush=True)
    if not r_policy >= r_mmse - 0.3:
        raise AssertionError(f"beamforming: the policy's {r_policy:.4f} is below MMSE's {r_mmse:.4f} less 0.3")
    if not (off < 5e-2 and r_mmse_low >= r_zf_low - 1e-3):
        raise AssertionError("beamforming: ZF does not null interference or MMSE is below ZF at low SNR")
    if not (bool(torch.isfinite(rates).all()) and bool((rates > 0).all())):
        raise AssertionError("beamforming: a relay rate is not finite and positive")
    counts = {k.name: k.launches for k in build.KERNELS}
    require_launches("beamforming phase", counts, (), list(counts))
    return counts


# The JAX package's CPU runs (scripts/jax_tsp_l2o_reference.py, seeds 0-2)
# that the tsp and l2o phases hold the port to
JAX_POMO = (3.8644871711730957, 3.853501796722412, 3.860985517501831)  # x8 greedy mean on the eval set
JAX_POMO_UNTRAINED = (5.545351505279541, 5.428628444671631, 5.644775867462158)
JAX_TSP_ANNEAL = (8.047772506160845, 8.155059123970908, 7.898277617060631)
JAX_TSP_DESCENT = (7.841009942225851, 7.860534821076381, 7.698661947676009)
JAX_TSP_CLI = {"nn_100": 7.872507095336914, "christofides_100": 8.252485275268555,
               "karp_steele_100": 8.58851146697998, "cheapest_insertion_100": 8.662101745605469,
               "nn_1000": 24.665048599243164, "christofides_1000": 23.73930549621582,
               "karp_steele_1000": 25.321481704711914, "cheapest_insertion_1000": 26.16327476501465}
JAX_SEQ2SEQ = (230.0, 232.0, 229.0)  # BA_100_ID0
JAX_L2O = (265.0, 266.0, 263.0)
# RUN-CSP, seeds 0-9: boosted cuts on BA_100_ID0..3 after training on them
# (ten seeds: the seeds' means spread over 273.75-277.0)
JAX_RUNCSP = ((273, 277, 279, 276), (271, 279, 276, 274), (276, 279, 280, 271), (275, 278, 281, 274),
              (275, 277, 275, 268), (270, 277, 277, 272), (275, 275, 279, 272), (271, 279, 278, 270),
              (272, 278, 275, 273), (270, 275, 279, 272))
JAX_DCS = (2.4407103061676025, 2.2469770908355713, 2.3963475227355957)
JAX_DCS_UNTRAINED = (4.615262031555176, 4.2988715171813965, 4.393608093261719)  # before training
TSP_EVAL = (128, 20)  # POMO's eval set: generate_tsp_coords(128, 20, seed=20)
TSP_SEEDS = {100: 100, 1000: 1000}  # the CLI's instances: generate_tsp_coords(1, n, seed)
TSP_CHAINS = 1024
TSP_PROFILE_STEPS = 200
TSP_PORT_SEEDS = (0,)  # POMO's and the annealer's runs on the card, each held to JAX's seeds 0-2
POMO_CONTROL_STEPS = 20  # the lr = 0 control's steps (its parameters do not move)
REINFORCE_STEPS = {"tsp": 40, "s2v": 30}  # of ReinforceConfig's 100: two t-test epochs, for room
RUNCSP_TRAIN = 4  # RUN-CSP trains on BA_100_ID0..3 and is boosted on each
RUNCSP_PORT_SEEDS = range(6)  # of JAX_RUNCSP's seeds 0-9, cut to 0-5 for room (scripts/runcsp_gap.py's 10-19 on the CPU)


def spread_margin(jax_values) -> float:
    """The JAX seeds' own spread (max - min): a mean within their range
    widened by it on both sides is a draw of the same distribution."""
    return float(max(jax_values) - min(jax_values))


def check_tours(label: str, tours, lengths, dist, rel: float = 1e-4) -> np.ndarray:
    """Every tour [B, N] a permutation; each length its float64 host re-score
    within `rel` relative (f32 sums on the card). Returns the re-scores."""
    from rlsolver_tpu_torch.problems.objectives import obj_tsp
    tours = np.asarray(tours.cpu() if torch.is_tensor(tours) else tours)
    lengths = np.asarray(lengths.detach().cpu() if torch.is_tensor(lengths) else lengths, np.float64).reshape(-1)
    n = tours.shape[-1]
    if not (np.sort(tours, axis=-1) == np.arange(n)).all():
        raise AssertionError(f"{label}: a tour is not a permutation of the {n} cities")
    dists = dist if isinstance(dist, list) else [dist] * len(tours)
    host = np.array([-obj_tsp(t, d) for t, d in zip(tours, dists)])
    err = float(np.max(np.abs(host - lengths) / host))
    if not err <= rel:
        raise AssertionError(f"{label}: lengths differ from their float64 re-scores by {err:.2e} (> {rel})")
    return host


def run_tsp(dev) -> dict:
    """The TSP axis: POMO at POMOConfig's widths (embed 128, 4 heads, 3
    layers, batch 64, TSP20, 200 steps) for TSP_PORT_SEEDS, x8 greedy
    inference on generate_tsp_coords(128, 20, seed=20) within JAX's seeds
    0-2's range widened by their spread, an lr = 0 control (its parameters
    equal to the start's) outside it; a sampled rollout and x8 inference at TSP100 (P = 100,
    batch 64) and a width-4 beam search, timed; TSPEnv.anneal at its
    defaults (5000 steps) on 1024 random tours of the TSP100 instance, then
    two_opt_descent, against JAX's seeds 0-2; 3-opt, or-opt, tabu search and
    the GA there, each no longer than its start; the CLI's four --problem
    tsp algorithms on the TSP100 and TSP1000 files, each equal to JAX's CPU
    length within 1e-4; train_reinforce with the rollout baseline (at least
    one t-test swap) and with the S2V maxcut adapter on BA_100 (steps cut as
    REINFORCE_STEPS). No kernel is on this path. Returns the launches."""
    import contextlib
    import io
    from rlsolver_tpu_torch.algos import am_pomo as ap
    from rlsolver_tpu_torch.algos import reinforce_baselines as rb
    from rlsolver_tpu_torch.classical import tsp as ct
    from rlsolver_tpu_torch.core.generate import generate_tsp_coords
    from rlsolver_tpu_torch.core.io import tsp_distance_matrix
    from rlsolver_tpu_torch.envs.tsp import GRAPH_CHUNK, TSPDraws, TSPEnv
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.ops.sampling import gumbel_noise
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut, obj_tsp
    from rlsolver_tpu_torch.run import main as cli_main

    build.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = ap.POMOConfig()
    nodes = ap.eval_nodes(*TSP_EVAL, seed=TSP_EVAL[1], device=dev)
    d20 = [tsp_distance_matrix(c) for c in generate_tsp_coords(*TSP_EVAL, seed=TSP_EVAL[1])]

    def pomo_eval(model, label):
        tours, lengths = ap.infer_pomo(model, nodes)
        return float(check_tours(label, tours, lengths, d20).mean())

    finals, model0 = [], None
    for s in TSP_PORT_SEEDS:
        times = []
        model, hist = ap.train_pomo(dataclasses.replace(cfg, seed=s), device=dev, timings=times)
        if not np.isfinite([h["loss"] for h in hist]).all():
            raise AssertionError("POMO: a loss is not finite")
        finals.append(pomo_eval(model, f"POMO seed {s}"))
        model0 = model if model0 is None else model0
        print(f"  POMO seed {s}: {cfg.num_steps} steps of batch {cfg.batch_size} x {cfg.num_cities} starts, "
              f"{float(np.median(times)):.4f} s a step (median; first {times[0]:.3f} s); mean length "
              f"{hist[0]['mean_length']:.4f} -> {hist[-1]['mean_length']:.4f}; x8 greedy {finals[-1]:.4f}", flush=True)
    within_spread("POMO x8 greedy mean length (TSP20 eval set)", finals, JAX_POMO, spread_margin(JAX_POMO))
    # an lr = 0 run leaves the parameters where they start (Adam's step is -0
    # times the update), whatever its length: POMO_CONTROL_STEPS steps, the
    # parameters checked equal to the start's bit for bit
    control, _ = ap.train_pomo(dataclasses.replace(cfg, lr=0.0, num_steps=POMO_CONTROL_STEPS), device=dev)
    start = ap.AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers, seed=cfg.seed, device=dev).state_dict()
    if not all(torch.equal(v, start[k]) for k, v in control.state_dict().items()):
        raise AssertionError("POMO: an lr = 0 run moved the parameters")
    ctrl = pomo_eval(control, "POMO lr = 0")
    lo, hi = min(JAX_POMO) - spread_margin(JAX_POMO), max(JAX_POMO) + spread_margin(JAX_POMO)
    print(f"  POMO lr = 0 control: {ctrl:.4f} (JAX at its seeds' initial parameters {JAX_POMO_UNTRAINED})", flush=True)
    if lo <= ctrl <= hi:
        raise AssertionError(f"POMO: the lr = 0 control {ctrl:.4f} lies inside [{lo:.4f}, {hi:.4f}]")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    draws = [ap.POMODraws(torch.rand(cfg.batch_size, cfg.num_cities, 2, generator=gen, device=dev),
                          gumbel_noise((cfg.num_cities - 1, cfg.batch_size, cfg.num_cities, cfg.num_cities), gen, dev))
             for _ in range(3)]
    models, steps = [], []
    for graphed in (True, False):  # three steps as CUDA graph replays and eagerly, from one start
        models.append(ap.AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers, seed=cfg.seed, device=dev))
        steps.append(ap.make_pomo_step(models[-1], cfg, cuda_graph=graphed)[1])
        for d in draws:
            steps[-1](draws=d)
    if not all(torch.equal(v, models[1].state_dict()[k]) for k, v in models[0].state_dict().items()):
        raise AssertionError("POMO: the CUDA graph's training steps differ from the eager ones")
    print("  POMO: 3 training steps as CUDA graph replays equal the eager steps bit for bit", flush=True)
    for label, st in (("one POMO training step (TSP20, batch 64), a CUDA graph replay", steps[0]),
                      ("one POMO training step, eager", steps[1])):
        profile_device(label, lambda: st(gen))
    with torch.no_grad():
        tours, lengths = ap.beam_search(model0, nodes, beam_width=4)
    beam = check_tours("beam search", tours, lengths, d20)
    nodes100 = ap.eval_nodes(64, 100, seed=100, device=dev)
    d100s = [tsp_distance_matrix(c) for c in generate_tsp_coords(64, 100, seed=100)]
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        acts, _, lens = ap.rollout_pomo(model0, nodes100, gen=gen)
    torch.cuda.synchronize()
    t_roll = time.time() - t0
    check_tours("TSP100 sampled rollout", acts.reshape(-1, 100), lens, [d for d in d100s for _ in range(100)])
    t0 = time.time()
    tours, lengths = ap.infer_pomo(model0, nodes100)
    t_x8 = time.time() - t0
    x8 = check_tours("TSP100 x8 inference", tours, lengths, d100s)
    print(f"  beam search (width 4, TSP20 eval set): mean {beam.mean():.4f}; TSP100 (batch 64, P = 100): a sampled "
          f"rollout {t_roll:.3f} s (mean {float(lens.mean()):.4f}), x8 greedy inference {t_x8:.3f} s (mean "
          f"{x8.mean():.4f})", flush=True)

    dist = tsp_distance_matrix(generate_tsp_coords(1, 100, seed=TSP_SEEDS[100])[0])
    env = TSPEnv(dist, device=dev)
    best_a, best_d = [], []
    for s in TSP_PORT_SEEDS:
        g = torch.Generator(device=dev)
        g.manual_seed(s)
        tours = env.random_tours(g, TSP_CHAINS)
        torch.cuda.synchronize()
        t0 = time.time()
        bt, bl = env.anneal(tours, gen=g)
        b = int(bl.argmin())
        # the chains' lengths add up 5000 f32 deltas: re-scored within 1e-3
        best_a.append(float(check_tours(f"anneal seed {s}", bt[b:b + 1], bl[b:b + 1], dist, 1e-3)[0]))
        t_a = time.time() - t0
        t0 = time.time()
        dt, dl = env.two_opt_descent(bt, gen=g)
        b = int(dl.argmin())
        best_d.append(float(check_tours(f"descent seed {s}", dt[b:b + 1], dl[b:b + 1], dist, 1e-3)[0]))
        print(f"  TSPEnv seed {s}: anneal of {TSP_CHAINS} chains x 5000 steps {t_a:.2f} s ({1e3 * t_a / 5000:.3f} ms "
              f"a step), best {best_a[-1]:.6f}; two_opt_descent {time.time() - t0:.2f} s, best {best_d[-1]:.6f}",
              flush=True)
    within_spread("TSPEnv.anneal best length (TSP100)", best_a, JAX_TSP_ANNEAL, spread_margin(JAX_TSP_ANNEAL))
    within_spread("two_opt_descent best length (TSP100)", best_d, JAX_TSP_DESCENT, spread_margin(JAX_TSP_DESCENT))
    window = env.draw(gen, TSP_PROFILE_STEPS, TSP_CHAINS, accept=True)
    descent_window = TSPDraws(*window[:4])
    for label, run in (("anneal", lambda graphed: env.anneal(tours, TSP_PROFILE_STEPS, draws=window,
                                                             cuda_graph=graphed)),
                       ("descent", lambda graphed: env.two_opt_descent(tours, TSP_PROFILE_STEPS, draws=descent_window,
                                                                       cuda_graph=graphed))):
        graphed, eager = run(True), run(False)
        if not all(torch.equal(a, b) for a, b in zip(graphed, eager)):
            raise AssertionError(f"TSPEnv {label}: the CUDA graph replay differs from the eager loop")
    print(f"  TSPEnv: {TSP_PROFILE_STEPS} anneal and descent steps as CUDA graphs of {GRAPH_CHUNK} steps equal the "
          f"eager loops bit for bit", flush=True)
    profile_device(f"a {TSP_PROFILE_STEPS}-step anneal window ({TSP_CHAINS} chains), eager",
                   lambda: env.anneal(tours, TSP_PROFILE_STEPS, draws=window, cuda_graph=False))

    starts = env.random_tours(gen, 64)
    start_l = check_tours("random starts", starts, env.tour_length(starts), dist)
    torch.cuda.synchronize()
    nn_tour = ct.nearest_neighbor_tour(dist)
    t0 = time.time()
    t3, l3 = ct.three_opt_tour(dist, nn_tour)
    t_3 = time.time() - t0
    check_tours("3-opt", t3[None], [l3], dist)
    t0 = time.time()
    to, lo_ = ct.or_opt_moves(starts, env.dist, gen=gen)
    torch.cuda.synchronize()
    t_or = time.time() - t0
    ho = check_tours("or-opt", to, lo_, dist)
    t0 = time.time()
    tt, lt = ct.tabu_search(starts, env.dist)
    torch.cuda.synchronize()
    t_tabu = time.time() - t0
    ht = check_tours("tabu search", tt, lt, dist)
    t0 = time.time()
    tg, lg = ct.genetic_tsp(dist, seed=0, device=dev)
    t_ga = time.time() - t0
    check_tours("GA", tg[None], [lg], dist)
    rng = np.random.RandomState(0)
    ga_start = min(-obj_tsp(rng.permutation(100), dist) for _ in range(64))  # the GA's first population
    nn_len = -obj_tsp(nn_tour, dist)
    if not (l3 <= nn_len + 1e-9 and (ho <= start_l + 1e-6).all() and (ht <= start_l + 1e-6).all()
            and lg <= ga_start + 1e-9):
        raise AssertionError("TSP: an improver returned a tour longer than its start")
    print(f"  3-opt from NN {nn_len:.4f} -> {l3:.4f} in {t_3:.2f} s; or-opt (64 tours, 200 moves) mean "
          f"{start_l.mean():.4f} -> {ho.mean():.4f} in {t_or:.2f} s; tabu (64 tours, 100 iterations) -> "
          f"{ht.mean():.4f} in {t_tabu:.2f} s; GA (64 x 100 generations) {ga_start:.4f} -> {lg:.4f} in "
          f"{t_ga:.2f} s", flush=True)

    with tempfile.TemporaryDirectory(dir=REPO) as data_dir:
        for n, seed in TSP_SEEDS.items():
            with open(os.path.join(data_dir, f"rand{n}.tsp"), "w") as f:
                f.writelines(f"{i + 1} {x!r} {y!r}\n" for i, (x, y) in enumerate(
                    generate_tsp_coords(1, n, seed=seed)[0].tolist()))
        for alg in ("nn", "christofides", "karp_steele", "cheapest_insertion"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["--problem", "tsp", "--alg", alg, "--data-dir", data_dir])
            lines = out.getvalue().strip().splitlines()
            print("  " + "\n  ".join(lines), flush=True)
            if rc != 0 or len(lines) != len(TSP_SEEDS):
                raise AssertionError(f"CLI --problem tsp --alg {alg} failed ({rc})")
            for line in lines:
                n = int(line.split("rand")[1].split(".tsp")[0])
                length, ref = float(line.split("length=")[1].split()[0]), JAX_TSP_CLI[f"{alg}_{n}"]
                if not abs(length - ref) <= 1e-4 * ref:
                    raise AssertionError(f"CLI tsp {alg} on TSP{n}: {length} but JAX's CPU run gives {ref}")

    rcfg = rb.ReinforceConfig(num_steps=REINFORCE_STEPS["tsp"])
    bl = rb.get_reinforce_baseline("rollout", eval_nodes=ap.eval_nodes(256, rcfg.num_cities, seed=21, device=dev))
    times = []
    _, hist, state = rb.train_reinforce(bl, rcfg, device=dev, timings=times)
    if not (np.isfinite(hist["mean_length"]).all() and np.isfinite(hist["loss"]).all()) or state.swaps < 1:
        raise AssertionError(f"REINFORCE (rollout baseline): lengths and losses finite "
                             f"{np.isfinite(hist['mean_length'] + hist['loss']).all()}, {state.swaps} t-test swaps (at "
                             f"least 1 needed)")
    print(f"  REINFORCE, rollout baseline (TSP20, {rcfg.num_steps} steps): {float(np.median(times)):.4f} s a step; "
          f"mean length {hist['mean_length'][0]:.4f} -> {hist['mean_length'][-1]:.4f}, loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f}; {state.swaps} t-test swaps, frozen policy's held-out mean reward "
          f"{state.frozen_mean:.4f}", flush=True)
    scfg = rb.ReinforceConfig(embed_dim=64, num_layers=2, num_steps=REINFORCE_STEPS["s2v"])
    adapter = rb.S2VMaxcutAdapter(scfg, num_nodes=100, device=dev)
    times = []
    model, hist, _ = rb.train_reinforce(rb.get_reinforce_baseline("exponential"), scfg, adapter=adapter, timings=times)
    xs, _, cuts = adapter.rollout(model, adapter.pool()[:10], greedy=True)
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    host = [obj_maxcut(x.cpu().numpy().astype(np.int64), generate_graph(GraphType.BA, 100, seed=i))
            for i, x in enumerate(xs)]
    finite = bool(np.isfinite(hist["mean_reward"] + hist["loss"]).all())
    if not finite or host != cuts.tolist():
        raise AssertionError(f"REINFORCE S2V: rewards and losses finite {finite}, cuts {cuts.tolist()} against host "
                             f"re-scores {host}")
    print(f"  REINFORCE, S2V maxcut on BA_100 ({scfg.num_steps} steps, exponential baseline): "
          f"{float(np.median(times)):.4f} s a step; mean cut {hist['mean_reward'][0]:.2f} -> "
          f"{hist['mean_reward'][-1]:.2f}; greedy cuts on the pool's first 10 {host}", flush=True)
    phase_memory("tsp", base)
    counts = {k.name: k.launches for k in build.KERNELS}
    require_launches("tsp phase", counts, (), list(counts))
    return counts


def run_l2o(dev) -> dict:
    """seq2seq and L2O through the CLI in this process (`--alg seq2seq|l2o`
    on BA_100_ID0, their default configs, seeds 0-2; each cut re-scored by
    the CLI), their means at least JAX's less 1%; RUN-CSP's maxcut language
    trained on BA_100_ID0..3 and boosted (8 starts) on each (seeds 0-5),
    every cut its host re-score, the mean over seeds and instances at least
    that of JAX's same seeds less 1%; DCS at its defaults, seeds 0-2, the
    mean recovery error within JAX's range widened by its spread, and the
    untrained errors (the port's and JAX's) above that band. No kernel is on
    this path. Returns the launches."""
    import contextlib
    import io
    from rlsolver_tpu_torch.algos import dcs, l2o, runcsp
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut
    from rlsolver_tpu_torch.run import main as cli_main

    build.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for alg, ref in (("seq2seq", JAX_SEQ2SEQ), ("l2o", JAX_L2O)):
        cuts, secs = [], []
        for s in range(len(ref)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["--alg", alg, "--graphs", "BA_100_ID0", "--seed", str(s)])
            line = out.getvalue().strip()
            if rc != 0 or line.count("obj=") != 1:
                raise AssertionError(f"CLI --alg {alg} --seed {s} failed ({rc}): {line}")
            cuts.append(float(line.split("obj=")[1].split()[0]))
            secs.append(float(line.split("time=")[1].split("s")[0]))
        print(f"  --alg {alg} on BA_100_ID0, seeds 0-2: cuts {cuts} in {secs} s; JAX {list(ref)}", flush=True)
        if not np.mean(cuts) >= 0.99 * np.mean(ref):
            raise AssertionError(f"{alg}: mean cut {np.mean(cuts):.2f} below JAX's {np.mean(ref):.2f} less 1%")
    g100 = graph_from_name("BA_100_ID0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    starts = l2o.L2ODraws(torch.rand(3, 64, 100, generator=gen, device=dev))
    runs = []
    for graphed in (True, False):  # 3 L2O epochs as CUDA graph replays and eagerly, from one start
        model = l2o.SolverLSTM(100, 256, seed=0, device=dev)
        runs.append((l2o.solve_maxcut_l2o(g100, l2o.L2OConfig(num_epochs=3), device=dev, model=model, draws=starts,
                                          cuda_graph=graphed)[2], model.state_dict()))
    if runs[0][0] != runs[1][0] or not all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items()):
        raise AssertionError("L2O: the CUDA graph's epochs differ from the eager ones")
    lang = runcsp.ConstraintLanguage.maxcut()
    graphs = [graph_from_name(f"BA_100_ID{i}") for i in range(RUNCSP_TRAIN)]
    insts = [runcsp.CSPInstance.from_graph(g, lang, "NEQ") for g in graphs]
    solver = runcsp.RunCspSolver(lang, dataclasses.replace(runcsp.RunCspConfig(), epochs=1), device=dev)
    h0s = [solver.initial_state(100, gen) for _ in insts]
    runs = [solver.train(insts, h0s=h0s, cuda_graph=graphed) for graphed in (True, False)]
    if runs[0][1] != runs[1][1] or not all(torch.equal(v, runs[1][0][k]) for k, v in runs[0][0].items()):
        raise AssertionError("RUN-CSP: the CUDA graph's steps differ from the eager ones")
    print("  L2O (3 epochs) and RUN-CSP (4 steps) as CUDA graph replays equal the eager runs bit for bit", flush=True)
    cuts = []
    for s in RUNCSP_PORT_SEEDS:
        t0 = time.time()
        solver = runcsp.RunCspSolver(lang, runcsp.RunCspConfig(seed=s), device=dev)
        params, hist = solver.train(insts)
        t_train = time.time() - t0
        t0 = time.time()
        seed_cuts = []
        for inst, g in zip(insts, graphs):
            assignment, conflicts = solver.boosted_predict(params, inst)
            seed_cuts.append(inst.num_clauses - conflicts)
            if obj_maxcut(assignment.astype(np.int64), g) != seed_cuts[-1] or not np.isfinite(hist).all():
                raise AssertionError(f"RUN-CSP seed {s}: cut {seed_cuts[-1]} is not its host re-score, or a loss is "
                                     f"not finite")
        cuts.append(seed_cuts)
        print(f"  RUN-CSP seed {s}: {solver.cfg.epochs} epochs x {RUNCSP_TRAIN} instances in {t_train:.2f} s; loss "
              f"{hist[0]:.3f} -> {hist[-1]:.3f}; boosted cuts on BA_100_ID0..{RUNCSP_TRAIN - 1} {seed_cuts} in "
              f"{time.time() - t0:.2f} s", flush=True)
    jax_runs = [JAX_RUNCSP[s] for s in RUNCSP_PORT_SEEDS]
    print(f"  RUN-CSP seeds {RUNCSP_PORT_SEEDS[0]}-{RUNCSP_PORT_SEEDS[-1]}: cuts by seed "
          f"{[float(np.mean(c)) for c in cuts]} (mean {np.mean(cuts):.2f}); JAX's over the same seeds "
          f"{[float(np.mean(c)) for c in jax_runs]} (mean {np.mean(jax_runs):.2f})", flush=True)
    if not np.mean(cuts) >= 0.99 * np.mean(jax_runs):
        raise AssertionError(f"RUN-CSP: mean cut {np.mean(cuts):.2f} below JAX's {np.mean(jax_runs):.2f} less 1%")
    errs, untrained = [], []
    for s in range(len(JAX_DCS)):
        times = []
        model = dcs.DCS(dcs.DCSConfig(seed=s), device=dev)
        untrained.append(model.recovery_error())
        hist = model.train(timings=times)
        errs.append(model.recovery_error())
        if not np.isfinite(hist).all():
            raise AssertionError(f"DCS seed {s}: a loss is not finite")
        print(f"  DCS seed {s}: {model.cfg.num_epochs} epochs, {float(np.median(times)):.4f} s an epoch; loss "
              f"{hist[0]:.3f} -> {hist[-1]:.3f}; recovery error {untrained[-1]:.4f} untrained -> {errs[-1]:.4f}",
              flush=True)
    within_spread("DCS recovery error", errs, JAX_DCS, spread_margin(JAX_DCS))
    # the band separates a trained generator from an untrained one
    hi = max(JAX_DCS) + spread_margin(JAX_DCS)
    print(f"  DCS untrained: port {untrained}; JAX {list(JAX_DCS_UNTRAINED)}; each above the band's top {hi:.4f}",
          flush=True)
    if not min(untrained + list(JAX_DCS_UNTRAINED)) > hi:
        raise AssertionError(f"DCS: an untrained recovery error {min(untrained):.4f} lies inside the band")
    phase_memory("l2o", base)
    counts = {k.name: k.launches for k in build.KERNELS}
    require_launches("l2o phase", counts, (), list(counts))
    return counts


# HiGHS's time limits in the problems phase's CLI calls: maxcut's 5 s (its
# bound and gap go into the result file), and 2 s where BA_100_ID0's balanced
# partition and the scp4-like cover are not proved within the phase's budget
# (each stops at its limit with a feasible solution, re-scored as any other)
MILP_LIMITS = {"graph_partitioning": 2, "set_cover": 2}


def scp4_like(seed: int = 4):
    """A set-cover instance of OR-Library's scp4 shape (Beasley): 200 rows
    (items), 1000 columns (sets), 2% density; every row covered by at least
    two columns and every column covering at least one row."""
    from rlsolver_tpu_torch.core.io import SetCoverInstance
    rng = np.random.default_rng(seed)
    member = rng.random((1000, 200)) < 0.02
    for item in np.where(member.sum(0) < 2)[0]:
        member[rng.choice(1000, 2, replace=False), item] = True
    for s in np.where(~member.any(1))[0]:
        member[s, rng.integers(200)] = True
    return SetCoverInstance(200, tuple(tuple((np.where(row)[0] + 1).tolist()) for row in member))


def run_problems(dev) -> None:
    """The CLI's problem axis on the card's host and the card: greedy MIS,
    MVC and partitioning and the four colorings on BA_1000_ID0..2 (each
    re-scored, each coloring proper); knapsack on generate_knapsack(1000, 0)
    (DP on the card equal to branch and bound, FPTAS at least 0.9 DP, SA
    feasible and at most DP, greedy at most DP); set cover on an scp4-like
    instance (greedy, then anneal_set_cover at least as good, a 100-step
    window profiled); number partitioning (anneal_partition beside
    Karmarkar-Karp); then `cli_main` in this process for every new
    --problem/--alg pair with --write, the comparison CSV of
    `eval.statistics` over what it wrote, and `--alg milp` on maxcut."""
    import contextlib
    import io as _io
    import shutil
    from rlsolver_tpu_torch.classical import coloring as col, greedy as gr, knapsack as kp
    from rlsolver_tpu_torch.classical import number_partitioning as part, simulated_annealing as sa
    from rlsolver_tpu_torch.core.generate import generate_knapsack, graph_from_name
    from rlsolver_tpu_torch.core.io import write_graph
    from rlsolver_tpu_torch.eval.statistics import write_comparison_csv
    from rlsolver_tpu_torch.problems import objectives as obj
    from rlsolver_tpu_torch.run import main as cli_main

    # graph problems on DIST_TABLE's BA_1000 instances
    rescore = {"greedy_mis": (gr.greedy_mis, obj.obj_maximum_independent_set),
               "greedy_mvc": (gr.greedy_mvc, obj.obj_minimum_vertex_cover),
               "greedy_partitioning": (gr.greedy_graph_partitioning, obj.obj_graph_partitioning)}
    colorings = {"greedy": col.greedy_coloring, "welsh_powell": col.welsh_powell, "dsatur": col.dsatur,
                 "rlf": col.recursive_largest_first}
    for name in ("BA_1000_ID0", "BA_1000_ID1", "BA_1000_ID2"):
        g = graph_from_name(name)
        line = []
        for alg, (fn, objective) in rescore.items():
            t0 = time.time()
            sol, val = fn(g)
            host = objective(sol.astype(np.int64), g)
            if host != val or not np.isfinite(val):
                raise AssertionError(f"{alg} on {name}: {val} against host re-score {host}")
            line.append(f"{alg} {val:g} ({time.time() - t0:.2f} s)")
        for alg, fn in colorings.items():
            t0 = time.time()
            colors, k = fn(g)
            if not col.is_proper_coloring(g, colors) or obj.obj_graph_coloring(colors, g) != -k:
                raise AssertionError(f"coloring {alg} on {name}: improper or {k} colors mis-counted")
            line.append(f"{alg} {k} colors ({time.time() - t0:.2f} s)")
        print(f"  {name}: " + "; ".join(line), flush=True)

    # knapsack at 1000 items
    inst = generate_knapsack(1000, seed=0)
    res = {}
    for alg, fn in (("dp", lambda: kp.dp_knapsack(inst, dev)), ("branch_and_bound", lambda: kp.branch_and_bound_knapsack(inst)),
                    ("fptas", lambda: kp.fptas_knapsack(inst)), ("greedy", lambda: kp.greedy_knapsack(inst)),
                    ("sa", lambda: kp.sa_knapsack(inst, 0, device=dev))):
        t0 = time.time()
        bits, val = fn()
        torch.cuda.synchronize()
        res[alg] = (val, time.time() - t0)
        if obj.obj_knapsack(bits.astype(np.int64), inst) != val:
            raise AssertionError(f"knapsack {alg}: {val} is not its host re-score")
    print(f"  knapsack n=1000 capacity {inst.capacity:g}: " + "; ".join(f"{a} {v:g} ({t:.2f} s)"
                                                                      for a, (v, t) in res.items()), flush=True)
    dp_v = res["dp"][0]
    if not (res["branch_and_bound"][0] == dp_v and res["fptas"][0] >= 0.9 * dp_v and res["sa"][0] <= dp_v
            and res["greedy"][0] <= dp_v):
        raise AssertionError(f"knapsack: {res} breaks DP = B&B, FPTAS >= 0.9 DP, SA <= DP, greedy <= DP")

    # set cover of scp4's shape
    sc = scp4_like()
    t0 = time.time()
    _, greedy_v = gr.greedy_set_cover(sc)
    t_greedy = time.time() - t0
    sa_cfg = sa.SAConfig()
    t0 = time.time()
    bits, sa_v = sa.anneal_set_cover(sc, sa_cfg, device=dev)
    t_sa = time.time() - t0
    print(f"  set cover (scp4 shape: {sc.num_items} rows, {sc.num_sets} columns, "
          f"{sum(map(len, sc.subsets)) / (sc.num_items * sc.num_sets):.4f} density): greedy {-greedy_v:g} sets "
          f"({t_greedy:.2f} s), anneal_set_cover {-sa_v:g} sets ({sa_cfg.num_chains} chains x {sa_cfg.num_steps} "
          f"steps, {t_sa:.2f} s, {1e3 * t_sa / sa_cfg.num_steps:.3f} ms a step)", flush=True)
    if obj.obj_set_cover(bits.astype(np.int64), sc) != sa_v or sa_v < greedy_v:
        raise AssertionError(f"set cover: SA {sa_v} (host {obj.obj_set_cover(bits.astype(np.int64), sc)}) "
                             f"below greedy {greedy_v}")
    window = dataclasses.replace(sa_cfg, num_steps=100)
    profile_device(f"anneal_set_cover, 100 steps ({sa_cfg.num_chains} chains, {sc.num_sets} sets)",
                   lambda: sa.anneal_set_cover(sc, window, device=dev))

    # number partitioning
    nums = np.random.default_rng(1000).integers(1, 1001, 1000)
    t0 = time.time()
    _, kk = part.karmarkar_karp(nums)
    t_kk = time.time() - t0
    t0 = time.time()
    bits, ann = part.anneal_partition(nums, 0, device=dev)
    t_ann = time.time() - t0
    print(f"  number partitioning, 1000 integers in 1..1000 (sum {int(nums.sum())}): Karmarkar-Karp difference "
          f"{kk:g} ({t_kk:.3f} s), anneal_partition {ann:g} (256 chains x 2000 steps, {t_ann:.2f} s)", flush=True)
    if part.partition_difference(nums, bits) != ann:
        raise AssertionError("anneal_partition's difference is not its host re-score")

    # the CLI, in this process, with result files, then the comparison tables
    pairs = [("mis", a) for a in ("greedy", "isco", "milp")] + [("mvc", a) for a in ("greedy", "milp")]
    pairs += [("graph_partitioning", a) for a in ("greedy", "milp")]
    pairs += [("graph_coloring", a) for a in ("greedy", "welsh_powell", "dsatur", "rlf")]
    pairs += [("set_cover", a) for a in ("greedy", "milp")]
    pairs += [("knapsack", a) for a in ("greedy", "dp", "branch_and_bound", "fptas", "sa", "milp")]
    pairs += [("maxcut", "milp")]
    with tempfile.TemporaryDirectory(dir=REPO) as root:
        data = os.path.join(root, "data")
        write_graph(graph_from_name("BA_100_ID0"), os.path.join(data, "BA_100_ID0.txt"))
        os.makedirs(os.path.join(root, "instances", "data"))
        with open(os.path.join(root, "instances", "data", "scp4like.txt"), "w") as f:
            f.write(f"{sc.num_items} {sc.num_sets}\n" + "".join(" ".join(map(str, s)) + "\n" for s in sc.subsets))
        kinst = generate_knapsack(100, seed=1)
        with open(os.path.join(root, "instances", "data", "knap100.txt"), "w") as f:
            f.write(f"0 {kinst.num_items} {int(kinst.capacity)}\n"
                    + "".join(f"{int(w)} {int(p)}\n" for w, p in zip(kinst.weights, kinst.profits)))
        for problem, alg in pairs:
            instance = problem in ("set_cover", "knapsack")
            src = os.path.join(root, "instances", "data") if instance else data
            args = ["--problem", problem, "--alg", alg, "--data-dir", src, "--write", "--device", dev.type,
                    "--milp-time-limit", str(MILP_LIMITS.get(problem, 5))]
            if instance:
                args += ["--prefixes", "scp4like" if problem == "set_cover" else "knap100"]
            out = _io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                rc = cli_main(args)
            print(f"  [{problem}] {out.getvalue().strip()} ({time.time() - t0:.2f} s)", flush=True)
            if rc != 0 or out.getvalue().count("obj=") != 1:
                raise AssertionError(f"CLI --problem {problem} --alg {alg} failed ({rc}): {out.getvalue()}")
            # file the result under <problem>/<problem>_<alg>/, the layout eval.statistics reads
            result_dir = os.path.join(os.path.dirname(src), "result")
            dest = os.path.join(root, "tree", problem, f"{problem.replace('_', '-')}_{alg}")
            os.makedirs(dest, exist_ok=True)
            for fname in os.listdir(result_dir):
                shutil.move(os.path.join(result_dir, fname), os.path.join(dest, fname))
        for problem in sorted(os.listdir(os.path.join(root, "tree"))):
            csv_path = os.path.join(root, f"{problem}.csv")
            # every objective is maximized but a coloring's, reported as its count of colors
            table = write_comparison_csv(os.path.join(root, "tree", problem), csv_path,
                                         maximize=problem != "graph_coloring")
            with open(csv_path) as f:
                print(f"  comparison table {problem}: " + f.read().strip().replace("\n", " | "), flush=True)
            if not table:
                raise AssertionError(f"no comparison rows for {problem}")


# The RL+OR pipelines (phase rlor) and the agents (phase agents); no kernel
# of the port lies on either path. Depths: tests/test_rlor_rl.py's cut
# policy at its own parameters, branching and pricing cut (RLOR_BRANCH,
# RLOR_PRICING) to depths where the JAX package's own CPU run still meets
# every assertion (scripts/jax_rlor_agents_reference.py, whose figures for
# seeds 0-2 are the JAX_RLOR and JAX_AGENTS constants).
RLOR_CUT = dict(num_updates=60, rounds=3, eval_seeds=20)  # test_rlor_rl.py's own parameters
RLOR_BRANCH = dict(n_items=20, n_sets=40, train=8, il_epochs=300, rl_updates=10, rl_episodes=6, max_nodes=600,
                   eval_max_nodes=3000, val=range(30, 36), eval=range(50, 60))  # RL cut from 40 x 6
# the replay check's IL branching net starts from the JAX package's seed-0
# initial parameters (written by the reference script's --write-branch-init):
# whether RL beats IL on the eval set depends on the initial draw, in both
# packages, so only the replay of JAX's seed 0 holds rl < il
RLOR_BRANCH_INIT = os.path.join(REPO, "results_quality", "rlor_branch_init_seed0.npz")
RLOR_PRICING = dict(num_updates=10, episodes=6, eval=range(100, 130))  # cut from 40 x 8
RLOR_LP_SOLVES = 200  # LP solves timed alone
RLOR_CUT_MARGIN = 0.01  # the learned LP bound may lie this far outside JAX's seeds' (equal) bounds
JAX_RLOR = {  # scripts/jax_rlor_agents_reference.py on the CPU, training seeds 0-2
    "cut_learned": (29.5651622072637, 29.5651622072637, 29.5651622072637),  # max-violation: 29.579652414334127
    "pricing_learned_iters": (302.0, 303.0, 304.0),  # exact pricing: 308
    "branch_rl_nodes": (29.37451515152507, 30.36264290697348, 29.663587289587774),
    "branch_il_nodes": (29.860390746425043, 30.28711669394382, 29.399477657946036),  # most-fractional: 30.664
}
AGENT_OFF = dict(envs=1024, fill_steps=32, updates=300, lr=1e-3, eval_seed=99)
AGENT_REWARD_MARGIN = 0.2  # a point-chasing rollout's mean reward (-distance a step) may lie this far outside JAX's
JAX_AGENTS = {  # scripts/jax_rlor_agents_reference.py on the CPU, seeds 0-2
    "ddpg_after": (-0.5192507915198803, -0.5684143090620637, -0.4649860840290785),
    "td3_after": (-0.567780613899231, -0.6065464681014419, -0.47175836469978094),
    "sac_after": (-1.0898109339177608, -1.0643763989210129, -0.9412250462919474),
    "embed_accuracy": (0.921875, 0.8984375, 0.94140625),  # at the config's batch of 128
    "vdn_after": (-0.6953125, -0.6953125, -0.6953125),
    "qmix_after": (-0.6953125, -0.6953125, -0.6953125),
    "mappo_last": (1.7311839818954469, 1.3898521184921264, 0.8139772534370422),
    "maddpg_gap": (0.10116147994995117, 0.23632872104644775, 0.15678036212921143),
}
STOCK_ENVS, STOCK_DAYS, STOCK_NAMES = 4096, 252, 30
EMBED_SEEDS = (0, 1, 2)
# never overspent: the cash may fall below 0 only by the f32 rounding of a
# cost scaled to equal it, a few units in the last place of the initial
# cash (2^-10 at 1e4; 1.5 of them seen on the CPU, seed 1)
STOCK_CASH_FLOOR = -4 * float(np.spacing(np.float32(1e4)))


def no_launches(label: str) -> dict:
    """The port's kernels' launches since the last reset; fails unless none."""
    from rlsolver_tpu_torch.ops.kernels import build, mcpg_sweep, mh_sampler, sweep_kernel, weighted_sweep  # noqa: F401
    if len(build.KERNELS) != 12:
        raise AssertionError(f"{label}: {len(build.KERNELS)} kernels registered, not 12")
    counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  launches in {label}: {counts} (no kernel of the port lies on this path)", flush=True)
    if any(counts.values()):
        raise AssertionError(f"{label}: a kernel of the port launched: {counts}")
    return counts


def run_rlor(dev) -> dict:
    """tests/test_rlor_rl.py's three protocols on the card (the scorers on
    the card, the LPs on the host): the cut policy at its own parameters,
    branching and pricing at RLOR_BRANCH's and RLOR_PRICING's depths. Holds
    every assertion of the tests (learned < classical; the RL objective
    equal to most-fractional's and rl < il < mf nodes, on the replay of
    JAX's seed 0; pricing ties the integer value in fewer iterations; every
    B&B objective equal to scipy's milp), runs branching again from the
    port's own initial draw (rl and il within JAX's seeds 0-2, il < mf),
    prints each headline beside JAX's seeds 0-2 (within their range widened
    by their spread), the seconds per B&B node with the device scorer and
    per LP solve, and the device idle share of one RL update."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.ops.kernels import build
    from rlsolver_tpu_torch.solvers.branching import (_solve_lp, branch_and_bound, generate_set_cover,
                                                      most_fractional_policy)
    from rlsolver_tpu_torch.solvers.column_generation import (CuttingStockInstance, best_reduced_cost,
                                                              solve_cutting_stock)
    from rlsolver_tpu_torch.solvers.cutting import max_violation_policy
    from rlsolver_tpu_torch.solvers.rlor_train import (ScorePolicy, _pricing_features, deceptive_knapsack_ilp,
                                                       eval_cut_policy, train_branch_policy_rl, train_cut_policy,
                                                       train_pricing_policy)

    print(f"  {smi_line()}", flush=True)
    build.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # learn-to-cut at the test's parameters
    t0 = time.time()
    net = train_cut_policy(num_updates=RLOR_CUT["num_updates"], rounds=RLOR_CUT["rounds"],
                           instance_fn=deceptive_knapsack_ilp, seed=0, device=dev)
    seeds = list(range(RLOR_CUT["eval_seeds"]))
    learned = eval_cut_policy(lambda f, c: net.greedy(f), seeds, rounds=RLOR_CUT["rounds"],
                              instance_fn=deceptive_knapsack_ilp)
    classical = eval_cut_policy(max_violation_policy, seeds, rounds=RLOR_CUT["rounds"],
                                instance_fn=deceptive_knapsack_ilp)
    print(f"  cut policy ({RLOR_CUT['num_updates']} updates x 8 episodes, {RLOR_CUT['rounds']} rounds): learned LP "
          f"bound {learned!r} against max-violation's {classical!r}, {time.time() - t0:.2f} s", flush=True)
    if not learned < classical:
        raise AssertionError(f"cut policy: learned {learned} not below max-violation's {classical}")
    within_spread("learned LP bound", [learned], JAX_RLOR["cut_learned"], RLOR_CUT_MARGIN)

    # learn-to-branch: strong-branching samples, IL, RL fine-tuning
    t0 = time.time()
    kw = dict(n_items=RLOR_BRANCH["n_items"], n_sets=RLOR_BRANCH["n_sets"])
    train = [generate_set_cover(seed=s, **kw) for s in range(RLOR_BRANCH["train"])]
    val = [generate_set_cover(seed=s, **kw) for s in RLOR_BRANCH["val"]]
    evals = [generate_set_cover(seed=s, **kw) for s in RLOR_BRANCH["eval"]]
    samples = []
    for ilp in train:
        samples += branch_and_bound(ilp, use_strong=True, collect_samples=True,
                                    max_nodes=RLOR_BRANCH["max_nodes"]).samples
    t_samples = time.time() - t0
    optima = [-milp(c=-i.c, constraints=LinearConstraint(i.a, ub=i.b), integrality=np.ones(i.num_vars),
                    bounds=Bounds(0, 1)).fun for i in evals]

    def evaluate(label, policies):  # geometric-mean nodes by policy; every objective held to milp's
        nodes, objs = {}, {}
        for name, pol in policies:
            t2 = time.time()
            stats = [branch_and_bound(i, policy=pol, max_nodes=RLOR_BRANCH["eval_max_nodes"]) for i in evals]
            secs = time.time() - t2
            total = sum(s.num_nodes for s in stats)
            nodes[name] = float(np.exp(np.mean(np.log([max(1, s.num_nodes) for s in stats]))))
            objs[name] = [s.objective for s in stats]
            print(f"  branching {label}{name}: geometric-mean nodes {nodes[name]!r} over {len(evals)} instances, "
                  f"{total} nodes in {secs:.3f} s ({secs / total * 1e3:.3f} ms a node"
                  f"{', the device scorer in each' if name != 'mf' else ''})", flush=True)
            for s, o, ilp in zip(stats, optima, evals):
                if abs(s.objective - o) > 1e-6 or not (ilp.a @ s.solution <= ilp.b + 1e-6).all():
                    raise AssertionError(f"branching {name}: {ilp.name}: B&B objective {s.objective} != milp's {o}, "
                                         f"or its solution is infeasible")
        return nodes, objs

    def il_then_rl(init):  # IL from `init` (None: the port's own seed-0 draw), then RL fine-tuning
        il = ScorePolicy(num_features=6, seed=0, max_candidates=8, hidden=64, device=dev)
        if init is not None:
            il.params = {k: v.to(dev) for k, v in init.items()}
        il.imitate(samples, epochs=RLOR_BRANCH["il_epochs"])
        t1 = time.time()
        rl = train_branch_policy_rl(train, num_updates=RLOR_BRANCH["rl_updates"],
                                    episodes_per_update=RLOR_BRANCH["rl_episodes"],
                                    max_nodes=RLOR_BRANCH["max_nodes"], init_from=il, lr=5e-4, temperature=0.5,
                                    validation=val, seed=0, device=dev)
        return il, rl, time.time() - t1

    # the replay check: from JAX's seed-0 initial parameters the port must
    # retrace JAX's seed-0 run (the numpy draws are shared), so its figures
    # are JAX seed 0's, where the test's rl < il < mf holds
    il, rl, t_rl = il_then_rl(convert.flax_state_dict(convert.load_npz_tree(RLOR_BRANCH_INIT)))
    nodes, objs = evaluate("(replay of JAX seed 0) ", (("rl", lambda f, c: rl.greedy(f)),
                                                        ("il", lambda f, c: il.greedy(f)),
                                                        ("mf", most_fractional_policy)))
    print(f"  branching: {len(samples)} strong-branching samples in {t_samples:.2f} s, IL {RLOR_BRANCH['il_epochs']} "
          f"epochs, RL {RLOR_BRANCH['rl_updates']} x {RLOR_BRANCH['rl_episodes']} episodes in {t_rl:.2f} s; every "
          f"objective equal to milp's", flush=True)
    if not np.allclose(np.mean(objs["rl"]), np.mean(objs["mf"])):
        raise AssertionError(f"branching: RL's mean objective {np.mean(objs['rl'])} != most-fractional's")
    for name in ("rl", "il"):
        if not np.isclose(nodes[name], JAX_RLOR[f"branch_{name}_nodes"][0], rtol=1e-9, atol=0):
            raise AssertionError(f"branching replay: {name} nodes {nodes[name]!r} != JAX seed 0's "
                                 f"{JAX_RLOR[f'branch_{name}_nodes'][0]!r}")
    if not nodes["rl"] < nodes["il"] < nodes["mf"]:
        raise AssertionError(f"branching replay: not rl < il < mf nodes: {nodes}")
    # the port's own seed-0 initial draw: a draw of its own, held to JAX's
    # seeds 0-2 (rl < il fails for JAX's seeds 1 and 2 at this depth, so
    # it is not held here; il < mf holds for all three)
    own_il, own_rl, t_own = il_then_rl(None)
    own, own_objs = evaluate("(the port's own seed-0 init) ", (("rl", lambda f, c: own_rl.greedy(f)),
                                                                ("il", lambda f, c: own_il.greedy(f))))
    print(f"  branching from the port's own init: RL in {t_own:.2f} s; rl {own['rl']!r}, il {own['il']!r}, "
          f"mf {nodes['mf']!r} nodes", flush=True)
    if not np.allclose(np.mean(own_objs["rl"]), np.mean(objs["mf"])) or not own["il"] < nodes["mf"]:
        raise AssertionError(f"branching (own init): RL's mean objective {np.mean(own_objs['rl'])} != "
                             f"most-fractional's, or not il < mf nodes: {own}, mf {nodes['mf']}")
    for name in ("rl", "il"):
        within_spread(f"{name} geometric-mean nodes (own init)", [own[name]], JAX_RLOR[f"branch_{name}_nodes"],
                      spread_margin(JAX_RLOR[f"branch_{name}_nodes"]))
    # where a B&B node's time goes: the LP on the host, the scorer on the card
    t2 = time.time()
    for _ in range(RLOR_LP_SOLVES):
        _solve_lp(evals[0], frozenset(), frozenset())
    lp_s = (time.time() - t2) / RLOR_LP_SOLVES
    feats = samples[0][0]
    torch.cuda.synchronize()
    t2 = time.time()
    for _ in range(RLOR_LP_SOLVES):
        rl.greedy(feats)
    score_s = (time.time() - t2) / RLOR_LP_SOLVES
    print(f"  seconds per LP solve (root of set cover seed 50, host HiGHS) {lp_s:.6f}; per device scoring call "
          f"(copy in, 3 layers, copy out) {score_s:.6f}", flush=True)
    rng = np.random.default_rng(0)

    def rl_update():  # one update of train_branch_policy_rl: its episodes, then the REINFORCE step
        steps = []
        for _ in range(RLOR_BRANCH["rl_episodes"]):
            traj = []
            stats = branch_and_bound(train[int(rng.integers(len(train)))], max_nodes=RLOR_BRANCH["max_nodes"],
                                     policy=lambda f, c: traj.append((f, rl.sample(f, rng, 0.5))) or traj[-1][1])
            steps += [(f, a, 0.1) for f, a in traj]
        rl.reinforce(steps)

    profile_device(f"one RL update of the branching policy ({RLOR_BRANCH['rl_episodes']} B&B episodes and the "
                   f"REINFORCE step)", rl_update)

    # RL pricing for cutting-stock column generation
    t0 = time.time()
    pnet = train_pricing_policy(num_updates=RLOR_PRICING["num_updates"], episodes_per_update=RLOR_PRICING["episodes"],
                                seed=0, device=dev)
    t_train = time.time() - t0
    it_l = it_g = v_l = v_g = 0.0
    for s in RLOR_PRICING["eval"]:
        inst = CuttingStockInstance.random(10, seed=s)
        r1 = solve_cutting_stock(inst, policy=lambda d, c, _i=inst: pnet.greedy(_pricing_features(_i, d, c)),
                                 num_candidates=4)
        r2 = solve_cutting_stock(inst, policy=best_reduced_cost, num_candidates=4)
        it_l, it_g, v_l, v_g = it_l + r1.num_iterations, it_g + r2.num_iterations, v_l + r1.int_value, v_g + r2.int_value
    print(f"  pricing ({RLOR_PRICING['num_updates']} updates x {RLOR_PRICING['episodes']} episodes, {t_train:.2f} s): "
          f"learned {it_l!r} iterations against exact pricing's {it_g!r} on {len(RLOR_PRICING['eval'])} instances, "
          f"integer values {v_l!r} and {v_g!r}", flush=True)
    if not (abs(v_l - v_g) <= 1e-6 * max(1.0, abs(v_g)) and it_l < it_g):
        raise AssertionError(f"pricing: learned ({it_l}, {v_l}) does not tie exact pricing ({it_g}, {v_g}) in fewer "
                             f"iterations")
    within_spread("learned pricing iterations", [it_l], JAX_RLOR["pricing_learned_iters"],
                  spread_margin(JAX_RLOR["pricing_learned_iters"]))
    phase_memory("rlor", base)
    return no_launches("rlor")


def point_rollout(env, agent, state, envs: int, seed: int) -> float:
    """Mean reward of the agent's actions over the env's horizon from a
    reset drawn from `seed` (SAC samples with its fixed-seed noise)."""
    gen = torch.Generator(env.device).manual_seed(seed)
    st, obs = env.reset(envs, generator=gen)
    total = torch.zeros((), device=env.device)
    for _ in range(env.horizon):
        st, obs, r, _ = env.step(st, agent.act(state, obs), generator=gen)
        total = total + r.mean()
    return float(total) / env.horizon


def coop_env(dev):
    """tests/test_multi_agent.py's goal env: 3 agents on a line, each moving
    left, staying or right; joint reward -sum |pos - goal|."""
    n = 3

    def reset(gen, batch):
        pos = torch.randint(-3, 4, (batch, n), generator=gen, device=dev).float()
        return pos, torch.arange(n, dtype=torch.float32, device=dev)[None, :].repeat(batch, 1)

    def obs(pos, goal):
        return torch.stack([pos, goal, goal - pos, (goal - pos).abs()], dim=-1)

    def state(pos, goal):
        return torch.cat([pos, goal, goal - pos], dim=1)

    def step(pos, goal, actions):
        pos = pos + actions.float() - 1.0
        return pos, -(pos - goal).abs().sum(dim=1)

    return reset, obs, state, step


def timed_update(label: str, update_fn, reps: int) -> None:
    """Seconds per update, eager (wall over `reps` calls, the card synchronised
    at both ends), then the device idle share of one."""
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        update_fn()
    torch.cuda.synchronize()
    print(f"  {label}: {(time.time() - t0) / reps:.6f} s per update (eager, {reps} updates)", flush=True)
    profile_device(f"one {label} update", update_fn)


def run_agents(dev) -> dict:
    """The off-policy and multi-agent agents and the demo envs on the card:
    DDPG, TD3 and SAC at OffPolicyConfig's widths on PointChasingEnv (1024
    envs into the ring), EmbedDQN on the contextual bandit, VDN, QMIX,
    MAPPO and MADDPG on tests/test_multi_agent.py's goal env, each with its
    tests' assertions, and StockTradingEnv's accounting over a year of 4096
    envs under a SAC actor."""
    from rlsolver_tpu_torch.algos.continuous import (EmbedDQNAgent, EmbedDQNConfig, OffPolicyAgent,
                                                     OffPolicyConfig, Replay, Transition, replay_add, replay_sample)
    from rlsolver_tpu_torch.algos.multi_agent import (MaddpgAgent, MaddpgConfig, MappoAgent, MappoConfig, MixConfig,
                                                      ValueMixAgent)
    from rlsolver_tpu_torch.envs.demo import PointChasingEnv, StockTradingEnv
    from rlsolver_tpu_torch.ops.kernels import build

    print(f"  {smi_line()}", flush=True)
    build.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    env = PointChasingEnv(device=dev)
    for algo in ("ddpg", "td3", "sac"):
        t0 = time.time()
        cfg = OffPolicyConfig(obs_dim=env.obs_dim, act_dim=env.act_dim, lr=AGENT_OFF["lr"], seed=0)
        agent = OffPolicyAgent(algo, cfg, device=dev)
        state, update = agent.init(), agent.make_update()
        before = point_rollout(env, agent, state, AGENT_OFF["envs"], AGENT_OFF["eval_seed"])
        gen = torch.Generator(dev).manual_seed(1000)
        st, obs = env.reset(AGENT_OFF["envs"], generator=gen)
        buf = Replay.create(cfg.capacity, cfg.obs_dim, cfg.act_dim, device=dev)
        for _ in range(AGENT_OFF["fill_steps"]):  # uniform random actions, 1024 envs a step into the ring
            act = torch.rand((AGENT_OFF["envs"], env.act_dim), generator=gen, device=dev) * 2.0 - 1.0
            st, nxt, r, d = env.step(st, act, generator=gen)
            buf = replay_add(buf, Transition(obs, act, r, nxt, d))
            obs = nxt
        for _ in range(AGENT_OFF["updates"] - 20):
            state, metrics = update(state, replay_sample(buf, cfg.batch, gen))
        timed_update(algo, lambda: update(state, replay_sample(buf, cfg.batch, gen)), 19)  # 281-299, and 300 profiled
        after = point_rollout(env, agent, state, AGENT_OFF["envs"], AGENT_OFF["eval_seed"])
        print(f"  {algo}: ring {buf.size} of {cfg.capacity}, {state.step} updates of batch {cfg.batch}; rollout "
              f"reward before {before!r}, after {after!r}; {time.time() - t0:.2f} s", flush=True)
        if not (after > before and np.isfinite(float(metrics["critic_loss"]))):
            raise AssertionError(f"{algo}: reward after {after} not above before {before}, or the critic loss is not "
                                 f"finite ({float(metrics['critic_loss'])})")
        within_spread(f"{algo} rollout reward after training", [after], JAX_AGENTS[f"{algo}_after"],
                      AGENT_REWARD_MARGIN)

    # EmbedDQN on the contextual bandit (tests/test_continuous.py:96) at
    # EmbedDQNConfig's widths (its batch of 128, where the test takes 64),
    # seeds 0-2: one seed's greedy accuracy straddles 0.9 in both packages
    # (JAX's seed 1: 0.898), so their mean is held above it
    accs = []
    for seed in EMBED_SEEDS:
        cfg = EmbedDQNConfig(obs_dim=4, action_dim=4, lr=3e-3, tau=0.05, seed=seed)
        agent = EmbedDQNAgent(cfg, device=dev)
        state, update = agent.init(), agent.make_update()
        buf = Replay.create(cfg.capacity, cfg.obs_dim, 1, device=dev)
        gen = torch.Generator(dev).manual_seed(1 + 100 * seed)
        for _ in range(40):
            o = torch.rand((16, cfg.obs_dim), generator=gen, device=dev)
            a = torch.randint(0, cfg.action_dim, (16,), generator=gen, device=dev)
            rew = (a == o.argmax(dim=1)).float()
            buf = replay_add(buf, Transition(o, a[:, None].float(), rew, o, torch.ones(16, device=dev)))
        for _ in range(380 if seed == EMBED_SEEDS[-1] else 400):
            state, _ = update(state, replay_sample(buf, cfg.batch, gen))
        if seed == EMBED_SEEDS[-1]:
            timed_update("EmbedDQN", lambda: update(state, replay_sample(buf, cfg.batch, gen)), 19)  # 381-399, 400
        o = torch.rand((256, cfg.obs_dim), generator=gen, device=dev)
        accs.append(float((agent.act(state, o, explore=False) == o.argmax(dim=1)).float().mean()))
    print(f"  EmbedDQN: greedy accuracy by seed {accs} (mean {float(np.mean(accs))!r}); JAX seeds "
          f"{JAX_AGENTS['embed_accuracy']} (mean {float(np.mean(JAX_AGENTS['embed_accuracy']))!r})", flush=True)
    if not np.mean(accs) > 0.9:
        raise AssertionError(f"EmbedDQN: mean accuracy {np.mean(accs)} not above 0.9")

    # VDN, QMIX, MAPPO, MADDPG on the goal env (tests/test_multi_agent.py)
    reset, cobs, cstate, cstep = coop_env(dev)

    def eval_greedy(agent, st):
        pos, goal = reset(torch.Generator(dev).manual_seed(5), 32)
        total = torch.zeros((), device=dev)
        for _ in range(8):
            pos, r = cstep(pos, goal, agent.act(st, cobs(pos, goal), epsilon=0.0))
            total = total + r.mean()
        return float(total) / 8

    for mixer, name in (("sum", "vdn"), ("qmix", "qmix")):
        agent = ValueMixAgent(mixer, MixConfig(n_agents=3, obs_dim=4, state_dim=9, num_actions=3, lr=2e-3), device=dev)
        st, update = agent.init(), agent.make_update()
        before = eval_greedy(agent, st)
        gen = torch.Generator(dev).manual_seed(0)
        done = torch.ones(64, device=dev)
        for _ in range(6):  # fresh epsilon-greedy data each epoch, then 3 passes over it
            pos, goal = reset(gen, 64)
            data = []
            for _ in range(20):
                o = cobs(pos, goal)
                actions = agent.act(st, o, epsilon=0.3)
                new_pos, reward = cstep(pos, goal, actions)
                data.append((o, actions, reward, cobs(new_pos, goal), cstate(pos, goal), cstate(new_pos, goal)))
                pos = new_pos
            for _ in range(3):
                for o, actions, reward, no, sg, nsg in data:
                    st, loss = update(st, o, actions, reward, no, done, sg, nsg)
        after = eval_greedy(agent, st)
        print(f"  {name}: greedy reward before {before!r}, after {after!r} (JAX seeds: {JAX_AGENTS[name + '_after']})",
              flush=True)
        if not (after > before and np.isfinite(float(loss))):
            raise AssertionError(f"{name}: greedy reward after {after} not above before {before}")
        o, actions, reward, no, sg, nsg = data[0]
        timed_update(name, lambda: update(st, o, actions, reward, no, done, sg, nsg), 10)  # after the protocol
    agent = MappoAgent(MappoConfig(n_agents=3, obs_dim=4, state_dim=9, num_actions=3, lr=1e-3), device=dev)
    st, update = agent.init(), agent.make_update()
    gen, losses = torch.Generator(dev).manual_seed(1), []
    for _ in range(30):
        pos, goal = reset(gen, 128)
        o, sg = cobs(pos, goal), cstate(pos, goal)
        actions, logp = agent.act(st, o)
        _, reward = cstep(pos, goal, actions)
        st, metrics = update(st, o, actions, logp, reward - agent.value(st, sg), reward, sg)
        losses.append(metrics["critic_loss"])
    losses = torch.stack(losses).tolist()
    timed_update("MAPPO", lambda: update(st, o, actions, logp, reward - agent.value(st, sg), reward, sg), 10)  # after
    print(f"  MAPPO: critic loss first 5 {float(np.mean(losses[:5]))!r}, last 5 {float(np.mean(losses[-5:]))!r} (JAX seeds: "
          f"{JAX_AGENTS['mappo_last']})", flush=True)
    if not (np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError("MAPPO: the critic loss did not fall")
    agent = MaddpgAgent(MaddpgConfig(n_agents=2, obs_dim=3, act_dim=1, lr=1e-3), device=dev)
    st, update = agent.init(), agent.make_update()
    gen, losses = torch.Generator(dev).manual_seed(2), []
    for _ in range(60):
        o = torch.randn((64, 2, 3), generator=gen, device=dev)
        act = torch.clamp(torch.randn((64, 2, 1), generator=gen, device=dev), -1, 1)
        st, metrics = update(st, o, act, -(act[..., 0] - o[..., 0]).abs(), o, torch.ones(64, device=dev))
        losses.append(metrics["critic_loss"])
    losses = torch.stack(losses).tolist()
    probe = torch.zeros((8, 2, 3), device=dev)
    probe[..., 0] = 0.5
    gap = float((agent.act(st, probe)[..., 0] - 0.5).abs().mean())
    timed_update("MADDPG", lambda: update(st, o, act, -(act[..., 0] - o[..., 0]).abs(), o, torch.ones(64, device=dev)),
                 10)
    print(f"  MADDPG: critic loss first 10 {float(np.mean(losses[:10]))!r}, last 10 {float(np.mean(losses[-10:]))!r}, "
          f"|action - 0.5| "
          f"{gap!r} (JAX seeds: {JAX_AGENTS['maddpg_gap']})", flush=True)
    if not (np.isfinite(losses).all() and np.mean(losses[-10:]) < np.mean(losses[:10]) and gap < 0.45):
        raise AssertionError("MADDPG: the critic loss did not fall or the actions did not move")

    # StockTradingEnv: a year of 4096 envs under an (untrained) SAC actor
    t0 = time.time()
    senv = StockTradingEnv.random_walk(STOCK_DAYS, STOCK_NAMES, seed=0, device=dev)
    agent = OffPolicyAgent("sac", OffPolicyConfig(obs_dim=senv.obs_dim, act_dim=STOCK_NAMES, seed=0), device=dev)
    state = agent.init()
    gen = torch.Generator(dev).manual_seed(3)
    st, o = senv.reset(STOCK_ENVS)
    rewards, low_cash, low_shares = [], torch.zeros((), device=dev), torch.zeros((), device=dev)
    for _ in range(STOCK_DAYS - 1):
        st, o, r, d = senv.step(st, agent.act(state, o, generator=gen))
        rewards.append(r)
        low_cash, low_shares = torch.minimum(low_cash, st.cash.min()), torch.minimum(low_shares, st.shares.min())
    rewards = torch.stack(rewards).double().cpu().numpy()
    prices = senv.prices.astype(np.float64)
    final = st.cash.double().cpu().numpy() + st.shares.double().cpu().numpy() @ prices[st.day]
    gain = final - senv.initial_cash
    rel = float(np.abs(rewards.sum(axis=0) - gain).max() / np.abs(final).max())
    print(f"  stock trading ({STOCK_ENVS} envs x {STOCK_DAYS - 1} days, {STOCK_NAMES} stocks): {time.time() - t0:.2f} s; "
          f"least cash {float(low_cash)!r} (floor {STOCK_CASH_FLOOR}), least holding {float(low_shares)!r}; summed rewards against the float64 "
          f"re-scored asset change: largest gap {rel:.3e} of the assets; mean gain {float(gain.mean())!r}", flush=True)
    if not (float(low_cash) >= STOCK_CASH_FLOOR and float(low_shares) >= 0 and rel <= 1e-3 and bool(d.bool().all())):
        raise AssertionError("stock trading: short, overspent, or the rewards do not sum to the asset change")
    phase_memory("agents", base)
    return no_launches("agents")



# The data-parallel layer (phase `parallel`): the sharded forms at world
# size 1 over NCCL in this process, then at world size 2, two spawned ranks
# sharing the card over gloo
PAR_WORLD2_CUT = dict(ppo=10, l2a=1)  # world size 2's depth: PPO iterations of 40, L2A iterations of 2 (room)
UNSHARDED: dict = {}  # the tnco, ppo and l2a phases' runs that the world of one is held to (run_parallel)
PAR_PPO_ITERS = PPO_ITERS  # the ppo phase's depth (the step size annealed over PPOConfig's 100 iterations)
PAR_L2A_CUT = dict(pretrain_steps=20, num_iters=2, seq_len=4)  # the l2a phase's depth cut
PAR_POMO_STEPS = 3  # the first captures the graph(s)
PAR_REDUCE_REPS = 20
PAR_K10_SIMS = 128  # a rank's L2A sims at world size 2 (of L2AConfig's 256)
PAR_PATHS = ("tnco", "ppo", "l2a", "pomo")
PAR_RECORD_NUMEL = 16  # a reduction of at most this many values is a metric's (the gradient buffers are larger)
PAR_POMO_RTOL = 1e-5  # POMO's f32 tour lengths against the host's float64 re-score of the tours


def _l2a_iteration_secs(times: dict, seq_len: int) -> list:
    """Seconds of each L2A iteration (its rollout steps and its PPO update)
    from `solve_maxcut_l2a`'s timings."""
    return [sum(times["rollout"][i * seq_len : (i + 1) * seq_len]) + p for i, p in enumerate(times["ppo"])]


def _par_flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])


def _par_reduce_ms(numel: int, group, dev) -> float:
    """Milliseconds of one all-reduce of an f32 buffer of `numel` over
    `group` (host clock around a synchronised call, the mean of
    PAR_REDUCE_REPS after one warm-up)."""
    import torch.distributed as dist

    buf = torch.ones(numel, device=dev)
    dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_REDUCE_REPS):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / PAR_REDUCE_REPS


class _ParRecorder:
    """Inside `with`, on one rank: every pmean, pmax and pmin of at most
    PAR_RECORD_NUMEL values (the metrics; the gradient buffers are larger)
    as (op, this rank's value, the reduced value), and a digest of the
    replicated state after every ClippedAdam step that Python makes outside
    a capture (`adam=False`: only where the caller calls `digest`, as after a
    replayed POMO step); the last optimizer is kept for its full state."""

    def __init__(self, adam: bool = True):
        self.adam, self.reduced, self.digests, self.opt = adam, [], [], None

    def __enter__(self):
        from rlsolver_tpu_torch import optim
        from rlsolver_tpu_torch.parallel import mesh as mesh_lib

        self.saved = [(mesh_lib, op, getattr(mesh_lib, op)) for op in ("pmean", "pmax", "pmin")]
        for mod, op, fn in self.saved:
            setattr(mod, op, self._reduce(op, fn))
        if self.adam:
            adam_step = optim.ClippedAdam.step

            def step(opt, *args, **kwargs):
                adam_step(opt, *args, **kwargs)
                if not torch.cuda.is_current_stream_capturing():
                    self.digest(opt)

            self.saved.append((optim.ClippedAdam, "step", adam_step))
            optim.ClippedAdam.step = step
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def _reduce(self, op: str, fn):
        def reduce(x, mesh=None):
            out = fn(x, mesh)
            if x.numel() <= PAR_RECORD_NUMEL:
                self.reduced.append((op, x.detach().clone(), out.detach().clone()))
            return out
        return reduce

    def digest(self, opt) -> None:
        """Two int64 sums of the state's f32 bits, plain and weighted by
        position (integer sums: exact in any order): equal states give equal
        digests, and states that differ in a bit all but surely do not."""
        bits = torch.cat([t.detach().reshape(-1) for t in opt.state_tensors()]).view(torch.int32).long()
        self.digests.append(torch.stack([bits.sum(), (bits * torch.arange(1, bits.numel() + 1,
                                                                          device=bits.device)).sum()]))
        self.opt = opt

    def result(self) -> dict:
        """CPU values: the reductions, the digests [steps, 2], the last
        optimizer's state flat and its gradient buffer's length."""
        return dict(reduced=[(op, a.cpu().numpy(), b.cpu().numpy()) for op, a, b in self.reduced],
                    digests=torch.stack(self.digests).cpu(), state=_par_flat(self.opt.state_tensors()),
                    grad_numel=sum(p.numel() for p in self.opt.params))


def _par_sharded(dev, mesh) -> dict:
    """This rank's part of the four sharded forms (solve_tnco_mcpg_sharded,
    train_ppo_sharded, data-parallel L2A iterations, POMO steps) at the
    configurations of `parallel`'s docstring, K10's plain version made to
    raise; returns CPU values: what each returns, what `_ParRecorder` saw
    of it, this rank's own best PPO env and last POMO tours for the host's
    re-scores, seconds per step and the launches of the L2A run."""
    import torch.distributed as dist

    from rlsolver_tpu_torch.algos import am_pomo as ap, l2a, ppo, tnco_solver as ts
    from rlsolver_tpu_torch.core.generate import build_g22_like
    from rlsolver_tpu_torch.envs.tnco import TensorNetwork, TncoEnv, random_circuit_nodes
    from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
    from rlsolver_tpu_torch.ops.kernels import build, sweep_kernel as sk
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    n_ranks, out = mesh_lib.world_size(mesh), {"rank": mesh_lib.rank(mesh), "backend": dist.get_backend()}
    g = build_g22_like()
    # TNCO at the tnco phase's Sycamore N53 12-layer shape: the chains sharded
    env = TncoEnv(TensorNetwork.from_nodes_list(*random_circuit_nodes(53, 12, seed=0)), dev)
    cfg, secs = dataclasses.replace(ts.TncoMcpgConfig(), num_rounds=TNCO_ROUNDS), []
    with _ParRecorder() as rec:
        order, cost, hist = ts.solve_tnco_mcpg_sharded(env, mesh, cfg, timings=secs)
    out["tnco"] = dict(order=order, cost=cost, best=hist, secs=secs, **rec.result())
    del env, rec

    # PPO at PPOConfig's widths on G22-like, the envs sharded
    pcfg, secs = ppo.PPOConfig(), []
    iters = PAR_PPO_ITERS if n_ranks == 1 else PAR_WORLD2_CUT["ppo"]
    with _ParRecorder() as rec:
        pstate, hist = ppo.train_ppo_sharded(g, mesh, pcfg, device=dev, timings=secs, iterations=iters)
    top = int(torch.argmax(pstate.env_state.cut))
    out["ppo"] = dict(history=hist, secs=secs, best_x=pstate.env_state.xs[top].cpu().numpy(),
                      local_best=float(pstate.env_state.cut[top]), **rec.result())
    del pstate, rec

    # data-parallel L2A at L2AConfig's widths on G22-like (K10 on every rank)
    lcfg = dataclasses.replace(l2a.L2AConfig(), seed=0, **PAR_L2A_CUT)
    if n_ranks > 1:
        lcfg = dataclasses.replace(lcfg, num_iters=PAR_WORLD2_CUT["l2a"])
    plain_f32 = [(sk, "sweep_1flip_f32_plain")]
    saved = plains_raise(plain_f32)
    build.reset_counts()
    try:
        env_l, gen, net, opt, steps = l2a._l2a_setup(g, lcfg, dev, group=mesh)
        xs = env_l.random_xs(gen, lcfg.num_sims)
        xs = mesh_lib.shard_env_batch(mesh, mesh_lib.replicated(xs, mesh))
        vs = env_l.obj(xs)
        gen_r = mesh_lib.shard_generator(lcfg.seed, mesh, dev) or gen
        # the incumbent as `Evaluator` keeps it (the l2a phase's solve records one an iteration)
        best_x, best_v = xs[0].cpu().numpy(), float(vs[0])
        rec_l = dict(secs=[], records=[best_v])
        with _ParRecorder() as rec:
            for _ in range(lcfg.num_iters):
                t0 = time.time()
                xs, vs, losses = l2a.data_parallel_iteration(steps, gen_r, xs, vs, lcfg.seq_len)
                torch.cuda.synchronize()
                rec_l["secs"].append(time.time() - t0)
                top = int(torch.argmax(vs))
                rec_l["records"].append(float(vs[top]))
                if float(vs[top]) > best_v:
                    best_x, best_v = xs[top].cpu().numpy(), float(vs[top])
    finally:
        restore(plain_f32, saved)
    rec_l.update(best_x=best_x, best_v=best_v, launches={k.name: k.launches for k in build.KERNELS}, **rec.result())
    out["l2a"] = rec_l
    del env_l, net, opt, steps, rec

    # POMO at POMOConfig's widths: each rank batch_size / ranks instances
    acfg = ap.POMOConfig()
    acfg = dataclasses.replace(acfg, batch_size=acfg.batch_size // n_ranks)
    rec_p = {}
    for graphed in (True, False) if n_ranks > 1 else (True,):
        model = mesh_lib.replicated(AttentionTSP(acfg.embed_dim, acfg.num_heads, acfg.num_layers, seed=acfg.seed,
                                                 device=dev), mesh)
        opt, pstep = ap.make_pomo_step(model, acfg, cuda_graph=graphed, group=mesh)
        gen = torch.Generator(device=dev)
        gen.manual_seed(acfg.seed)
        gen_r = mesh_lib.shard_generator(acfg.seed, mesh, dev) or gen
        hist, secs = [], []
        with _ParRecorder(adam=False) as rec:
            for _ in range(PAR_POMO_STEPS):
                t0 = time.time()
                hist.append({k: float(v) for k, v in pstep(gen_r).items()})
                secs.append(time.time() - t0)
                rec.digest(opt)
        nodes, tours = (x.cpu().numpy() for x in pstep.last_tours)
        rec_p["graph" if graphed else "eager"] = dict(history=hist, secs=secs, nodes=nodes, tours=tours,
                                                      **rec.result())
    out["pomo"] = rec_p
    out["reduce_ms"] = {p: _par_reduce_ms(out[p]["grad_numel"] if p != "pomo" else out[p]["graph"]["grad_numel"],
                                          mesh_lib.group_of(mesh), dev) for p in PAR_PATHS}
    return out


def _par_rank() -> dict:
    """The four forms on a rank of `parallel`'s world of 2, run by
    `dryrun_multichip(2, extra=...)` after its five paths."""
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    return _par_sharded(torch.device("cuda", torch.cuda.current_device()), mesh_lib.make_mesh(device_type="cuda"))


def _par_unsharded(dev) -> dict:
    """The four paths unsharded from the same seeds (the world of one's
    counterparts): the tnco, ppo and l2a phases' runs where they ran in
    this process (`UNSHARDED`), else run here; POMO's steps here."""
    from rlsolver_tpu_torch.algos import am_pomo as ap, l2a, ppo, tnco_solver as ts
    from rlsolver_tpu_torch.core.generate import build_g22_like
    from rlsolver_tpu_torch.envs.flip_mdp import FlipMdpEnv
    from rlsolver_tpu_torch.envs.tnco import TensorNetwork, TncoEnv, random_circuit_nodes
    from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
    from rlsolver_tpu_torch.ops.kernels import sweep_kernel as sk

    g, out = build_g22_like(), dict(UNSHARDED)
    if "tnco" not in out:
        env = TncoEnv(TensorNetwork.from_nodes_list(*random_circuit_nodes(53, 12, seed=0)), dev)
        secs = []
        order, cost, hist = ts.solve_tnco_mcpg(env, dataclasses.replace(ts.TncoMcpgConfig(), num_rounds=TNCO_ROUNDS),
                                               timings=secs)
        out["tnco"] = dict(order=order, cost=cost, best=hist, secs=secs)
    if "ppo" not in out:
        pcfg = ppo.PPOConfig()
        penv = FlipMdpEnv(g, horizon=pcfg.horizon, device=dev)
        iteration, state = ppo.make_ppo_iteration(penv, pcfg), ppo.init_ppo_state(penv, pcfg, pcfg.num_envs)
        hist, secs = [], []
        for _ in range(PAR_PPO_ITERS):
            t0 = time.time()
            state, m = iteration(state)
            hist.append({k: float(v) for k, v in m.items()})
            secs.append(time.time() - t0)
        out["ppo"] = dict(history=hist, secs=secs, state=_par_flat(state.optimizer.state_tensors()))
    if "l2a" not in out:
        lcfg = dataclasses.replace(l2a.L2AConfig(), seed=0, **PAR_L2A_CUT)
        times = {}
        plain_f32 = [(sk, "sweep_1flip_f32_plain")]
        saved = plains_raise(plain_f32)
        try:
            best_x, best_v, ev = l2a.solve_maxcut_l2a(g, lcfg, device=dev, timings=times)
        finally:
            restore(plain_f32, saved)
        out["l2a"] = dict(best_x=best_x, best_v=best_v, records=[r[1] for r in ev.records],
                          secs=_l2a_iteration_secs(times, lcfg.seq_len))
    acfg = ap.POMOConfig()
    model = AttentionTSP(acfg.embed_dim, acfg.num_heads, acfg.num_layers, seed=acfg.seed, device=dev)
    opt, pstep = ap.make_pomo_step(model, acfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(acfg.seed)
    hist, secs = [], []
    for _ in range(PAR_POMO_STEPS):
        t0 = time.time()
        hist.append({k: float(v) for k, v in pstep(gen).items()})
        secs.append(time.time() - t0)
    out["pomo"] = dict(graph=dict(history=hist, secs=secs, state=_par_flat(opt.state_tensors())))
    return out


def _par_same(label: str, a, b) -> None:
    """Bit for bit: tensors, arrays, floats, lists and dicts of them."""
    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(equal(u, v) for u, v in zip(x, y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        return x == y

    if not equal(a, b):
        raise AssertionError(f"parallel: {label} differ")


def _par_runs(ranks, path):
    """[(label, [the run of `path` on rank 0, on rank 1, ...]), ...]: one
    entry, or one for each of POMO's modes."""
    if path != "pomo":
        return [(path, [r[path] for r in ranks])]
    return [(f"pomo ({m})", [r["pomo"][m] for r in ranks]) for m in ("graph", "eager") if m in ranks[0]["pomo"]]


def _par_reductions(label: str, runs) -> list:
    """Every reduction that `_ParRecorder` saw in `runs` (one a rank) must be
    the host's of the ranks' own values, on every rank: the f32 SUM over
    n then / n for pmean, the max for pmax, the min for pmin. Returns the
    reductions as (op, [own value by rank], reduced value)."""
    logs = [run["reduced"] for run in runs]
    n = len(runs)
    if len({len(log) for log in logs}) != 1:
        raise AssertionError(f"parallel: {label}: the ranks made {[len(log) for log in logs]} reductions")
    out = []
    for k, recs in enumerate(zip(*logs)):
        op = recs[0][0]
        if any(rec[0] != op for rec in recs):
            raise AssertionError(f"parallel: {label}: reduction {k} is {[rec[0] for rec in recs]} by rank")
        own = np.stack([rec[1] for rec in recs]).astype(np.float32)
        want = {"pmean": lambda: own.sum(axis=0, dtype=np.float32) / np.float32(n), "pmax": lambda: own.max(axis=0),
                "pmin": lambda: own.min(axis=0)}[op]()
        for r, rec in enumerate(recs):
            if not np.array_equal(rec[2], want):
                raise AssertionError(f"parallel: {label}: reduction {k} ({op}) gave {rec[2].tolist()} on rank {r}; "
                                     f"the host's of the ranks' own {own.tolist()} is {want.tolist()}")
        out.append((op, own, want))
    return out


def _par_metrics(label: str, reduced, ops, values=None) -> None:
    """The reductions behind a solver's returned metrics: their ops are
    `ops`, and their values `values` where given (the metrics as the solver
    returned them)."""
    if [op for op, _, _ in reduced] != list(ops):
        raise AssertionError(f"parallel: {label}: the reductions are {[op for op, _, _ in reduced]}, not {list(ops)}")
    if values is not None and not all(np.array_equal(np.float32(v), want) for (_, _, want), v in zip(reduced, values)):
        raise AssertionError(f"parallel: {label}: the returned metrics {values} are not the reductions "
                             f"{[want.tolist() for _, _, want in reduced]}")


def _par_check(label: str, ranks, g, tnco_env) -> None:
    """The checks of one world's ranks: the replicated state (its digest
    after every step and its full value at the end) bit for bit equal
    across the ranks; every reduced metric the host's reduction of the
    ranks' own values, and the one the solver returned; every best cost,
    cut or tour length its host re-score; K10 launched on every rank."""
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    n, first, held = len(ranks), ranks[0], {}
    for path in PAR_PATHS:
        for name, runs in _par_runs(ranks, path):
            for r, run in enumerate(runs[1:], 1):
                _par_same(f"{label}: {name}'s replicated state after every step on rank {r} and rank 0",
                          run["digests"], runs[0]["digests"])
                _par_same(f"{label}: {name}'s replicated state on rank {r} and rank 0", run["state"], runs[0]["state"])
            reduced = held[name] = _par_reductions(f"{label} {name}", runs)
            if path == "tnco":  # a round: the mean cost pmean'd, the incumbent pmin'd
                rounds = len(runs[0]["best"])
                _par_metrics(f"{label} TNCO's rounds", reduced, ("pmean", "pmin") * rounds)
                _par_metrics(f"{label} TNCO's best by round", reduced[1::2], ("pmin",) * rounds, runs[0]["best"])
            elif path == "ppo":  # an iteration: the advantages' mean and variance a minibatch, then the metrics
                hist = runs[0]["history"]
                per = len(reduced) // len(hist)
                if per * len(hist) != len(reduced):
                    raise AssertionError(f"parallel: {label}: {len(reduced)} PPO reductions in {len(hist)} iterations")
                for i, h in enumerate(hist):
                    _par_metrics(f"{label} PPO's iteration {i}", reduced[i * per : (i + 1) * per],
                                 ("pmean",) * (per - 4) + ("pmean", "pmean", "pmax", "pmean"))
                    _par_metrics(f"{label} PPO's metrics of iteration {i}", reduced[(i + 1) * per - 4 : (i + 1) * per],
                                 ("pmean", "pmean", "pmax", "pmean"),
                                 [h[k] for k in ("loss", "mean_cut", "best_cut", "mean_reward")])
            elif path == "pomo":  # a step: the three metrics pmean'd (the gradients too, not recorded)
                hist = runs[0]["history"]
                _par_metrics(f"{label} {name}'s metrics", reduced, ("pmean",) * len(hist),
                             [[h[k] for k in ("loss", "mean_length", "best_length")] for h in hist])
    for r in ranks[1:]:
        keys = ("order", "cost", "best")
        _par_same(f"{label}: rank {r['rank']}'s TNCO order, cost and history and rank 0's",
                  [r["tnco"][k] for k in keys], [first["tnco"][k] for k in keys])
        _par_same(f"{label}: rank {r['rank']}'s PPO history and rank 0's", r["ppo"]["history"], first["ppo"]["history"])
    if first["tnco"]["cost"] != first["tnco"]["best"][-1]:
        raise AssertionError(f"{label}: TNCO's gathered best {first['tnco']['cost']} is not its last round's pmin")
    check_order(f"{label} TNCO (sharded, {n} rank{'s' * (n > 1)})", tnco_env, first["tnco"]["order"],
                first["tnco"]["cost"], first["tnco"]["best"])
    for r in ranks:
        host = obj_maxcut(r["ppo"]["best_x"].astype("int64"), g)
        if host != r["ppo"]["local_best"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s best PPO cut {r['ppo']['local_best']} != host {host}")
        host = obj_maxcut(r["l2a"]["best_x"].astype("int64"), g)
        if host != r["l2a"]["best_v"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s L2A best cut {r['l2a']['best_v']} != host {host}")
        if r["l2a"]["launches"]["sweep_1flip_f32"] <= 0:
            raise AssertionError(f"{label}: rank {r['rank']}'s L2A did not launch K10")
        wrong = [k for k in SWEEPS if r["l2a"]["launches"][k]]
        if wrong:
            raise AssertionError(f"{label}: rank {r['rank']}'s L2A launched {wrong}")
    # each rank's own best cut of the last iteration went into the pmax
    last_pmax = [own for op, own, _ in held["ppo"] if op == "pmax"][-1]
    if last_pmax.tolist() != [np.float32(r["ppo"]["local_best"]) for r in ranks]:
        raise AssertionError(f"{label}: the ranks' own best PPO cuts {last_pmax.tolist()} are not their best envs'")
    worst = 0.0
    for name, runs in _par_runs(ranks, "pomo"):
        for r, run in enumerate(runs):
            nodes, tours = run["nodes"].astype(np.float64), run["tours"]
            if not (np.sort(tours, axis=-1) == np.arange(tours.shape[-1])).all():
                raise AssertionError(f"{label}: a {name} tour on rank {r} is not a permutation")
            pts = np.take_along_axis(nodes[:, None, :, :], tours[..., None], axis=2)
            lengths = np.sqrt(((pts - np.roll(pts, -1, axis=2)) ** 2).sum(-1)).sum(-1)
            own = run["reduced"][-1][1]  # this rank's (loss, mean length, mean best length) of the last step
            host = np.asarray([lengths.mean(), lengths.min(axis=1).mean()])
            err = float(np.abs(own[1:] - host).max() / host.max())
            worst = max(worst, err)
            if not err <= PAR_POMO_RTOL:
                raise AssertionError(f"{label}: {name} rank {r}'s lengths {own[1:].tolist()} against the host's "
                                     f"float64 re-score {host.tolist()}: {err:.2e} of them (limit {PAR_POMO_RTOL})")
    print(f"  {label}: replicated state equal on the {n} rank{'s' * (n > 1)} after every step; "
          f"{sum(map(len, held.values()))} reductions equal to the host's of the ranks' own values; TNCO's cost, "
          f"the PPO and L2A cuts their host re-scores, POMO's lengths within {worst:.2e} of the float64 re-score "
          f"of its tours (limit {PAR_POMO_RTOL})", flush=True)


def _par_print(label: str, ranks, unsharded=None) -> None:
    r0 = ranks[0]
    def med(x):
        return float(np.median(x[1:] if len(x) > 1 else x))
    for p in ("tnco", "ppo", "l2a"):
        line = f"  {label} {p}: s/step (median after the first) {[round(med(r[p]['secs']), 5) for r in ranks]} by rank"
        if unsharded is not None:
            line += f", unsharded {med(unsharded[p]['secs']):.5f}"
        print(line + f"; secs {[round(s, 4) for s in r0[p]['secs']]}", flush=True)
    for mode in ("graph", "eager"):
        if mode in r0["pomo"]:
            line = (f"  {label} pomo ({mode}): s/step {[round(s, 5) for s in r0['pomo'][mode]['secs']]} (rank 0), "
                    f"mean length {[round(h['mean_length'], 4) for h in r0['pomo'][mode]['history']]}")
            if unsharded is not None and mode == "graph":
                line += f"; unsharded {[round(s, 5) for s in unsharded['pomo']['graph']['secs']]}"
            print(line, flush=True)
    numel = {p: (r0[p] if p != "pomo" else r0[p]["graph"])["grad_numel"] for p in PAR_PATHS}
    print(f"  {label} one all-reduce of each path's gradient buffer over {r0['backend']}: "
          + ", ".join(f"{p} {numel[p]} f32 {r0['reduce_ms'][p]:.4f} ms" for p in PAR_PATHS), flush=True)


def run_parallel(dev, errs: dict) -> dict:
    """The `parallel` phase: (a) world size 1 over NCCL in this process,
    every sharded form bit for bit equal to its unsharded counterpart from
    the same seeds; (b) `dryrun_multichip(2)` and the four forms at world
    size 2, two ranks sharing the card over gloo, each holding half the
    chains, envs and sims; (c) the checks of `_par_check`, K10 on a rank's
    shard shape bit for bit against its plain version; (d) the backends,
    s/step beside the unsharded step, one all-reduce of each gradient buffer.
    Returns the launches of both L2A worlds, summed over the ranks."""
    import torch.distributed as dist

    from rlsolver_tpu_torch import entry
    from rlsolver_tpu_torch.algos.l2a import L2AConfig
    from rlsolver_tpu_torch.core.generate import build_g22_like
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.envs.tnco import TensorNetwork, TncoEnv, random_circuit_nodes
    from rlsolver_tpu_torch.ops import cut
    from rlsolver_tpu_torch.ops.kernels import build, sweep_kernel as sk
    from rlsolver_tpu_torch.parallel import launch, mesh as mesh_lib

    g = build_g22_like()
    tnco_env = TncoEnv(TensorNetwork.from_nodes_list(*random_circuit_nodes(53, 12, seed=0)), dev)
    print(f"  {smi_line()}", flush=True)
    # (a) world size 1, NCCL, in this process
    store = tempfile.mkdtemp(prefix="parallel_")
    backend = launch.choose_backend(1, "cuda")
    print(f"  world size 1: backend {backend} (a card for the rank)", flush=True)
    dist.init_process_group(backend, init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        t0 = time.time()
        one = _par_sharded(dev, mesh_lib.make_mesh(device_type="cuda"))
        t_one = time.time() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.time()
    base = _par_unsharded(dev)
    t_base = time.time() - t0
    _par_check("world 1", [one], g, tnco_env)
    _par_same("world 1: TNCO's order, cost and history and the unsharded run's",
              (one["tnco"]["order"], one["tnco"]["cost"], one["tnco"]["best"]),
              (base["tnco"]["order"], base["tnco"]["cost"], base["tnco"]["best"]))
    _par_same("world 1: PPO's history and state and the unsharded run's", (one["ppo"]["history"], one["ppo"]["state"]),
              (base["ppo"]["history"], base["ppo"]["state"]))
    _par_same("world 1: L2A's incumbent bits, its cut and the best cut after each iteration and the unsharded "
              "solve's", [one["l2a"][k] for k in ("best_x", "best_v", "records")],
              [base["l2a"][k] for k in ("best_x", "best_v", "records")])
    _par_same("world 1: POMO's metrics and state and the unsharded run's",
              [one["pomo"]["graph"][k] for k in ("history", "state")],
              [base["pomo"]["graph"][k] for k in ("history", "state")])
    print(f"  world 1 over {one['backend']}: every sharded form equals its unsharded run bit for bit ({t_one:.1f} s "
          f"sharded, {t_base:.1f} s unsharded)", flush=True)
    _par_print("world 1", [one], base)

    # (b) dryrun_multichip(2) on one card, its ranks then running the four forms at world size 2
    t0 = time.time()
    dry = entry.dryrun_multichip(2, "cuda", timeout_s=300, join_timeout_s=900, extra=_par_rank)
    two = [r["extra"] for r in dry]
    print(f"  world 2: dryrun_multichip(2) ({time.time() - t0:.1f} s), its ranks on {[r['backend'] for r in two]}: "
          f"`__graft_entry__.py`'s asserts hold and the replicated parameters are equal "
          f"({[round(r['seconds'], 2) for r in dry]} s by rank); then the four forms in its ranks, depth cut to "
          f"{PAR_WORLD2_CUT['ppo']} PPO and {PAR_WORLD2_CUT['l2a']} L2A iterations", flush=True)
    _par_check("world 2", two, g, tnco_env)
    _par_print("world 2", two, base)

    # (c) K10 at a rank's shard shape (128 sims x 8 repeats of G22-like)
    env = MaxcutEnv(g, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(128)
    b = PAR_K10_SIMS * L2AConfig().num_repeats
    xs = torch.rand(b, g.num_nodes, generator=gen, device=dev) < 0.5
    args = (env.cg.adj, cut.signs_from_bits(xs), env.gains(xs), env.obj(xs))
    for part, a, p in zip(("s", "gains", "vs"), sk.sweep_1flip_f32(*args, env.f32_lists),
                          sk.sweep_1flip_f32_plain(*args)):
        require_equal(f"K10 sweep_1flip_f32 at a rank's shard shape ({b} chains of G22like): {part}", a, p, errs,
                      "sweep_1flip_f32")
    counts = {k.name: one["l2a"]["launches"][k.name] + sum(r["l2a"]["launches"][k.name] for r in two)
              for k in build.KERNELS}
    print(f"  launches in the L2A runs, world 1 and both ranks of world 2: {counts}", flush=True)
    return counts


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
    from rlsolver_tpu_torch.ops import cut
    from rlsolver_tpu_torch.ops.kernels import build, codec, engine, mcpg_sweep as sw, mh_sampler as mh
    from rlsolver_tpu_torch.ops.kernels import sweep_kernel as sk, weighted_sweep as wsw
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
    k3_at = {}  # K3's times at the runner's shape
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
    # K2 on 1001 chains (its rows padded to 1004 by `bulk_rows`), words W
    # and past it among the proposals (no-ops)
    with form_seconds("check"):
        odd = stream[:, :1001].clone()
        pick = torch.rand(odd.shape, generator=gen, device=dev)
        odd = torch.where(pick < 0.05, (w << 7) | (odd & 127), torch.where(pick > 0.95, odd + (5000 << 7), odd))
        require_equal("K2 mh_sample_stream on 1001 chains, words >= W mixed in", mh.mh_sample_stream(odd, bits[:1001]),
                      codec.unpack_bits(mh.mh_stream_plain(odd, codec.pack_bits(bits[:1001])), n), errs,
                      "mh_sample_stream")
    del odd, pick

    if mh.fused_kernel(B, w, dev) is not mh.MH_FUSED:
        raise AssertionError(f"fused_form picks {mh.fused_kernel(B, w, dev).name} at {B} chains; the chain form "
                             f"is expected there")
    out = mh.mh_sample_fused(12345, probs, bits, ROUNDS)
    plain = codec.unpack_bits(mh.mh_fused_plain(12345, thr, codec.pack_bits(bits), n, ROUNDS), n)
    require_equal("K3 mh_sample_fused", out, plain, errs, "mh_sample_fused")
    # K3's wide path (N >= 2^15: node = umulhi(draw, N), two draws a round)
    # in each form
    with form_seconds("check"):
        n_wide = mh.WIDE_NODES + 3
        thr_wide = mh.fused_thresholds(torch.rand(n_wide, generator=gen, device=dev) * 0.6 + 0.2)
        words_wide = codec.pack_bits(torch.rand(4099, n_wide, generator=gen, device=dev) < 0.5)
        plain = mh.mh_fused_plain(6789, thr_wide, words_wide, n_wide, 101)
        for k in (mh.MH_FUSED, mh.MH_FUSED_SPLIT):
            out = words_wide.clone()
            mh.launch_fused(k, thr_wide, out, n_wide, 101, 6789)
            require_equal(f"K3 {k.name} on the wide path (4099 chains x N = {n_wide} x 101 rounds)", out, plain, errs,
                          k.name)
    del thr_wide, words_wide
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
    # K2's ring (one stream, stages of 8 rounds) beside a 32-chain tile: 4
    # stages at N = 52,000, 2 at 57,500, 1 at 57,700 and at 58,000 none;
    # 130 chains, so that the rows are padded
    with form_seconds("check"):
        for n_big in (52000, 57500, 57700, 58000):
            p_big = torch.rand(n_big, generator=gen, device=dev) * 0.6 + 0.2
            x_big = torch.rand(130, n_big, generator=gen, device=dev) < 0.5
            s_big = mh.make_proposal_stream(torch.randint(0, 2**32, (300, 130), generator=gen, device=dev,
                                                          dtype=torch.int64), p_big)
            require_equal(f"K2 mh_sample_stream at N = {n_big} (130 chains x 300 rounds)",
                          mh.mh_sample_stream(s_big, x_big),
                          codec.unpack_bits(mh.mh_stream_plain(s_big, codec.pack_bits(x_big)), n_big), errs,
                          "mh_sample_stream")
    del x10, p10, pick, p_big, x_big, s_big
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
    main_seconds = times
    print(f"  C={fast_cfg.total_mcmc_num} R={fast_cfg.repeat_times} -> {B} chains, N={n}, "
          f"num_ls={S}, {ROUNDS} MH rounds per round; cut to max_epoch_num=1, {len(times)} rounds")
    print(f"  best cut {best_v} host re-score {host} seconds/round {times} samples/s {[B / t for t in times]}")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB launches {fast_counts}")
    if host != best_v:
        raise AssertionError(f"main: best cut {best_v} != host re-score {host}")
    for k in (mh.fused_kernel(B, w, dev).name, "mcpg_sweep", "sweep_1flip"):
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
        for k in (mh.fused_kernel(bw, codec.num_words(gw.num_nodes), dev).name, sweep_k, flip_k):
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

    plain_f32 = [(sk, "sweep_1flip_f32_plain")]
    saved = plains_raise(plain_f32)
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    l2a_times = {}
    try:
        best_x, best_v, ev = l2a.solve_maxcut_l2a(g, l2a_cfg, device=dev, timings=l2a_times)
        torch.cuda.synchronize()
    finally:
        restore(plain_f32, saved)
    l2a_counts = {k.name: k.launches for k in build.KERNELS}
    UNSHARDED["l2a"] = dict(best_x=best_x, best_v=best_v, records=[r[1] for r in ev.records],
                            secs=_l2a_iteration_secs(l2a_times, l2a_cfg.seq_len))
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

    # the runners on TrainLoop (checkpoint and resume; l2a's profile folded in)
    t0 = time.time()
    runner_counts = run_runners(dev, g, main_seconds, errs, k3_at)
    phase("runners", t0)
    t0 = time.time()
    run_problems(dev)
    phase("problems", t0)

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
    t0 = time.time()
    tnco_counts, k3_tnco = run_tnco(dev, errs)
    phase("tnco", t0)

    # Pattern I: ECO-DQN, S2V-DQN, Jumanji PPO, bench.py's pattern1 datum -------
    build.reset_counts()
    for name, run in (("eco", run_eco), ("s2v", run_s2v), ("jumanji", run_jumanji), ("pattern1", run_pattern1)):
        t0 = time.time()
        run(dev)
        phase(name, t0)
    pattern_i_counts = {k.name: k.launches for k in build.KERNELS}
    print(f"  launches in eco, s2v, jumanji and pattern1: {pattern_i_counts} (no kernel of the port lies on "
          f"the Pattern I path: the MPNN's GEMMs and the env's elementwise ops are torch)", flush=True)
    t0 = time.time()
    run_ppo(dev)
    phase("ppo", t0)
    t0 = time.time()
    run_beamforming(dev)
    phase("beamforming", t0)
    t0 = time.time()
    tsp_counts = run_tsp(dev)
    phase("tsp", t0)
    t0 = time.time()
    l2o_counts = run_l2o(dev)
    phase("l2o", t0)
    t0 = time.time()
    rlor_counts = run_rlor(dev)
    phase("rlor", t0)
    t0 = time.time()
    agents_counts = run_agents(dev)
    phase("agents", t0)
    t0 = time.time()
    parallel_counts = run_parallel(dev, errs)
    phase("parallel", t0)

    # 9. CLI ------------------------------------------------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=REPO) as data_dir:
        with open(os.path.join(data_dir, "W22like.txt"), "w") as f:  # gset format, 1-indexed
            f.write(f"{w22.num_nodes} {w22.num_edges}\n")
            f.writelines(f"{a + 1} {b + 1} {int(x)}\n" for (a, b), x in zip(w22.edges.tolist(), w22.weights))
        args = ["--alg", "mcpg", "--fast", "--data-dir", data_dir, "--prefixes", "W22like", "--graphs", "BA_100_ID0"]
        proc = subprocess.run([sys.executable, "-m", "rlsolver_tpu_torch", *args], capture_output=True, text=True,
                              cwd=REPO, timeout=600)
        print("  " + proc.stdout.strip().replace("\n", "\n  "), flush=True)
        if proc.returncode != 0 or proc.stdout.count("obj=") != 2:
            raise AssertionError(f"CLI {args} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    # the other entries in this process (a `python -m` run pays its own start-up
    # and first calls, 7-13 s each)
    import contextlib
    import io
    from rlsolver_tpu_torch.run import main as cli_main
    runs = [(["--alg", alg] + fast, "BA_100_ID0") for alg in ("l2a", "local_search") for fast in ([], ["--fast"])]
    runs += [(["--alg", alg], "BA_100_ID0") for alg in ("sa", "isco", "ga")] + [(["--alg", "vqe"], VQE_GRAPH)]
    for args, graph in runs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(args + ["--graphs", graph])
        print("  " + out.getvalue().strip(), flush=True)
        if rc != 0 or out.getvalue().count("obj=") != 1:
            raise AssertionError(f"CLI {args} failed ({rc}): {out.getvalue()}")
    phase("cli", t0)

    # 10. timings at each path's shapes ---------------------------------------
    t0 = time.time()
    words = codec.pack_bits(bits)
    warm_words = codec.pack_bits(warm)
    stream = proposal_stream()
    thr1, thr2 = sw._noisy_thresholds(tables, 0.25)
    word_bytes = 2 * B * w * 4  # chains read and written once
    words_split = words[:SPLIT_CHAINS].clone()
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
             run=lambda: mh.MH_STREAM.launch(stream, words, B, B, w, ROUNDS),
             plain=lambda: mh.mh_stream_plain(stream, words), plain_chains=B, reps=10,
             bytes=word_bytes + stream.numel() * 4, step_ops=ROUNDS * B * K2_OPS),
        dict(name="mh_sample_fused", kernel=mh.MH_FUSED, launches=fast_counts["mh_sample_fused"],
             run=lambda: mh.launch_fused(mh.MH_FUSED, thr, words, n, ROUNDS, 12345),
             plain=lambda: mh.mh_fused_plain(12345, thr, words, n, ROUNDS), plain_chains=B, reps=10,
             bytes=word_bytes + thr.numel() * 4, step_ops=ROUNDS * B * K3_OPS, serial_rounds=ROUNDS, graph=True),
        # K3's split form at mcpg_multi's maxcut shape (8192 chains of G22-like, 1000 rounds); its launches are
        # mcpg_multi's (tnco's beside them)
        dict(name="mh_sample_fused_split", kernel=mh.MH_FUSED_SPLIT, launches=multi_counts["mh_sample_fused_split"],
             run=lambda: mh.launch_fused(mh.MH_FUSED_SPLIT, thr, words_split, n, SPLIT_ROUNDS, 12345),
             plain=lambda: mh.mh_fused_plain(12345, thr, words_split, n, SPLIT_ROUNDS), plain_chains=SPLIT_CHAINS,
             reps=10, bytes=2 * SPLIT_CHAINS * w * 4 + thr.numel() * 4, step_ops=SPLIT_ROUNDS * SPLIT_CHAINS * K3_OPS,
             serial_rounds=SPLIT_ROUNDS, graph=True),
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
        t_row = time.perf_counter()
        ms = graph_ms(row["run"], row["reps"]) if row.get("graph") else cuda_ms(row["run"], row["reps"])
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
        if "serial_rounds" in row:
            kernels[-1].update(k3_serial(thr, n, row["serial_rounds"]))
            print(f"  {row['name']}: serial floor {kernels[-1]['serial_floor_ms']:.4f} ms ({row['serial_rounds']} "
                  f"rounds; a round {kernels[-1]['serial_round_us']} us, one chain's launches)")
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
        if row.get("graph"):  # K3's two rows
            FORM_SECONDS["time"] = FORM_SECONDS.get("time", 0.0) + time.perf_counter() - t_row
    print(f"  K2's ring checks and K3's two forms' checks and timings, wall seconds by phase: {FORM_SECONDS}, "
          f"{sum(FORM_SECONDS.values()):.2f} s in all", flush=True)
    for k in kernels:
        k["l2a_dist_launches"] = dist_counts[k["name"]]
        k["mcpg_multi_launches"] = multi_counts[k["name"]]
        if k["name"] == "mh_sample_fused_split":
            k["mcpg_multi_shapes"] = k3_shapes
            k.update(k3_tnco)
        if k["name"] == "mh_sample_fused":
            k["runner_shape"] = k3_at["runner"]
        k["mcpg_batch_launches"] = batch_counts[k["name"]]
        k["baselines_launches"] = baseline_counts[k["name"]]
        k["runners_launches"] = runner_counts[k["name"]]
        k["pattern_i_launches"] = pattern_i_counts[k["name"]]
        k["tnco_launches"] = tnco_counts[k["name"]]
        k["tsp_launches"], k["l2o_launches"] = tsp_counts[k["name"]], l2o_counts[k["name"]]
        k["rlor_launches"], k["agents_launches"] = rlor_counts[k["name"]], agents_counts[k["name"]]
        k["parallel_launches"] = parallel_counts[k["name"]]
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
