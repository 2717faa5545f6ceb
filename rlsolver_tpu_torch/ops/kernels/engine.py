"""Which packed kernel runs a graph's sweeps (counterpart of
`rlsolver_tpu/ops/pallas/engine.py:FusedSweepEngine`, and of the 1-flip
dispatch in `rlsolver_tpu/envs/maxcut.py:68-100`).

The noisy sweep. K4 (weights in {0, +-1}; each step's non-zero mask words,
`PackedSweepTables.word_entries`) and K6 (other integer weights; each
step's neighbour list) keep a block's tile of 128 chains in shared memory,
W words each; K7 keeps the chains in device memory, chain-minor, and stages
only the lists (a few hundred KB at Gset sizes, always in L2). The JAX
package asked whether its dense tables fit the TPU core's VMEM; what limits
K4 and K6 on the card is their chain tile: the fewer tiles share an SM, the
fewer warps hide the latency of each step, past the card's shared memory
the tiles run in waves, and where not even 32 chains fit a block's shared
memory K4 does not launch.
So K4 or K6 runs while a tile leaves at least `K6_MIN_TILES_PER_SM` tiles
per SM, K4 when its word lists also fit `SWEEP_L2_SHARE` of the card's L2,
and K7 beyond, with `LIST_STAGE_ENTRIES` list entries per stage.
`scripts/torch_engine_share.py` times K6 and K4 against K7 across sizes,
chain counts and densities (PERF.md): K6 was faster from 4 tiles per SM; at
2 or 3 it was up to 14% faster at 24,576 chains but K7 was 1.2-1.5 times
faster at 262,144, and at 1 tile K7 was faster everywhere. On unit weights
K7 was level with K4 or faster in every cell below 4 tiles (1.3-3.7 times
at 262,144 chains, 1.8-2.1 times at one tile), and from 4 tiles K4 took
0.67-1.29 times K7's time.

The 1-flip sweep. K5 ({0, +-1} weights), K8a and K8b all run one warp a
chain. K5 and K8b walk a level schedule, the lanes splitting each level's
nodes and each lane a node's whole neighbour list; K5 reads its signed
lists from a copy of the whole table in each block's shared memory
(`mcpg_sweep.LevelLists`), K8b its {j, w} lists from device memory. K8a
walks the N nodes in order, its lanes splitting each row's non-zero
bit-plane words (a popcount serves up to 32 neighbours). A step of K8a
costs about the same whatever the row's length up to the 32 x 8 entries its
lanes hold, so K8a's time grows with N, while a level schedule's work grows
with each list and its depth (D2000-like, 200 neighbours a node: 341
levels). So a {0, +-1} graph goes to K5 while it has at most 2^15 nodes,
its table and one chain's words fit a block's shared memory (`k5_fits`)
and its rows are sparse, fewer than `K5_MAX_NEIGHBOURS` neighbours a node on
average. Any other graph goes to K8a where rows are dense and K8a's word
entries fit `FLIP_L2_SHARE` of L2: from `K8A_MIN_NEIGHBOURS` neighbours a
node, and on {0, +-1} graphs of at most `K8A_SMALL_NODES` nodes from
`K5_MAX_NEIGHBOURS` (exact on +-1 weights as one plane); to K8b elsewhere.
`scripts/torch_engine_share.py` timed the three on unit weights at 768 and
2048 chains (PERF.md, NVIDIA H100 80GB HBM3, 700 W). Up to 50 neighbours
a node, wherever its table fits, K5 was the fastest in 21 of 22 cells: at
N = 2000 (where the table fits up to about 52) 0.08-0.42 ms against K8a's
0.68-0.98 and K8b's 0.11-0.60 (the exception: 2 neighbours at 768
chains, 0.119 against K8b's 0.109, where another call measured 0.051
against 0.096), at N = 16,000 and 2 neighbours 0.23 / 0.44 ms against
K8b's 0.66 / 0.67. Against K8a at N = 500 and N = 1000 (768 / 2048 chains, K5
over K8a): 0.67 / 0.64 and 0.44 / 0.43 at 40 neighbours, 0.89 / 0.90 and
0.58 / 0.57 at 50, 0.99 / 1.08 and 0.68 / 0.93 at 60, 1.29 / 1.42 and
0.84 / 1.11 at 70, 1.49 / 1.71 and 0.94 / 1.28 at 80, up to 8.4 at 200
(N = 500); K8b was slower than K8a in all of these cells from 60 (1.5-12
times). Where the table does not fit, on unit weights (K8a over K8b): at
N = 2000 0.98 / 1.26 at 60, 0.83 / 1.08 at 70, 0.66 / 0.89 at 80; at
N = 4000 1.32 / 1.88 at 60, 1.14 / 1.33 at 70, 1.09 / 1.25 at 80, so there
K8b stays the faster at 80, where the rule, set at N = 2000, takes K8a
(PERF.md §7). On other integer
weights K8a and K8b were timed at N = 2000: K8a
took 0.69-0.99 ms from 2 to 200 neighbours a node, K8b 0.09 ms at 2 and
4.7 ms at 200; K8b was the faster at 60 neighbours a node (K8a over K8b 1.01 and
1.29), the two split at 70 (0.85 and 1.04), and K8a was the faster from 80
(0.68 and 0.88), 4.8-6.1 times at 200 and 28-29 times at 1000.

The rule reads only sizes and the edge list, so `plan_sweep` and
`plan_1flip` can be asked about a graph without building its tables.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops.kernels import build
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as sw
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as wsw
from rlsolver_tpu_torch.ops.kernels.codec import num_words

# NVIDIA H100 SXM: 50 MB of L2 (data sheet), which the CUDA runtime reports
# as 52,428,800 bytes; used when the device is the CPU (tests, planning).
H100_L2_BYTES = 52_428_800
# The share of L2 that K4's word lists or K8a's word entries may take (see
# above).
SWEEP_L2_SHARE = 0.8
FLIP_L2_SHARE = 0.7
# K8a from this many neighbours a node on average (2 |E| / N), else K8b
# (measured: K8a was the faster at 768 and 2048 chains from 80).
K8A_MIN_NEIGHBOURS = 80
# K5 below this many neighbours a node on average, while its table fits
# (measured: K5 was the faster below 60 at 768 and 2048 chains, K8a from 70).
K5_MAX_NEIGHBOURS = 60
# On {0, +-1} weights, K8a from K5_MAX_NEIGHBOURS on graphs of at most this
# many nodes (measured: K8a beat K8b from 60 neighbours a node at N = 500
# and 1000, not at N = 2000 or 4000).
K8A_SMALL_NODES = 1000
# K4 or K6 while their chain tile leaves this many tiles per SM, else K7
# (measured).
K6_MIN_TILES_PER_SM = 4
# K7's list entries per stage (8 bytes each, two stages a block; measured).
LIST_STAGE_ENTRIES = 128
# H100 (compute capability 9.0, CUDA C++ Programming Guide): 228 KB of
# shared memory per SM, of which the runtime keeps 1 KB per resident block.
H100_SMEM_PER_SM = 233_472
H100_SMEM_RESERVED_PER_BLOCK = 1_024


def l2_bytes(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).L2_cache_size
    return H100_L2_BYTES


def _blocks_per_sm(smem: int) -> int:
    return H100_SMEM_PER_SM // (smem + H100_SMEM_RESERVED_PER_BLOCK)


def _tile_bytes(n: int) -> int:
    """Shared memory of a full tile of chains, N nodes each (csrc/common.cuh)."""
    return build.header_constant("kChainsPerBlock") * (num_words(n) | 1) * 4


def k6_tiles_per_sm(n: int) -> int:
    """How many of K6's chain tiles share an SM at N nodes."""
    return _blocks_per_sm(_tile_bytes(n)) if _tile_bytes(n) <= build.header_constant("kMaxSmem") else 0


class Plan(NamedTuple):
    weighted: bool  # K6/K7 rather than K4
    # None: K6 (chains in shared memory); else K7's list entries per stage
    node_chunk: Optional[int]


class FlipPlan(NamedTuple):
    weighted: bool  # K8a/K8b rather than K5
    levels: bool  # K8b (neighbour lists in a level schedule) rather than K8a


def _unit_fits(graph: Graph, fit_bytes: float, table_bytes) -> bool:
    """Whether K4 takes the graph: weights in {0, +-1}, and the tables the
    kernel reads (`table_bytes(graph)`) fit."""
    return sw.is_unit_weight(graph) and table_bytes(graph) <= fit_bytes


def k5_fits(graph: Graph) -> bool:
    """Whether K5 takes the graph: weights in {0, +-1}, at most
    `K5_MAX_NODES` nodes, and its table (at its largest,
    `level_table_bytes`) and one chain's words fit a block's shared
    memory."""
    return (sw.is_unit_weight(graph) and graph.num_nodes <= sw.K5_MAX_NODES
            and sw.level_smem_bytes(sw.level_table_bytes(graph), graph.num_nodes) <= build.header_constant("kMaxSmem"))


def plan_sweep(graph: Graph, l2: int) -> Plan:
    """K4, K6 or K7 for the noisy sweeps. ValueError on weights that no
    packed kernel takes (non-integer, or |w| >= 2^15)."""
    tiled = k6_tiles_per_sm(graph.num_nodes) >= K6_MIN_TILES_PER_SM
    if tiled and _unit_fits(graph, SWEEP_L2_SHARE * l2, sw.word_list_bytes):
        return Plan(False, None)
    wsw.weight_planes(graph)  # raises on weights no packed kernel takes
    return Plan(True, None if tiled else LIST_STAGE_ENTRIES)


def plan_1flip(graph: Graph, l2: int) -> FlipPlan:
    """K5, K8a or K8b for the greedy 1-flip sweep: K5 on {0, +-1} weights
    below `K5_MAX_NEIGHBOURS` neighbours a node where it fits; else K8a from
    `K8A_MIN_NEIGHBOURS` (from `K5_MAX_NEIGHBOURS` on {0, +-1} weights and at
    most `K8A_SMALL_NODES` nodes) while its word entries fit L2; else K8b."""
    n, neighbours = graph.num_nodes, 2 * graph.num_edges
    unit = sw.is_unit_weight(graph)
    if unit and neighbours < K5_MAX_NEIGHBOURS * n and k5_fits(graph):
        return FlipPlan(False, False)
    wsw.weight_planes(graph)  # raises on weights no packed kernel takes
    k8a_from = K5_MAX_NEIGHBOURS if unit and n <= K8A_SMALL_NODES else K8A_MIN_NEIGHBOURS
    return FlipPlan(True, not (neighbours >= k8a_from * n and wsw.word_entry_bytes(graph) <= FLIP_L2_SHARE * l2))


class FusedSweepEngine(NamedTuple):
    """The tables of the chosen sweep kernel and how to call it."""

    tables: Union[sw.PackedSweepTables, wsw.WeightedSweepTables]
    weighted: bool
    node_chunk: Optional[int]

    @staticmethod
    def build(graph: Graph, device=None) -> "FusedSweepEngine":
        dev = resolve_device(device)
        weighted, chunk = plan_sweep(graph, l2_bytes(dev))
        tables = (wsw.WeightedSweepTables if weighted else sw.PackedSweepTables).build(graph, dev)
        return FusedSweepEngine(tables, weighted, chunk)

    def sweep(self, seed: int, bits: torch.Tensor, num_sweeps: int, noise_scale: float = 0.25) -> torch.Tensor:
        """`num_sweeps` noisy sweeps over bits bool [B, N], noise keyed by `seed`."""
        if self.weighted:
            return wsw.mcpg_sweep_weighted_fused(seed, bits, self.tables, num_sweeps, noise_scale, self.node_chunk)
        return sw.mcpg_sweep_fused(seed, bits, self.tables, num_sweeps, noise_scale)


class FlipSweepEngine(NamedTuple):
    """The tables of the chosen 1-flip kernel and how to call it."""

    tables: Union[sw.PackedAdjacency, wsw.WeightedAdjPlanes]
    weighted: bool
    levels: bool

    @staticmethod
    def build(graph: Graph, device=None) -> "FlipSweepEngine":
        dev = resolve_device(device)
        weighted, levels = plan_1flip(graph, l2_bytes(dev))
        tables = wsw.WeightedAdjPlanes.build(graph, dev) if weighted else sw.pack_adjacency(graph, dev)
        return FlipSweepEngine(tables, weighted, levels)

    def sweep(self, bits: torch.Tensor) -> torch.Tensor:
        if self.weighted:
            return wsw.sweep_1flip_weighted(bits, self.tables, self.levels)
        return sw.sweep_1flip_packed(bits, self.tables)
