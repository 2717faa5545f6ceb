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

The 1-flip sweep: K5 when the weights allow it and its planes fit. On other
integer weights both K8a and K8b run one warp a chain; K8a walks the N
nodes in order, its lanes splitting each row's non-zero bit-plane words (a
popcount serves up to 32 neighbours), and K8b walks a level schedule, its
lanes splitting each level's nodes and each lane a node's whole neighbour
list. A step of K8a costs about the same whatever the row's length up to
the 32 x 8 entries its lanes hold, while K8b's work grows with each list
and its schedule's depth; so K8a runs where rows are dense,
`K8A_MIN_NEIGHBOURS` neighbours a node on average or more, and its word
entries fit `FLIP_L2_SHARE` of L2; K8b elsewhere.
`scripts/torch_engine_share.py` timed the two at 768 and 2048 chains
(PERF.md): K8a took 0.69-0.99 ms at N = 2000 from 2 to 200 neighbours a
node, K8b 0.09 ms at 2 and 4.7 ms at 200; K8b was the faster at 60
neighbours (K8a over K8b 1.01 and 1.29), the two split at 70 (0.85 and
1.04), and K8a was the faster from 80 (0.68 and 0.88), 4.8-6.1 times at
200 and 28-29 times at 1000.

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
# The share of L2 that K4's word lists or K5's planes or K8a's word entries
# may take (see above).
SWEEP_L2_SHARE = 0.8
FLIP_L2_SHARE = 0.7
# K8a from this many neighbours a node on average (2 |E| / N), else K8b
# (measured: K8a was the faster at 768 and 2048 chains from 80).
K8A_MIN_NEIGHBOURS = 80
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
    """Whether K4/K5 take the graph: weights in {0, +-1}, and the tables the
    kernel reads (`table_bytes(graph)`) fit."""
    return sw.is_unit_weight(graph) and table_bytes(graph) <= fit_bytes


def _k5_plane_bytes(graph: Graph) -> int:
    """K5's positive plane [N, W], and its negative one on a signed graph."""
    n = graph.num_nodes
    return (2 if (graph.weights < 0).any() else 1) * n * num_words(n) * 4


def plan_sweep(graph: Graph, l2: int) -> Plan:
    """K4, K6 or K7 for the noisy sweeps. ValueError on weights that no
    packed kernel takes (non-integer, or |w| >= 2^15)."""
    tiled = k6_tiles_per_sm(graph.num_nodes) >= K6_MIN_TILES_PER_SM
    if tiled and _unit_fits(graph, SWEEP_L2_SHARE * l2, sw.word_list_bytes):
        return Plan(False, None)
    wsw.weight_planes(graph)  # raises on weights no packed kernel takes
    return Plan(True, None if tiled else LIST_STAGE_ENTRIES)


def plan_1flip(graph: Graph, l2: int) -> FlipPlan:
    """K5, K8a or K8b for the greedy 1-flip sweep."""
    if _unit_fits(graph, FLIP_L2_SHARE * l2, _k5_plane_bytes):
        return FlipPlan(False, False)
    wsw.weight_planes(graph)  # raises on weights no packed kernel takes
    dense = 2 * graph.num_edges >= K8A_MIN_NEIGHBOURS * graph.num_nodes
    return FlipPlan(True, not (dense and wsw.word_entry_bytes(graph) <= FLIP_L2_SHARE * l2))


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
