"""Which packed kernel runs a graph's sweeps (counterpart of
`rlsolver_tpu/ops/pallas/engine.py:FusedSweepEngine`, and of the 1-flip
dispatch in `rlsolver_tpu/envs/maxcut.py:68-100`).

The JAX package's order stays: the {0, +-1} kernels K4/K5 when the weights
allow them and their tables fit, else the bit-plane kernels with the tables
read in place (K6/K8a) when they fit, else the node-chunked ones (K7/K8b).
What "fit" means is re-derived for the card: the JAX package asked whether
the tables fit the TPU core's 16 MB of VMEM; here the test is the tables'
bytes against a share of the card's L2, one for the sweeps and one for the
1-flip sweep (`SWEEP_L2_SHARE`, `FLIP_L2_SHARE`).

The shares are not a speed rule. `scripts/torch_engine_share.py` found the
in-place kernels slower than the chunked ones at every table size and chain
count it measured on the H100 (1.2-2.1 times with the tables in L2,
2.2-2.4 times past it; PERF.md), so there is no share up to which reading in
place wins. The shares keep the in-place tier on the path that the
three-way order gives it, and off tables past the L2 cliff: each is the
largest measured share at which the in-place kernel took under twice the
chunked one's time, rounded down to a tenth. That criterion was chosen after the first one (the
in-place kernel no slower) had found no share at all. Whether to drop the
tier, or to stage K6/K8a as well, is open (ROADMAP.md).

The node chunk of K7/K8b is measured too: a block holds a tile of 128
chains and two stages of `chunk` rows of every plane, and the fastest chunk
at each size was the largest of those that let the most blocks share an SM.

The rule reads only sizes and the weights' bit-planes, so `plan_sweep` and
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
# The share of L2 that an in-place kernel's tables may take (see above).
SWEEP_L2_SHARE = 0.8
FLIP_L2_SHARE = 0.7
# H100 (compute capability 9.0, CUDA C++ Programming Guide): 228 KB of
# shared memory per SM, of which the runtime keeps 1 KB per resident block.
H100_SMEM_PER_SM = 233_472
H100_SMEM_RESERVED_PER_BLOCK = 1_024
# Rows per stage at most: beyond 8, with as many blocks per SM, a stage
# gained under 1% (PERF.md).
MAX_CHUNK = 8


def l2_bytes(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).L2_cache_size
    return H100_L2_BYTES


def pick_node_chunk(n: int, n_planes: int) -> int:
    """Rows per stage of K7/K8b. Of the chunks whose two stages of
    [n_planes, chunk, W] words fit beside a full tile of chains in a block's
    shared memory (the limits of csrc/common.cuh), the largest of those that
    let the most blocks share an SM; 1 when none fits (the kernel then fits
    fewer chains)."""
    w = num_words(n)
    tile = build.header_constant("kChainsPerBlock") * (w | 1) * 4

    def smem(c):
        return tile + 2 * n_planes * c * w * 4

    fits = [c for c in range(1, min(n, MAX_CHUNK) + 1) if smem(c) <= build.header_constant("kMaxSmem")]
    if not fits:
        return 1
    return max(fits, key=lambda c: (H100_SMEM_PER_SM // (smem(c) + H100_SMEM_RESERVED_PER_BLOCK), c))


class Plan(NamedTuple):
    weighted: bool  # bit-plane kernels (K6-K8) rather than K4/K5
    node_chunk: Optional[int]  # None: tables read in place


def _plan(graph: Graph, fit_bytes: float, unit_planes: int, bit_planes) -> Plan:
    """K4/K5 (`unit_planes` [N, W] planes, signed) when the weights are in
    {0, +-1} and they fit, else the bit-plane kernel (`bit_planes(k, signed)`
    planes) in place when it fits, else node-chunked."""
    n = graph.num_nodes
    plane_bytes = n * num_words(n) * 4
    signed = bool((graph.weights < 0).any())
    if sw.is_unit_weight(graph) and unit_planes * (2 if signed else 1) * plane_bytes <= fit_bytes:
        return Plan(False, None)
    p = bit_planes(*wsw.weight_planes(graph))
    return Plan(True, None if p * plane_bytes <= fit_bytes else pick_node_chunk(n, p))


def plan_sweep(graph: Graph, l2: int) -> Plan:
    """K4, K6 or K7 for the noisy sweeps. ValueError on weights that no
    packed kernel takes (non-integer, or |w| >= 2^15)."""
    return _plan(graph, SWEEP_L2_SHARE * l2, 3, wsw.num_sweep_planes)


def plan_1flip(graph: Graph, l2: int) -> Plan:
    """K5, K8a or K8b for the greedy 1-flip sweep, by the same rule."""
    return _plan(graph, FLIP_L2_SHARE * l2, 1, lambda k, signed: k * (2 if signed else 1))


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
    node_chunk: Optional[int]

    @staticmethod
    def build(graph: Graph, device=None) -> "FlipSweepEngine":
        dev = resolve_device(device)
        weighted, chunk = plan_1flip(graph, l2_bytes(dev))
        tables = wsw.WeightedAdjPlanes.build(graph, dev) if weighted else sw.pack_adjacency(graph, dev)
        return FlipSweepEngine(tables, weighted, chunk)

    def sweep(self, bits: torch.Tensor) -> torch.Tensor:
        if self.weighted:
            return wsw.sweep_1flip_weighted(bits, self.tables, self.node_chunk)
        return sw.sweep_1flip_packed(bits, self.tables)
