"""MCPG's degree-ordered sweep and the greedy 1-flip sweep on packed chains
(counterpart of `rlsolver_tpu/ops/pallas/mcpg_sweep.py`).

The degree-ordered sweep (`MCPG.py:120-166` in RLSolver) visits nodes in
descending-degree order and sets x_i to the noisy anti-majority of its
neighbours. In the first sweep processed neighbours count with their bit and
unprocessed ones with 2x - 0.5, so with static masks per step k

  nbr = pc(x & m_proc[k]) + 2 pc(x & m_unproc[k])      (sweep 1)
  nbr = pc(x & m_all[k])                                (later sweeps)

and x_i = (nbr + u16 * ns / 65536 < thr[k] + ns / 2). For {0, +-1}-weight
graphs each mask has a negative-edge plane whose popcount is subtracted.
`PackedSweepTables` keeps JAX's mask planes and, beside them, each step's
list of non-zero mask words, which is all that K4 reads.

  * `mcpg_sweep_packed` (K4, injected noise [S*N, B]): bit-exact with the
    JAX package's `mcpg_sweep_reference` fed the same noise.
  * `mcpg_sweep_fused` (K4, noise from Philox4x32-10 in the kernel: draw
    t = s*N + k of each chain, low 16 bits); the plain version draws the same.
  * `sweep_1flip_packed` (K5): deterministic greedy 1-flip sweep in
    ascending node order, strict improvements only; bit-exact with the f32
    incremental-gain sweep of `MaxcutEnv`. The kernel walks `LevelLists`,
    each node's signed neighbour list in the level schedule that K8b walks,
    from a copy of the whole table in each block's shared memory; the plain
    version walks JAX's packed rows, decoded from the lists, in node order.

On a CUDA tensor each wrapper launches its kernel (`csrc/mcpg_sweep.cu`);
on a CPU tensor it runs the plain PyTorch version. The table builders put
their tensors on `cuda` unless the caller passes `device="cpu"`. On a graph
with other weights they raise ValueError, as the JAX package does; the
dispatch in `engine.py` and `MaxcutEnv` then takes the bit-plane kernels
K6-K8 of `weighted_sweep.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops.kernels import philox
from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, header_constant, register
from rlsolver_tpu_torch.ops.kernels.codec import num_words, pack_bits, unpack_bits

MCPG_SWEEP = register(Kernel(
    "mcpg_sweep", "mcpg_sweep.cu", "mcpg_sweep", "pppppipiufpiiii",
    replaces="rlsolver_tpu/ops/pallas/mcpg_sweep.py:171 _mcpg_sweep_kernel",
))
SWEEP_1FLIP = register(Kernel(
    "sweep_1flip", "mcpg_sweep.cu", "sweep_1flip", "piiiipii",
    replaces="rlsolver_tpu/ops/pallas/mcpg_sweep.py:385 _sweep_1flip_kernel",
))


def is_unit_weight(graph: Graph) -> bool:
    """Whether every weight is in {0, +-1}, the graphs K4 and K5 take."""
    return bool(np.all(np.isin(graph.weights, (-1.0, 0.0, 1.0))))


def _signed_adjacency(graph: Graph) -> np.ndarray:
    if not is_unit_weight(graph):
        raise ValueError("the packed kernels K4/K5 take {0, +-1}-weight graphs only")
    return graph.adjacency_dense()


def _pack_rows(rows: np.ndarray, device) -> torch.Tensor:
    return pack_bits(torch.from_numpy(np.ascontiguousarray(rows))).to(device)


class PackedSweepTables(NamedTuple):
    """Static per-instance tables, in sweep (descending-degree) order.

    masks [P, N, W] int32 holds the planes m_proc, m_unproc, m_all (P = 3),
    each followed by its negative-edge plane on a {0, +-1} graph (P = 6):
    JAX's planes, word for word. K4 reads only their non-zero words, listed
    per step: step k's entries are word_entries[word_offsets[k]:
    word_offsets[k + 1]], one per word index w at which any of the step's
    planes is non-zero, in ascending w. An entry is Q = 1 (Q = 2 on a
    signed graph) quad of int32 {w, m_proc[k, w], m_unproc[k, w],
    m_all[k, w]}, the second quad with the negative planes: 16 or 32 bytes,
    which a warp reads in one or two aligned loads."""

    nodes: torch.Tensor  # [N] int32 node ids in sweep order
    masks: torch.Tensor  # [P, N, W] int32
    thr1: torch.Tensor  # [N] f32 first-sweep thresholds (noise-free)
    thr2: torch.Tensor  # [N] f32 later-sweep thresholds (noise-free)
    word_offsets: torch.Tensor  # [N + 1] int32
    word_entries: torch.Tensor  # [E, Q, 4] int32
    signed: bool

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    def plane(self, name: str, negative: bool = False) -> torch.Tensor:
        """One mask plane: name in ("m_proc", "m_unproc", "m_all")."""
        i = ("m_proc", "m_unproc", "m_all").index(name)
        if negative and not self.signed:
            raise ValueError("an unsigned graph has no negative planes")
        return self.masks[2 * i + negative if self.signed else i]

    @staticmethod
    def build(graph: Graph, device=None) -> "PackedSweepTables":
        device = resolve_device(device)
        n = graph.num_nodes
        adj = _signed_adjacency(graph)
        signed = bool(np.any(adj < 0))
        order = graph.degree_sorted_nodes(descending=True)
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n)
        earlier = pos[None, :] < np.arange(n)[:, None]  # [step, node]

        def planes(a: np.ndarray):
            a_ord = a[order]
            return a_ord & earlier, a_ord & ~earlier, a_ord

        mp, mu, ma = planes(adj > 0)
        u_cnt = mu.sum(axis=1).astype(np.float64)
        rows = [mp, mu, ma]
        if signed:
            mpn, mun, man = planes(adj < 0)
            u_cnt -= mun.sum(axis=1)
            rows = [mp, mpn, mu, mun, ma, man]
        base = graph.weighted_degrees()[order].astype(np.float64) / 2.0
        masks = torch.stack([_pack_rows(r, device) for r in rows]).contiguous()
        word_offsets, word_entries = _word_lists(masks, signed)
        return PackedSweepTables(
            nodes=torch.from_numpy(order.astype(np.int32)).to(device),
            masks=masks,
            thr1=torch.from_numpy((base + 0.5 * u_cnt).astype(np.float32)).to(device),
            thr2=torch.from_numpy(base.astype(np.float32)).to(device),
            word_offsets=word_offsets,
            word_entries=word_entries,
            signed=signed,
        )


def _word_lists(masks: torch.Tensor, signed: bool):
    """The CSR of each step's non-zero words, built where `masks` lies."""
    _, n, w = masks.shape
    q = 2 if signed else 1
    by_kind = masks.view(3, q, n, w)  # [m_proc | m_unproc | m_all, sign, step, word]
    steps, idx = torch.nonzero((masks != 0).any(dim=0), as_tuple=True)  # by step, then ascending word
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=masks.device)
    offsets[1:] = torch.cumsum(torch.bincount(steps, minlength=n), 0)
    vals = by_kind[:, :, steps, idx]  # [3, Q, E]
    entries = torch.cat([idx.to(torch.int32).expand(1, q, -1), vals]).permute(2, 1, 0)
    return offsets, entries.contiguous()


def word_list_bytes(graph: Graph) -> int:
    """The bytes of K4's word lists (`word_offsets`, `word_entries`), from the
    edge list alone: one entry of 16 bytes (32 on a graph with a negative
    weight) per (step, word) at which the step's row has a neighbour, and
    the offsets."""
    n = graph.num_nodes
    keep = graph.weights != 0
    i, j = (graph.edges[keep, c].astype(np.int64) for c in (0, 1))
    rows, cols = np.concatenate([i, j]), np.concatenate([j, i])
    words = np.unique(rows * num_words(n) + (cols >> 5)).size
    return words * 16 * (2 if bool((graph.weights < 0).any()) else 1) + (n + 1) * 4


def word_planes(tables: PackedSweepTables) -> torch.Tensor:
    """The word lists expanded back to mask planes [P, N, W], in the layout
    of `masks` (what the plain version reads, and the tests compare)."""
    n, w = tables.num_nodes, num_words(tables.num_nodes)
    q = 2 if tables.signed else 1
    off = tables.word_offsets.long()
    steps = torch.repeat_interleave(torch.arange(n, device=off.device), off[1:] - off[:-1])
    idx = tables.word_entries[:, 0, 0].long()
    planes = torch.zeros(3, q, n, w, dtype=torch.int32, device=off.device)
    planes[:, :, steps, idx] = tables.word_entries[:, :, 1:].permute(2, 1, 0)
    return planes.reshape(3 * q, n, w)


def _sweep_plain(tables, words, n, num_sweeps, noise_scale, noise_u16, seed):
    """Plain version of the K4 kernel on unpacked f32 bits, fed the word
    lists that K4 reads. nbr is linear in x, so each step's popcounts fold
    into one row of an f32 matrix: C1 = m_proc + 2 m_unproc and C2 = m_all
    (minus the negative planes)."""
    planes = word_planes(tables)
    m = unpack_bits(planes.reshape(-1, planes.shape[-1]), n).reshape(planes.shape[0], n, n).to(torch.float32)
    if tables.signed:
        m = m[0::2] - m[1::2]
    return sweep_steps_plain(m[0] + 2.0 * m[1], m[2], tables, words, n, num_sweeps, noise_scale, noise_u16, seed)


def sweep_steps_plain(c1, c2, tables, words, n, num_sweeps, noise_scale, noise_u16, seed):
    """The step loop of the plain sweeps (K4, K6, K7): nbr = x @ C1[k] in the
    first sweep and x @ C2[k] after it, rows in sweep order; f32 sums of
    integers, exact below 2^24 as in the JAX twin. `tables` gives nodes and
    thresholds. Noise from `noise_u16` [S*N, B] or, when it is None, draw
    t = s*N + k of each chain from Philox under `seed`."""
    x = unpack_bits(words, n).to(torch.float32)
    thr1, thr2 = _noisy_thresholds(tables, noise_scale)
    scale = torch.tensor(noise_scale / 65536.0, dtype=torch.float32, device=x.device)
    chains = torch.arange(x.shape[0], device=x.device)
    nodes = tables.nodes.long()
    for sk in range(num_sweeps * n):
        k = sk % n
        nbr = x @ (c1[k] if sk < n else c2[k])
        if noise_u16 is not None:
            u16 = noise_u16[sk]
        else:
            if sk % 4 == 0:
                block = philox.philox_block(seed, philox.TAG_SWEEP, sk >> 2, chains)
            u16 = block[sk & 3] & 0xFFFF
        new_bit = (nbr + u16.to(torch.float32) * scale) < (thr1 if sk < n else thr2)[k]
        x[:, nodes[k]] = new_bit.to(torch.float32)
    return pack_bits(x > 0.5)


def _noisy_thresholds(tables: PackedSweepTables, noise_scale: float):
    half = torch.tensor(noise_scale / 2.0, dtype=torch.float32, device=tables.thr1.device)
    return tables.thr1 + half, tables.thr2 + half


def _sweep(bits, tables, num_sweeps, noise_scale, noise_u16, seed):
    b, n = bits.shape
    if n != tables.num_nodes:
        raise ValueError(f"bits have {n} nodes, tables built for {tables.num_nodes}")
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(_sweep_plain(tables, words, n, num_sweeps, noise_scale, noise_u16, seed), n)
    w = num_words(n)
    q = 2 if tables.signed else 1
    check_cuda_tensor(tables.word_offsets, "word_offsets", torch.int32, (n + 1,))
    check_cuda_tensor(tables.word_entries, "word_entries", torch.int32, (tables.word_entries.shape[0], q, 4))
    if tables.word_entries.data_ptr() % 16:
        raise ValueError("word_entries must be 16-byte aligned (the kernel reads an entry in one 16-byte load)")
    check_cuda_tensor(tables.nodes, "nodes", torch.int32, (n,))
    thr1, thr2 = _noisy_thresholds(tables, noise_scale)
    if noise_u16 is not None:
        check_cuda_tensor(noise_u16, "noise_u16", torch.int32, (num_sweeps * n, b))
    MCPG_SWEEP.launch(
        tables.nodes, thr1, thr2, tables.word_offsets, tables.word_entries, int(tables.signed), noise_u16,
        int(noise_u16 is None), seed & 0xFFFFFFFF, noise_scale / 65536.0,
        words, b, w, n, num_sweeps,
    )
    return unpack_bits(words, n)


def mcpg_sweep_packed(
    noise_u16: torch.Tensor,
    bits: torch.Tensor,
    tables: PackedSweepTables,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> torch.Tensor:
    """Injected-noise sweeps. noise_u16: int32 in [0, 65536) of shape
    [num_sweeps * N, B]; bits: bool [B, N] -> bool [B, N]."""
    return _sweep(bits, tables, num_sweeps, noise_scale, noise_u16, 0)


def mcpg_sweep_fused(
    seed: int,
    bits: torch.Tensor,
    tables: PackedSweepTables,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> torch.Tensor:
    """Sweeps with noise drawn in the kernel, keyed by `seed`."""
    return _sweep(bits, tables, num_sweeps, noise_scale, None, seed)


# K5's list entries hold a node id in 15 bits and the sign in the 16th
# (its records hold the id in 16), so K5 takes graphs of at most 2^15 nodes.
K5_MAX_NODES = 1 << 15


def _unit_entries(graph: Graph):
    """(rows, cols, negative) int64/bool numpy of every non-zero weight of a
    {0, +-1} graph, each edge in both directions, sorted by (row, col)."""
    if not is_unit_weight(graph):
        raise ValueError("the packed kernels K4/K5 take {0, +-1}-weight graphs only")
    keep = graph.weights != 0
    i, j = (graph.edges[keep, c].astype(np.int64) for c in (0, 1))
    neg = graph.weights[keep] < 0
    rows, cols, neg = np.concatenate([i, j]), np.concatenate([j, i]), np.concatenate([neg, neg])
    order = np.argsort(rows * graph.num_nodes + cols, kind="stable")
    return rows[order], cols[order], neg[order]


def level_table_layout(depth: int, positions: int, entries: int):
    """(record offset, entry offset, table bytes) of K5's table: the level
    offsets [D + 1] int32, padded to 8 bytes; the records [V + 1] of 8
    bytes; the 2-byte list entries; the whole padded to 16 bytes."""
    record = 4 * (depth + 1 + (depth + 1) % 2)
    entry = record + 8 * (positions + 1)
    return record, entry, -(-(entry + 2 * entries) // 16) * 16


def level_table_bytes(graph: Graph) -> int:
    """The most bytes K5's table can take, from the edge list alone: the
    schedule's depth is counted as its most, one level a node."""
    rows, _, _ = _unit_entries(graph)
    v = np.unique(rows).size
    return level_table_layout(v, v, rows.size)[2]


class LevelLists(NamedTuple):
    """K5's table: the natural-order neighbour lists of a {0, +-1} graph in
    the level schedule that K8b walks (`weighted_sweep.level_schedule`), as
    one int32 blob that the kernel copies whole into shared memory.

    A node without neighbours never flips (its cut and weighted degree are
    0), so the schedule holds the V nodes that have one. Position v of the
    schedule (by level, then id) has the record {start_v, i | wdeg_i << 16}:
    its node i, the start of its list (it ends where position v + 1's
    starts; record V is {E, 0}) and wdeg_i = deg+_i - deg-_i. Level d is
    positions level_offsets[d]:level_offsets[d + 1]. Node i's list holds one
    2-byte entry per neighbour j, ascending j, {sign << 15 | j}, sign = 1 for
    weight -1. No weight is stored."""

    table: torch.Tensor  # [table bytes / 4] int32
    num_nodes: int  # N
    depth: int  # D, levels
    positions: int  # V, nodes with a neighbour
    num_entries: int  # E

    @property
    def layout(self):
        return level_table_layout(self.depth, self.positions, self.num_entries)

    @property
    def table_bytes(self) -> int:
        return self.layout[2]

    @property
    def level_offsets(self) -> torch.Tensor:
        return self.table[: self.depth + 1]

    @property
    def records(self) -> torch.Tensor:
        """[V + 1, 2] int32 {start, node | wdeg << 16}."""
        r = self.layout[0] // 4
        return self.table[r : r + 2 * (self.positions + 1)].view(-1, 2)

    @property
    def entries(self) -> torch.Tensor:
        """[E] int16: the sign is the top bit."""
        e = self.layout[1] // 4
        return self.table[e : e + -(-self.num_entries // 2)].view(torch.int16)[: self.num_entries]

    def signed_rows(self):
        """(i, j, negative) of every entry, as the lists hold them: long,
        long, bool [E] on the table's device."""
        rec = self.records.long()
        nodes = torch.repeat_interleave(rec[:-1, 1] & 0xFFFF, rec[1:, 0] - rec[:-1, 0])
        ent = self.entries.long() & 0xFFFF
        return nodes, ent & 0x7FFF, (ent >> 15).bool()

    @staticmethod
    def build(graph: Graph, device=None) -> "LevelLists":
        """From the edge list, with no [N, N] matrix."""
        from rlsolver_tpu_torch.ops.kernels.weighted_sweep import level_schedule  # imports this module

        device = resolve_device(device)
        n = graph.num_nodes
        if n > K5_MAX_NODES:
            raise ValueError(f"K5's 2-byte entries hold node ids below {K5_MAX_NODES}; the graph has {n} nodes")
        rows, cols, neg = _unit_entries(graph)
        offsets = np.zeros(n + 1, np.int64)
        offsets[1:] = np.cumsum(np.bincount(rows, minlength=n))
        level_nodes, level_offsets = level_schedule(offsets, cols)
        deg = np.diff(offsets)
        active = deg[level_nodes] > 0  # nodes without neighbours sit in level 0 and never flip
        nodes = level_nodes[active].astype(np.int64)
        level_offsets = np.maximum(level_offsets.astype(np.int64) - (~active).sum(), 0)
        depth = 0 if nodes.size == 0 else level_offsets.size - 1
        level_offsets = level_offsets[: depth + 1]
        wdeg = np.zeros(n, np.int64)
        np.add.at(wdeg, rows, np.where(neg, -1, 1))
        lens = deg[nodes]
        starts = np.zeros(nodes.size + 1, np.int64)
        starts[1:] = np.cumsum(lens)
        # each node's list, in schedule order: entries offsets[i]:offsets[i + 1]
        src = np.repeat(offsets[nodes] - starts[:-1], lens) + np.arange(starts[-1])
        ent = cols[src] | (neg[src].astype(np.int64) << 15)
        record, entry, nbytes = level_table_layout(depth, nodes.size, ent.size)
        blob = np.zeros(nbytes, np.uint8)
        blob[: 4 * (depth + 1)] = level_offsets.astype("<i4").view(np.uint8)
        rec = np.zeros((nodes.size + 1, 2), np.int64)
        rec[:, 0] = starts
        rec[:-1, 1] = nodes | (wdeg[nodes] << 16)
        blob[record:entry] = (rec & 0xFFFFFFFF).astype("<u4").view(np.uint8).reshape(-1)
        blob[entry : entry + 2 * ent.size] = ent.astype("<u2").view(np.uint8)
        table = torch.from_numpy(blob.view("<i4").copy()).to(device)
        return LevelLists(table, n, depth, int(nodes.size), int(ent.size))


class PackedAdjacency(NamedTuple):
    """The tables of K5 on a {0, +-1}-weight graph: its level lists, which
    are all the kernel reads. JAX's packed row planes [N, W] in natural node
    order and the per-row counts, which the plain version reads, are decoded
    from the lists where they are asked for (`pos`, `neg`, `deg_pos`,
    `deg_neg`; `neg` and `deg_neg` are None on a graph with no -1 weight)."""

    levels: LevelLists

    def _plane(self, negative: bool) -> torch.Tensor:
        n, w = self.levels.num_nodes, num_words(self.levels.num_nodes)
        i, j, neg = self.levels.signed_rows()
        keep = neg == negative
        i, j = i[keep], j[keep]
        # disjoint powers of two (bit 31 is -2^31): the int32 sum is the OR
        bits = torch.ones_like(j, dtype=torch.int32) << (j & 31).to(torch.int32)
        return torch.zeros(n * w, dtype=torch.int32, device=j.device).index_add_(0, i * w + (j >> 5), bits).view(n, w)

    def _count(self, negative: bool) -> torch.Tensor:
        i, _, neg = self.levels.signed_rows()
        return torch.bincount(i[neg == negative], minlength=self.levels.num_nodes).to(torch.int32)

    @property
    def signed(self) -> bool:
        return bool(self.levels.signed_rows()[2].any())

    @property
    def pos(self) -> torch.Tensor:  # [N, W] int32
        return self._plane(False)

    @property
    def neg(self) -> Optional[torch.Tensor]:  # [N, W] int32 or None
        return self._plane(True) if self.signed else None

    @property
    def deg_pos(self) -> torch.Tensor:  # [N] int32 number of +1 neighbours
        return self._count(False)

    @property
    def deg_neg(self) -> Optional[torch.Tensor]:  # [N] int32 number of -1 neighbours
        return self._count(True) if self.signed else None


def pack_adjacency(graph: Graph, device=None) -> PackedAdjacency:
    return PackedAdjacency(LevelLists.build(graph, device))


def _sweep_1flip_plain(x: torch.Tensor, adj: PackedAdjacency) -> torch.Tensor:
    """Plain version of the K5 kernel on bool [B, N]: the sequential sweep
    in node order over JAX's packed rows (integer popcounts)."""
    n = x.shape[1]
    x = x.clone()
    pos, deg_pos = unpack_bits(adj.pos, n), adj.deg_pos.long()
    signed = adj.signed
    neg, deg_neg = (unpack_bits(adj.neg, n), adj.deg_neg.long()) if signed else (None, None)
    for i in range(n):
        cur = x[:, i]
        p = (x & pos[i]).sum(dim=1)
        deg = deg_pos[i]
        cut = torch.where(cur, deg - p, p)
        wdeg = deg
        if signed:
            pn = (x & neg[i]).sum(dim=1)
            degn = deg_neg[i]
            cut = cut - torch.where(cur, degn - pn, pn)
            wdeg = deg - degn
        x[:, i] = cur ^ (wdeg - 2 * cut > 0)
    return x


def level_smem_bytes(table_bytes: int, n: int) -> int:
    """Shared memory of a K5 block of one chain: its barrier, the table and
    the chain's words (csrc/mcpg_sweep.cu)."""
    return 16 + table_bytes + (num_words(n) | 1) * 4


def sweep_1flip_packed(bits: torch.Tensor, adj: PackedAdjacency) -> torch.Tensor:
    """Greedy sequential 1-flip sweep. bits bool [B, N] -> bool [B, N]."""
    b, n = bits.shape
    lv = adj.levels
    if n != lv.num_nodes:
        raise ValueError(f"bits have {n} nodes, tables built for {lv.num_nodes}")
    if not bits.is_cuda:
        return _sweep_1flip_plain(bits.bool(), adj)
    check_cuda_tensor(lv.table, "levels.table", torch.int32, (lv.table_bytes // 4,))
    if lv.table.data_ptr() % 16:
        raise ValueError("levels.table must be 16-byte aligned (the kernel copies it in bulk)")
    if level_smem_bytes(lv.table_bytes, n) > header_constant("kMaxSmem"):
        raise ValueError(f"K5's table of {lv.table_bytes} bytes and a chain of {n} nodes do not fit a block's "
                         "shared memory")
    words = pack_bits(bits)
    record, entry, nbytes = lv.layout
    SWEEP_1FLIP.launch(lv.table, nbytes, lv.depth, record, entry, words, b, num_words(n))
    return unpack_bits(words, n)
