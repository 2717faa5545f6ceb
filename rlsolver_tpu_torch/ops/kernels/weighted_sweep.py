"""MCPG's degree-ordered sweep and the greedy 1-flip sweep for general integer
weights (counterpart of `rlsolver_tpu/ops/pallas/weighted_sweep.py`).

The JAX package splits an integer weight |w| < 2^15 into k =
bit_length(max |w|) binary planes, so that a weighted neighbour sum is a
small static sum of popcounts,

  nbr = sum_b 2^b (pc(x & pos_b[k]) - pc(x & neg_b[k])),

with the negative planes present only when some weight is below zero; the
first sweep's mixed domain (processed neighbours count with their bit,
unprocessed ones with 2x - 0.5) needs one more plane, `earlier[k]` (bit j
set iff node j precedes step k in sweep order): proc + 2 unproc =
2 pc(x & m) - pc(x & m & earlier), per plane. `WeightedSweepTables` keeps
those planes, word for word JAX's, and beside them each step's neighbour
list, from which the port's sweeps compute the same integer:

  nbr = sum over the list of c * x_j,  c = w (later sweeps),
        c = w if j precedes step k else 2w (first sweep).

  * `mcpg_sweep_weighted` (injected noise [S*N, B]) and
    `mcpg_sweep_weighted_fused` (Philox4x32-10 in the kernel: draw
    t = s*N + k of each chain, low 16 bits, as in K4): K6 with a block's
    chains in shared memory, or, with `node_chunk`, K7 with the chains in
    device memory and the lists staged in shared memory `node_chunk` entries
    at a time. Both give the same bits, and on a {0, +-1} graph K4's bits
    for the same noise or seed.
  * `sweep_1flip_weighted`: the greedy 1-flip sweep in ascending node order,
    strict improvements only: K8a on each row's non-zero bit-plane words
    (`WeightedAdjPlanes.word_entries`), one warp a chain, or with `levels`
    K8b on its neighbour lists, level by level of a
    schedule in which no two nodes of a level are adjacent and every earlier
    neighbour lies in a lower level, so that the bits are the sequential
    sweep's; bit-exact with the f32 incremental-gain sweep of `MaxcutEnv`.

On a CUDA tensor each wrapper launches its kernel (`csrc/weighted_sweep.cu`);
on a CPU tensor it runs the plain PyTorch version. The tables' `build`
methods put their tensors on `cuda` unless the caller passes `device="cpu"`,
and raise ValueError on weights that are not integers below 2^15 in magnitude.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register
from rlsolver_tpu_torch.ops.kernels.codec import num_words, pack_bits, unpack_bits
from rlsolver_tpu_torch.ops.kernels.mcpg_sweep import _noisy_thresholds, sweep_steps_plain

_WT = "rlsolver_tpu/ops/pallas/weighted_sweep.py"
WSWEEP = register(Kernel(
    "mcpg_sweep_weighted", "weighted_sweep.cu", "wsweep", "ppppppiufpiiii",
    replaces=f"{_WT}:155 _wsweep_kernel",
))
WSWEEP_CHUNKED = register(Kernel(
    "mcpg_sweep_weighted_chunked", "weighted_sweep.cu", "wsweep_chunked", "ppppppiufpiiiii",
    replaces=f"{_WT}:497 _wsweep_chunked_kernel",
))
WSWEEP_1FLIP = register(Kernel(
    "sweep_1flip_weighted", "weighted_sweep.cu", "wsweep_1flip", "pppipiii",
    replaces=f"{_WT}:394 _wsweep_1flip_kernel",
))
WSWEEP_1FLIP_LEVELS = register(Kernel(
    "sweep_1flip_weighted_levels", "weighted_sweep.cu", "wsweep_1flip_levels", "ppppppiii",
    replaces=f"{_WT}:645 _wsweep_1flip_chunked_kernel",
))

MAX_ABS_WEIGHT = 1 << 15  # k <= 15 planes; the kernels are built for k = 1..15


def weight_fault(weights: np.ndarray) -> Optional[str]:
    """Why no packed kernel takes these edge weights, or None where one
    does (integers, 0 < max |w| < 2^15)."""
    w = np.asarray(weights, np.float64)
    if not np.array_equal(w, np.rint(w)):
        return "weighted packed sweep requires integer edge weights"
    w_max = int(np.abs(w).max()) if w.size else 0
    if w_max >= MAX_ABS_WEIGHT:
        return f"|weight| must be < {MAX_ABS_WEIGHT}, got {w_max}"
    return "graph has no edges" if w_max == 0 else None


def _max_abs_weight(weights: np.ndarray) -> int:
    """max |w| of integer weights; ValueError otherwise (as the JAX package)."""
    fault = weight_fault(weights)
    if fault is not None:
        raise ValueError(fault)
    return int(np.abs(np.asarray(weights, np.float64)).max())


def weight_planes(graph: Graph) -> Tuple[int, bool]:
    """(k, signed): the number of bit-planes and whether negative planes are
    needed, from the edge weights alone (no tables are built)."""
    return _max_abs_weight(graph.weights).bit_length(), bool((graph.weights < 0).any())


def _adjacency_entries(graph: Graph, device):
    """(rows, cols, w) int64 on `device`: every non-zero entry of the integer
    adjacency, each edge in both directions (no [N, N] matrix is built).
    ValueError on weights that no packed kernel takes."""
    _max_abs_weight(graph.weights)
    n = graph.num_nodes
    i, j = (torch.from_numpy(graph.edges[:, c].astype(np.int64)).to(device) for c in (0, 1))
    w = torch.from_numpy(np.rint(graph.weights).astype(np.int64)).to(device)
    rows, cols, w = torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w])
    keep = w != 0
    return rows[keep], cols[keep], w[keep]


def _csr(rows, cols, w, n: int):
    """The entries sorted by (row, col), and the rows' offsets [N + 1]."""
    order = torch.argsort(rows * n + cols)
    rows, cols, w = rows[order], cols[order], w[order]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return rows, cols, w, offsets


def _bit_planes(rows, cols, w, n: int, k: int, signed: bool) -> torch.Tensor:
    """The signed bit-planes [k (+k), N, W] of the entries (rows, cols, w):
    positive planes b = 0..k-1, then the negative ones on a signed graph,
    packed as `pack_bits` packs (node j in word j >> 5, bit j & 31). Each bit
    is set once, so an add of 2^(j & 31) into its word is an OR."""
    wn = num_words(n)
    word = rows * wn + (cols >> 5)
    bit = torch.ones_like(cols) << (cols & 31)
    planes = []
    for sign in (1, -1) if signed else (1,):
        for b in range(k):
            sel = (torch.sign(w) == sign) & (((w.abs() >> b) & 1) == 1)
            planes.append(torch.zeros(n * wn, dtype=torch.int64, device=w.device).index_add_(0, word[sel], bit[sel]))
    p = torch.stack(planes).view(len(planes), n, wn)
    return torch.where(p >= 1 << 31, p - (1 << 32), p).to(torch.int32)  # the uint32 words as int32


class WeightedSweepTables(NamedTuple):
    """Static tables of the weighted sweep, rows in sweep (descending-degree)
    order. planes [P, N, W] int32: `earlier`, the k positive planes, then the
    k negative planes on a graph with negative weights (P = 1 + k or 1 + 2k),
    JAX's layout. The sweeps read the neighbour lists: step k's entries are
    entries[offsets[k]:offsets[k + 1]], one {j, (w << 1) | earlier} per
    neighbour j of nodes[k] with weight w, in ascending j. The thresholds are
    the JAX package's (noise-free, f32)."""

    nodes: torch.Tensor  # [N] int32 node ids in sweep order
    thr1: torch.Tensor  # [N] f32 first-sweep thresholds (incl. +0.5 * U_k)
    thr2: torch.Tensor  # [N] f32 later-sweep thresholds
    planes: torch.Tensor  # [P, N, W] int32
    offsets: torch.Tensor  # [N + 1] int32 CSR row offsets of the lists
    entries: torch.Tensor  # [E, 2] int32 {j, (w << 1) | earlier}
    k: int
    signed: bool

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def earlier(self) -> torch.Tensor:
        return self.planes[0]

    @property
    def planes_pos(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[1 : 1 + self.k])

    @property
    def planes_neg(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[1 + self.k :])

    @staticmethod
    def build(graph: Graph, device=None) -> "WeightedSweepTables":
        device = resolve_device(device)
        k, signed = weight_planes(graph)
        n = graph.num_nodes
        order = graph.degree_sorted_nodes(descending=True).astype(np.int64)
        order_t = torch.from_numpy(order).to(device)
        pos_of = torch.empty_like(order_t)
        pos_of[order_t] = torch.arange(n, device=device)
        nodes, nbrs, w = _adjacency_entries(graph, device)
        steps, nbrs, w, offsets = _csr(pos_of[nodes], nbrs, w, n)  # by step, then ascending j
        early = pos_of[nbrs] < steps  # j precedes step k in sweep order
        u_cnt = torch.zeros(n, dtype=torch.int64, device=device).index_add_(0, steps, w * ~early)
        wdeg = graph.weighted_degrees()[order].astype(np.float64)
        earlier = pos_of[None, :] < torch.arange(n, device=device)[:, None]
        return WeightedSweepTables(
            nodes=order_t.to(torch.int32),
            thr1=torch.from_numpy((wdeg / 2.0 + 0.5 * u_cnt.cpu().numpy()).astype(np.float32)).to(device),
            thr2=torch.from_numpy((wdeg / 2.0).astype(np.float32)).to(device),
            planes=torch.cat([pack_bits(earlier)[None], _bit_planes(steps, nbrs, w, n, k, signed)]),
            offsets=offsets.to(torch.int32),
            entries=torch.stack([nbrs, w * 2 + early], dim=1).to(torch.int32).contiguous(),
            k=k,
            signed=signed,
        )


def list_coefficients(tables: WeightedSweepTables, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lists as dense [N steps, N nodes] coefficients: C1 of the first
    sweep (w for an earlier neighbour, 2w for a later one) and C2 = w."""
    n = tables.num_nodes
    off = tables.offsets.long()
    rows = torch.repeat_interleave(torch.arange(n, device=off.device), off[1:] - off[:-1])
    j, meta = tables.entries[:, 0].long(), tables.entries[:, 1]
    w = (meta >> 1).to(dtype)
    c1 = torch.zeros(n, n, dtype=dtype, device=off.device)
    c2 = torch.zeros(n, n, dtype=dtype, device=off.device)
    c1[rows, j] = w * (2 - (meta & 1)).to(dtype)
    c2[rows, j] = w
    return c1, c2


def _check_chunk(node_chunk: Optional[int]) -> None:
    if node_chunk is not None and node_chunk < 1:
        raise ValueError(f"node_chunk must be a positive number of list entries, got {node_chunk}")


def _wsweep_plain(tables, words, n, num_sweeps, noise_scale, noise_u16, seed):
    """Plain version of K6/K7 (one function; the kernels differ only in where
    the chains live): the lists' C1 and C2 feed K4's plain step loop."""
    c1, c2 = list_coefficients(tables)
    return sweep_steps_plain(c1, c2, tables, words, n, num_sweeps, noise_scale, noise_u16, seed)


def launch_sweep(tables, words, thr1, thr2, noise_u16, seed, noise_scale, num_sweeps, node_chunk):
    """Runs K6 on words [B, W] in place, or with `node_chunk` K7, which takes
    the chains chain-minor: the transposes to [W, B] and back are part of
    it. Returns the swept words [B, W]."""
    b, w = words.shape
    n = tables.num_nodes
    args = (tables.nodes, thr1, thr2, tables.offsets, tables.entries, noise_u16, int(noise_u16 is None),
            seed & 0xFFFFFFFF, noise_scale / 65536.0)
    if node_chunk is None:
        WSWEEP.launch(*args, words, b, w, n, num_sweeps)
        return words
    cols = words.t().contiguous()
    WSWEEP_CHUNKED.launch(*args, cols, b, w, n, num_sweeps, node_chunk)
    return cols.t().contiguous()


def _sweep(bits, tables, num_sweeps, noise_scale, noise_u16, seed, node_chunk):
    b, n = bits.shape
    if n != tables.num_nodes:
        raise ValueError(f"bits have {n} nodes, tables built for {tables.num_nodes}")
    _check_chunk(node_chunk)
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(_wsweep_plain(tables, words, n, num_sweeps, noise_scale, noise_u16, seed), n)
    check_cuda_tensor(tables.nodes, "nodes", torch.int32, (n,))
    check_cuda_tensor(tables.offsets, "offsets", torch.int32, (n + 1,))
    check_cuda_tensor(tables.entries, "entries", torch.int32, (tables.entries.shape[0], 2))
    if tables.entries.data_ptr() % 16:
        raise ValueError("entries must be 16-byte aligned (the kernel reads two entries at a time)")
    thr1, thr2 = _noisy_thresholds(tables, noise_scale)
    if noise_u16 is not None:
        check_cuda_tensor(noise_u16, "noise_u16", torch.int32, (num_sweeps * n, b))
    words = launch_sweep(tables, words, thr1, thr2, noise_u16, seed, noise_scale, num_sweeps, node_chunk)
    return unpack_bits(words, n)


def mcpg_sweep_weighted(
    noise_u16: torch.Tensor,
    bits: torch.Tensor,
    tables: WeightedSweepTables,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
    node_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Injected-noise sweeps. noise_u16: int32 in [0, 65536) of shape
    [num_sweeps * N, B]; bits: bool [B, N] -> bool [B, N]. `node_chunk`
    (list entries staged at a time) selects K7 over K6."""
    return _sweep(bits, tables, num_sweeps, noise_scale, noise_u16, 0, node_chunk)


def mcpg_sweep_weighted_fused(
    seed: int,
    bits: torch.Tensor,
    tables: WeightedSweepTables,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
    node_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Sweeps with noise drawn in the kernel, keyed by `seed`."""
    return _sweep(bits, tables, num_sweeps, noise_scale, None, seed, node_chunk)


class WeightedAdjPlanes(NamedTuple):
    """Integer adjacency in natural node order, for the greedy 1-flip sweep.

    planes [k (+k), N, W] int32: the signed bit-planes, positive then
    negative, JAX's layout. K8a reads only their non-zero words: row i's
    entries are word_entries[word_offsets[i]:word_offsets[i + 1]], one
    {(c << 16) | w, planes[p, i, w]} per non-zero word, ordered by (w, p),
    with c plane p's signed weight, +2^p for p < k and -2^(p - k) beyond;
    one empty entry {0, 0} follows the last row's. offsets [N + 1] and
    entries [E, 2] int32: node i's neighbours are entries[offsets[i]:
    offsets[i + 1]], one {j, w_ij} per neighbour, ascending j, which K8b
    reads with the level schedule: node i's level is 1 + the largest level
    of its neighbours j < i (0 when it has none); level_nodes [N] holds the
    node ids sorted by (level, id), and level d's nodes are level_nodes[
    level_offsets[d]:level_offsets[d + 1]]. wdeg: the integer weighted
    degree of every node, computed once here as K5's per-row degrees are,
    not popcounted again for every chain."""

    planes: torch.Tensor  # [k or 2k, N, W] int32
    wdeg: torch.Tensor  # [N] int32 sum_j w_ij
    word_offsets: torch.Tensor  # [N + 1] int32 CSR row offsets of the word entries
    word_entries: torch.Tensor  # [E' + 1, 2] int32 {(c << 16) | w, mask}, then {0, 0}
    offsets: torch.Tensor  # [N + 1] int32 CSR row offsets of the lists
    entries: torch.Tensor  # [E, 2] int32 {j, w}
    level_nodes: torch.Tensor  # [N] int32
    level_offsets: torch.Tensor  # [D + 1] int32
    k: int
    signed: bool

    @property
    def num_nodes(self) -> int:
        return self.planes.shape[1]

    @property
    def depth(self) -> int:
        """D, the number of levels of the schedule."""
        return self.level_offsets.shape[0] - 1

    @property
    def planes_pos(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[: self.k])

    @property
    def planes_neg(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[self.k :])

    @staticmethod
    def build(graph: Graph, device=None) -> "WeightedAdjPlanes":
        """Built from the edge list on `device`, with no [N, N] matrix (the
        schedule on the host: one pass over the nodes in order)."""
        device = resolve_device(device)
        k, signed = weight_planes(graph)
        n = graph.num_nodes
        rows, cols, w, offsets = _csr(*_adjacency_entries(graph, device), n)
        level_nodes, level_offsets = level_schedule(offsets.cpu().numpy(), cols.cpu().numpy())
        planes = _bit_planes(rows, cols, w, n, k, signed)
        word_offsets, word_entries = plane_words(planes, k)
        return WeightedAdjPlanes(
            planes=planes,
            wdeg=torch.zeros(n, dtype=torch.int64, device=device).index_add_(0, rows, w).to(torch.int32),
            word_offsets=word_offsets,
            word_entries=word_entries,
            offsets=offsets.to(torch.int32),
            entries=torch.stack([cols, w], dim=1).to(torch.int32).contiguous(),
            level_nodes=torch.from_numpy(level_nodes).to(device),
            level_offsets=torch.from_numpy(level_offsets).to(device),
            k=k,
            signed=signed,
        )


def plane_words(planes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word_offsets [N + 1], word_entries [E + 1, 2]) int32 of bit-planes
    [P, N, W], k positive planes first: each row's non-zero (plane p, word
    w), ordered by (w, p), as {(c << 16) | w, planes[p, i, w]} with c the
    plane's signed weight (+2^p, or -2^(p - k) for p >= k), then the empty
    entry {0, 0}; built where `planes` lies."""
    _, n, _ = planes.shape
    by_row = planes.permute(1, 2, 0)  # [N, W, P]
    rows, idx, p = torch.nonzero(by_row, as_tuple=True)  # by row, then word, then plane
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=planes.device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    coef = torch.where(p < k, 1 << p.clamp(max=k - 1), -(1 << (p - k).clamp(min=0)))
    entries = torch.stack([coef * 65536 + idx, by_row[rows, idx, p].long()], dim=1).to(torch.int32)
    return offsets.to(torch.int32), torch.cat([entries, entries.new_zeros(1, 2)])


def word_entry_bytes(graph: Graph) -> int:
    """The bytes of K8a's word entries and offsets (`plane_words`), from the
    edge list alone: 8 per non-zero (row, word, plane) of the signed
    bit-planes and for the empty entry after them, and the offsets."""
    n = graph.num_nodes
    k, _ = weight_planes(graph)
    rows, cols, w = _adjacency_entries(graph, "cpu")
    key = (rows * num_words(n) + (cols >> 5)) * (2 * k) + k * (w < 0)
    keys = torch.cat([(key + b)[(w.abs() >> b) & 1 == 1] for b in range(k)])
    return (torch.unique(keys).numel() + 1) * 8 + (n + 1) * 4


def level_schedule(offsets: np.ndarray, cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(level_nodes [N], level_offsets [D + 1]) int32 of the natural-order
    lists (offsets [N + 1], neighbour ids ascending within a list): level(i)
    = 1 + max(level(j) : j < i a neighbour), 0 when there is none."""
    n = offsets.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(offsets))
    n_earlier = np.bincount(rows[cols < rows], minlength=n)  # a list's prefix: ascending ids
    level = np.zeros(n, np.int64)
    for i in np.flatnonzero(n_earlier):
        s = offsets[i]
        level[i] = level[cols[s : s + n_earlier[i]]].max() + 1
    level_nodes = np.argsort(level, kind="stable")  # by (level, id)
    level_offsets = np.zeros(int(level.max(initial=0)) + 2, np.int64)
    level_offsets[1:] = np.cumsum(np.bincount(level))
    return level_nodes.astype(np.int32), level_offsets.astype(np.int32)


def _sweep_1flip_plain(x: torch.Tensor, adj: WeightedAdjPlanes) -> torch.Tensor:
    """Plain version of K8a/K8b on bool [B, N]: the kernels' integer
    arithmetic in the sequential order, node by node from its list,
    P = sum_j w_ij x_j (int64), cut_i = wdeg_i - P if x_i else P, flip when
    wdeg_i - 2 cut_i > 0."""
    n = x.shape[1]
    x = x.clone()
    off = adj.offsets.tolist()
    j, w = adj.entries[:, 0].long(), adj.entries[:, 1].long()
    wdeg = adj.wdeg.long()
    for i in range(n):
        s, e = off[i], off[i + 1]
        p = (x[:, j[s:e]].long() * w[s:e]).sum(dim=1)
        cur = x[:, i]
        cut = torch.where(cur, wdeg[i] - p, p)
        x[:, i] = cur ^ (wdeg[i] - 2 * cut > 0)
    return x


def sweep_1flip_weighted(bits: torch.Tensor, adj: WeightedAdjPlanes, levels: bool = False) -> torch.Tensor:
    """Greedy sequential 1-flip sweep. bits bool [B, N] -> bool [B, N].
    K8a on the word entries, or with `levels` K8b on the lists in the level
    schedule; the same bits either way."""
    b, n = bits.shape
    if n != adj.num_nodes:
        raise ValueError(f"bits have {n} nodes, planes built for {adj.num_nodes}")
    if not bits.is_cuda:
        return _sweep_1flip_plain(bits.bool(), adj)
    w = num_words(n)
    words = pack_bits(bits)
    check_cuda_tensor(adj.wdeg, "wdeg", torch.int32, (n,))
    if levels:
        check_cuda_tensor(adj.offsets, "offsets", torch.int32, (n + 1,))
        check_cuda_tensor(adj.entries, "entries", torch.int32, (adj.entries.shape[0], 2))
        check_cuda_tensor(adj.level_nodes, "level_nodes", torch.int32, (n,))
        check_cuda_tensor(adj.level_offsets, "level_offsets", torch.int32, (adj.depth + 1,))
        if adj.entries.data_ptr() % 8:
            raise ValueError("entries must be 8-byte aligned (the kernel reads an entry in one 8-byte load)")
        WSWEEP_1FLIP_LEVELS.launch(adj.offsets, adj.entries, adj.level_nodes, adj.level_offsets, adj.wdeg, words,
                                   b, w, adj.depth)
    else:
        check_cuda_tensor(adj.word_offsets, "word_offsets", torch.int32, (n + 1,))
        check_cuda_tensor(adj.word_entries, "word_entries", torch.int32, (adj.word_entries.shape[0], 2))
        if adj.word_entries.data_ptr() % 8:
            raise ValueError("word_entries must be 8-byte aligned (the kernel reads an entry in one 8-byte load)")
        if w >= 1 << 16:
            raise ValueError(f"K8a's entries hold a word index below 2^16; the graph has {w} words a row")
        WSWEEP_1FLIP.launch(adj.word_offsets, adj.word_entries, adj.wdeg, adj.word_entries.shape[0] - 1, words, b, w,
                            n)
    return unpack_bits(words, n)
