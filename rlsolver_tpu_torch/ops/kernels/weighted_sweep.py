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
  * `sweep_1flip_weighted`: the greedy 1-flip sweep in ascending node order
    on the bit-planes of `WeightedAdjPlanes`, strict improvements only (K8a,
    or K8b with `node_chunk` rows staged at a time); bit-exact with the f32
    incremental-gain sweep of `MaxcutEnv`.

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
    "sweep_1flip_weighted", "weighted_sweep.cu", "wsweep_1flip", "ppiipiii",
    replaces=f"{_WT}:394 _wsweep_1flip_kernel",
))
WSWEEP_1FLIP_CHUNKED = register(Kernel(
    "sweep_1flip_weighted_chunked", "weighted_sweep.cu", "wsweep_1flip_chunked", "ppiipiiii",
    replaces=f"{_WT}:645 _wsweep_1flip_chunked_kernel",
))

MAX_ABS_WEIGHT = 1 << 15  # k <= 15 planes; the kernels are built for k = 1..15


def _max_abs_weight(weights: np.ndarray) -> int:
    """max |w| of integer weights; ValueError otherwise (as the JAX package)."""
    w = np.asarray(weights, np.float64)
    if not np.array_equal(w, np.rint(w)):
        raise ValueError("weighted packed sweep requires integer edge weights")
    w_max = int(np.abs(w).max()) if w.size else 0
    if w_max >= MAX_ABS_WEIGHT:
        raise ValueError(f"|weight| must be < {MAX_ABS_WEIGHT}, got {w_max}")
    if w_max == 0:
        raise ValueError("graph has no edges")
    return w_max


def weight_planes(graph: Graph) -> Tuple[int, bool]:
    """(k, signed): the number of bit-planes and whether negative planes are
    needed, from the edge weights alone (no tables are built)."""
    return _max_abs_weight(graph.weights).bit_length(), bool((graph.weights < 0).any())


def _integer_weights(graph: Graph, device) -> torch.Tensor:
    """The adjacency as int32 [N, N] on `device` (built there: at N = 10000
    numpy's int64 temporaries take seconds per plane)."""
    _max_abs_weight(graph.weights)
    n = graph.num_nodes
    i, j = (torch.from_numpy(graph.edges[:, c].astype(np.int64)).to(device) for c in (0, 1))
    w = torch.from_numpy(np.rint(graph.weights).astype(np.int32)).to(device)
    iw = torch.zeros(n, n, dtype=torch.int32, device=device)
    iw[i, j] = w
    iw[j, i] = w
    return iw


def _bit_planes(iw: torch.Tensor) -> Tuple[list, list]:
    """Signed binary decomposition of an integer matrix's rows: lists of k
    packed [R, W] planes, positive and (when any entry is < 0) negative."""
    abs_w = iw.abs()
    k = int(abs_w.max()).bit_length()
    bit = [((abs_w >> b) & 1).bool() for b in range(k)]
    pos = [pack_bits((iw > 0) & m) for m in bit]
    neg = [pack_bits((iw < 0) & m) for m in bit] if bool((iw < 0).any()) else []
    return pos, neg


def _signed_rows(planes: torch.Tensor, k: int, signed: bool, n: int, dtype) -> torch.Tensor:
    """sum_b 2^b (pos_b - neg_b) over planes [k (+k), R, W] -> [R, n] weights."""
    out = torch.zeros(planes.shape[1], n, dtype=dtype, device=planes.device)
    for b in range(k):
        out += (1 << b) * unpack_bits(planes[b], n).to(dtype)
        if signed:
            out -= (1 << b) * unpack_bits(planes[k + b], n).to(dtype)
    return out


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
        n = graph.num_nodes
        order = graph.degree_sorted_nodes(descending=True).astype(np.int64)
        order_t = torch.from_numpy(order).to(device)
        a_ord = _integer_weights(graph, device)[order_t]  # [N steps, N node ids]
        pos_of = torch.empty_like(order_t)
        pos_of[order_t] = torch.arange(n, device=device)
        earlier = pos_of[None, :] < torch.arange(n, device=device)[:, None]
        u_cnt = (a_ord * ~earlier).sum(dim=1, dtype=torch.int64).cpu().numpy().astype(np.float64)
        wdeg = graph.weighted_degrees()[order].astype(np.float64)
        pos, neg = _bit_planes(a_ord)
        steps, nbrs = torch.nonzero(a_ord, as_tuple=True)  # row-major: by step, then ascending j
        offsets = torch.zeros(n + 1, dtype=torch.int32, device=device)
        offsets[1:] = torch.cumsum(torch.bincount(steps, minlength=n), 0)
        meta = a_ord[steps, nbrs] * 2 + earlier[steps, nbrs].to(torch.int32)
        return WeightedSweepTables(
            nodes=order_t.to(torch.int32),
            thr1=torch.from_numpy((wdeg / 2.0 + 0.5 * u_cnt).astype(np.float32)).to(device),
            thr2=torch.from_numpy((wdeg / 2.0).astype(np.float32)).to(device),
            planes=torch.stack([pack_bits(earlier), *pos, *neg]),
            offsets=offsets,
            entries=torch.stack([nbrs.to(torch.int32), meta.to(torch.int32)], dim=1).contiguous(),
            k=len(pos),
            signed=bool(neg),
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
        raise ValueError(f"node_chunk must be a positive number of rows, got {node_chunk}")


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
    """Integer adjacency in natural node order as signed bit-planes, for the
    greedy 1-flip sweep: planes [k (+k), N, W] int32, positive then negative,
    and the integer weighted degree of every node, computed once here as K5's
    per-row degrees are, not popcounted again for every chain."""

    planes: torch.Tensor  # [k or 2k, N, W] int32
    wdeg: torch.Tensor  # [N] int32 sum_j w_ij
    k: int
    signed: bool

    @property
    def num_nodes(self) -> int:
        return self.planes.shape[1]

    @property
    def planes_pos(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[: self.k])

    @property
    def planes_neg(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.planes[self.k :])

    @staticmethod
    def build(graph: Graph, device=None) -> "WeightedAdjPlanes":
        iw = _integer_weights(graph, resolve_device(device))
        pos, neg = _bit_planes(iw)
        return WeightedAdjPlanes(
            planes=torch.stack([*pos, *neg]),
            wdeg=iw.sum(dim=1, dtype=torch.int32),
            k=len(pos),
            signed=bool(neg),
        )


def _sweep_1flip_plain(x: torch.Tensor, adj: WeightedAdjPlanes) -> torch.Tensor:
    """Plain version of K8a/K8b on bool [B, N]: the kernel's integer
    arithmetic, P = sum_j w_ij x_j (f64, exact for these integers),
    cut_i = wdeg_i - P if x_i else P, flip when wdeg_i - 2 cut_i > 0."""
    n = x.shape[1]
    a = _signed_rows(adj.planes, adj.k, adj.signed, n, torch.float64)
    wdeg = adj.wdeg.to(torch.float64)
    xf = x.to(torch.float64)
    for i in range(n):
        p = xf @ a[i]
        cur = xf[:, i] > 0.5
        cut = torch.where(cur, wdeg[i] - p, p)
        xf[:, i] = (cur ^ (wdeg[i] - 2.0 * cut > 0)).to(torch.float64)
    return xf > 0.5


def sweep_1flip_weighted(bits: torch.Tensor, adj: WeightedAdjPlanes,
                         node_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy sequential 1-flip sweep. bits bool [B, N] -> bool [B, N].
    `node_chunk` (rows staged at a time) selects K8b over K8a."""
    b, n = bits.shape
    if n != adj.num_nodes:
        raise ValueError(f"bits have {n} nodes, planes built for {adj.num_nodes}")
    _check_chunk(node_chunk)
    if not bits.is_cuda:
        return _sweep_1flip_plain(bits.bool(), adj)
    w = num_words(n)
    words = pack_bits(bits)
    check_cuda_tensor(adj.planes, "planes", torch.int32, (adj.k * (2 if adj.signed else 1), n, w))
    check_cuda_tensor(adj.wdeg, "wdeg", torch.int32, (n,))
    args = (adj.planes, adj.wdeg, adj.k, int(adj.signed), words, b, w, n)
    if node_chunk is None:
        WSWEEP_1FLIP.launch(*args)
    else:
        WSWEEP_1FLIP_CHUNKED.launch(*args, node_chunk)
    return unpack_bits(words, n)
