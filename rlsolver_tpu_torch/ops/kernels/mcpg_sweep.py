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
    incremental-gain sweep of `MaxcutEnv`.

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
from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register
from rlsolver_tpu_torch.ops.kernels.codec import num_words, pack_bits, unpack_bits

MCPG_SWEEP = register(Kernel(
    "mcpg_sweep", "mcpg_sweep.cu", "mcpg_sweep", "pppppipiufpiiii",
    replaces="rlsolver_tpu/ops/pallas/mcpg_sweep.py:171 _mcpg_sweep_kernel",
))
SWEEP_1FLIP = register(Kernel(
    "sweep_1flip", "mcpg_sweep.cu", "sweep_1flip", "pppppiii",
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


class PackedAdjacency(NamedTuple):
    """{0, +-1}-weight adjacency as packed row planes [N, W] in natural node
    order, with per-row popcounts; `neg` is None on a unit-weight graph."""

    pos: torch.Tensor  # [N, W] int32
    neg: Optional[torch.Tensor]  # [N, W] int32 or None
    deg_pos: torch.Tensor  # [N] int32 number of +1 neighbours
    deg_neg: Optional[torch.Tensor]  # [N] int32 number of -1 neighbours


def pack_adjacency(graph: Graph, device=None) -> PackedAdjacency:
    device = resolve_device(device)
    adj = _signed_adjacency(graph)

    def degree(a):
        return torch.from_numpy(a.sum(axis=1).astype(np.int32)).to(device)

    signed = bool(np.any(adj < 0))
    return PackedAdjacency(
        pos=_pack_rows(adj > 0, device),
        neg=_pack_rows(adj < 0, device) if signed else None,
        deg_pos=degree(adj > 0),
        deg_neg=degree(adj < 0) if signed else None,
    )


def _sweep_1flip_plain(x: torch.Tensor, adj: PackedAdjacency) -> torch.Tensor:
    """Plain version of the K5 kernel on bool [B, N] (integer popcounts)."""
    n = x.shape[1]
    x = x.clone()
    pos = unpack_bits(adj.pos, n)
    neg = unpack_bits(adj.neg, n) if adj.neg is not None else None
    for i in range(n):
        cur = x[:, i]
        p = (x & pos[i]).sum(dim=1)
        deg = adj.deg_pos[i].long()
        cut = torch.where(cur, deg - p, p)
        wdeg = deg
        if neg is not None:
            pn = (x & neg[i]).sum(dim=1)
            degn = adj.deg_neg[i].long()
            cut = cut - torch.where(cur, degn - pn, pn)
            wdeg = deg - degn
        x[:, i] = cur ^ (wdeg - 2 * cut > 0)
    return x


def sweep_1flip_packed(bits: torch.Tensor, adj: PackedAdjacency) -> torch.Tensor:
    """Greedy sequential 1-flip sweep. bits bool [B, N] -> bool [B, N]."""
    b, n = bits.shape
    if not bits.is_cuda:
        return _sweep_1flip_plain(bits.bool(), adj)
    w = num_words(n)
    words = pack_bits(bits)
    check_cuda_tensor(adj.pos, "adj.pos", torch.int32, (n, w))
    check_cuda_tensor(adj.deg_pos, "adj.deg_pos", torch.int32, (n,))
    if adj.neg is not None:
        check_cuda_tensor(adj.neg, "adj.neg", torch.int32, (n, w))
        check_cuda_tensor(adj.deg_neg, "adj.deg_neg", torch.int32, (n,))
    SWEEP_1FLIP.launch(adj.pos, adj.neg, adj.deg_pos, adj.deg_neg, words, b, w, n)
    return unpack_bits(words, n)
