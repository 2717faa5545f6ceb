"""Batched maxcut objective and flip gains (counterpart of
`rlsolver_tpu/ops/cut.py`).

  * dense:  cut(x) = W/2 - s A s^T / 4 with s = 2x - 1, one [B, N] x [N, N]
    matmul;
  * sparse: cut(x) = sum_e w_e (x[n0_e] XOR x[n1_e]) by gathers on the edges;
  * gains:  cut(flip(x, i)) - cut(x) = s_i (A s)_i.

Exactness: the JAX package stores A in bf16 and accumulates in f32. Here A
and s stay f32 and matmuls run at full f32 precision (TF32 off, see
`device.resolve_device`), so on integer-weight graphs every partial sum is an
integer below 2^24 and cuts and gains equal the JAX values exactly, and on
other weights they match the JAX env built with f32. (A bf16 matmul with f32
output, `torch.mm(..., out_dtype=torch.float32)`, exists in torch 2.13 and
would be exact for signs and integer weights below 256 in magnitude; the
port keeps f32 until a measurement shows the dense cut is worth the switch.)

The [B, N] f32 intermediates are made CHUNK rows at a time: at 10^6 chains x
2000 nodes one whole intermediate would be 8 GB.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device

CHUNK = 1 << 16


class CutGraph(NamedTuple):
    """Static graph tensors on one device."""

    num_nodes: int
    adj: Optional[torch.Tensor]  # [n, n] f32, or None when sparse only
    n0: torch.Tensor  # [m] int64
    n1: torch.Tensor  # [m] int64
    w: torch.Tensor  # [m] f32
    deg_w: torch.Tensor  # [n] f32
    total_w: torch.Tensor  # scalar f32

    @staticmethod
    def build(graph: Graph, device=None, with_dense: bool = True) -> "CutGraph":
        n0, n1, w = graph.edge_arrays()
        dev = resolve_device(device)
        return CutGraph(
            num_nodes=graph.num_nodes,
            adj=torch.from_numpy(graph.adjacency_dense()).to(dev) if with_dense else None,
            n0=torch.from_numpy(n0).long().to(dev),
            n1=torch.from_numpy(n1).long().to(dev),
            w=torch.from_numpy(w).to(dev),
            deg_w=torch.from_numpy(graph.weighted_degrees()).to(dev),
            total_w=torch.tensor(graph.total_weight, dtype=torch.float32, device=dev),
        )


def signs_from_bits(xs: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """{0,1} bits -> {-1,+1} signs."""
    return (2 * xs.to(torch.int8) - 1).to(dtype)


def _rows(fn, xs: torch.Tensor) -> torch.Tensor:
    """fn over CHUNK-row slices of xs, concatenated."""
    if xs.shape[0] <= CHUNK:
        return fn(xs)
    return torch.cat([fn(xs[i : i + CHUNK]) for i in range(0, xs.shape[0], CHUNK)])


def cut_dense(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    """Batched cut value via one f32 matmul. xs: bool [B, N] -> f32 [B]."""

    def one(x):
        s = signs_from_bits(x)
        quad = torch.sum((s @ cg.adj) * s, dim=-1)
        return 0.5 * cg.total_w - 0.25 * quad

    return _rows(one, xs)


def cut_sparse(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    """Batched cut value via edge gathers. xs: bool [B, N] -> f32 [B]."""

    def one(x):
        cut_e = (x[:, cg.n0] ^ x[:, cg.n1]).to(torch.float32)  # [b, m]
        return torch.sum(cut_e * cg.w, dim=-1)

    return _rows(one, xs.bool())


def _prefer_dense(cg: CutGraph) -> bool:
    # same rule as the JAX package, so both pick the same formulation
    return cg.num_nodes * cg.num_nodes <= 256 * cg.n0.shape[0]


def _use_dense(cg: CutGraph, mode: str) -> bool:
    return mode == "dense" or (mode == "auto" and cg.adj is not None and _prefer_dense(cg))


def cut_value(xs: torch.Tensor, cg: CutGraph, mode: str = "auto") -> torch.Tensor:
    return cut_dense(xs, cg) if _use_dense(cg, mode) else cut_sparse(xs, cg)


def flip_gains_dense(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    """gain[b, i] = s_i (A s)_i. -> f32 [B, N]."""
    s = signs_from_bits(xs)
    return (s @ cg.adj) * s


def node_cut_contrib_sparse(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    """contrib[b, i] = sum_{j in N(i)} w_ij (x_i XOR x_j). -> f32 [B, N]."""
    x = xs.bool()
    cut_e = (x[:, cg.n0] ^ x[:, cg.n1]).to(torch.float32) * cg.w  # [B, m]
    out = torch.zeros(x.shape[0], cg.num_nodes, dtype=torch.float32, device=x.device)
    out.index_add_(1, cg.n0, cut_e)
    out.index_add_(1, cg.n1, cut_e)
    return out


def flip_gains_sparse(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    return cg.deg_w[None, :] - 2.0 * node_cut_contrib_sparse(xs, cg)


def node_cut_contrib_dense(xs: torch.Tensor, cg: CutGraph) -> torch.Tensor:
    """contrib[b, i] = (deg_w[i] - gain[b, i]) / 2, from one matmul."""
    return 0.5 * (cg.deg_w[None, :] - flip_gains_dense(xs, cg))


def flip_gains(xs: torch.Tensor, cg: CutGraph, mode: str = "auto") -> torch.Tensor:
    return flip_gains_dense(xs, cg) if _use_dense(cg, mode) else flip_gains_sparse(xs, cg)


def apply_flip_update_gains(s: torch.Tensor, gains: torch.Tensor, node: int, adj_row: torch.Tensor):
    """Flip `node` in every row of the signs s [B, N] and update the gains
    [B, N] by the rank-1 rule gain_j' = gain_j - 2 s_j s_i A_ij (j != i),
    gain_i' = -gain_i; adj_row = A[node]. Returns new (s, gains)."""
    s_i = s[:, node]
    gains_new = gains + -2.0 * s_i[:, None] * s * adj_row[None, :]
    gains_new[:, node] = -gains[:, node]
    s_new = s.clone()
    s_new[:, node] = -s_i
    return s_new, gains_new
