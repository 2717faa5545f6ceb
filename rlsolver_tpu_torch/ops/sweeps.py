"""Sequential local-search sweeps of MCPG (counterpart of
`rlsolver_tpu/ops/sweeps.py`), as torch loops of small launches.

  * degree_ordered_sweep — for each node in descending-degree order,
    x_i = 1 iff the noisy weighted sum of its neighbours' current values is
    below half its weighted degree (`MCPG.py:120-141` in RLSolver). The
    first sweep mixes two value domains: unprocessed nodes carry 2x - 0.5
    in {-0.5, 1.5}, processed ones {0, 1}. This is the default (non
    `--fast`) sweep; with zero noise it equals the packed kernel of
    `ops/kernels/mcpg_sweep.py` (tested).
  * edge_pair_sweep — MCPG's maxcut_edge local search: for each edge in
    descending endpoint-degree order, the pair (x_r, x_c) that maximizes
    the pair's noisy local cut (`MCPG/sampling.py:130-180`); on the card
    each chunk of EDGE_CHUNK edges replays as a CUDA graph (the edge index
    a device tensor, so one graph serves every chunk).
  * colored_sweep — the anti-majority update of a whole color class at
    once, from one [B, N] x [N, N] product (nodes of a class share no edge).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from rlsolver_tpu_torch.capture import Graphs
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device

EDGE_CHUNK = 512  # edges of one edge_pair_sweep graph


class SweepData(NamedTuple):
    """Static per-instance tensors for sweeps, in sweep order."""

    order: List[int]  # node ids, descending degree (host list: loop indices)
    nbrs: torch.Tensor  # [N, max_deg] int64 neighbour table (sentinel N)
    nbr_w: torch.Tensor  # [N, max_deg] f32 weights
    wdeg: torch.Tensor  # [N] f32 weighted degree
    color_masks: torch.Tensor  # [num_colors, N] bool: the classes of `greedy_coloring` (node order)

    @staticmethod
    def build(graph: Graph, device=None) -> "SweepData":
        device = resolve_device(device)
        order = graph.degree_sorted_nodes(descending=True)
        nbrs, nbr_w, _ = graph.padded_neighbors()
        wdeg = graph.weighted_degrees()
        color, num_colors = graph.greedy_coloring()
        return SweepData(
            order=order.tolist(),
            nbrs=torch.from_numpy(nbrs[order]).long().to(device),
            nbr_w=torch.from_numpy(nbr_w[order]).to(device),
            wdeg=torch.from_numpy(wdeg[order]).to(device),
            color_masks=torch.from_numpy(color[None, :] == np.arange(num_colors)[:, None]).to(device),
        )


def mcpg_init_values(xs: torch.Tensor) -> torch.Tensor:
    """{0,1} bits [B, N] -> the sweep's start domain 2x - 0.5, with a
    sentinel column appended (always 0): [B, N+1] f32."""
    xt = 2.0 * xs.to(torch.float32) - 0.5
    return torch.cat([xt, torch.zeros(xt.shape[0], 1, device=xt.device)], dim=1)


def degree_ordered_sweep(
    gen: torch.Generator,
    xt: torch.Tensor,
    data: SweepData,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> torch.Tensor:
    """Run `num_sweeps` sweeps on xt [B, N+1] (see `mcpg_init_values`);
    returns a new xt with every node entry in {0, 1}."""
    xn = xt.t().contiguous()  # node-major: gathers and writes touch whole rows
    for _ in range(num_sweeps):
        for k, node in enumerate(data.order):
            vals = xn[data.nbrs[k]]  # [max_deg, B]
            nbr_sum = torch.sum(vals * data.nbr_w[k][:, None], dim=0)
            u = torch.rand(xn.shape[1], generator=gen, device=xn.device)
            new_bit = (nbr_sum + u * noise_scale) < (data.wdeg[k] + noise_scale) / 2.0
            xn[node] = new_bit.to(torch.float32)
    return xn.t().contiguous()


class EdgeSweepData(NamedTuple):
    """Static tensors of `edge_pair_sweep`, one row per edge in sweep order
    (descending wdeg[r] + wdeg[c], `np.argsort`'s default sort on the same
    f32 keys as the JAX package), and the sweep's captured chunks."""

    ends: torch.Tensor  # [E, 2] int64 (r, c)
    ends_rev: torch.Tensor  # [E, 2] int64 (c, r)
    nbrs: torch.Tensor  # [E, 2 * max_deg] int64 neighbours of r, then of c (sentinel N)
    nbr_w: torch.Tensor  # [E, 2, 1, max_deg] f32 their weights
    w: torch.Tensor  # [E, 1, 1] f32 w_rc
    rest: torch.Tensor  # [E, 2, 1] f32 wdeg[r] - w_rc, wdeg[c] - w_rc
    pair_w: torch.Tensor  # [E, 4, 1] f32 w_rc where the choice (x_r, x_c) cuts the edge: 01, 10
    choice_bits: torch.Tensor  # [2, 4] f32 the (x_r, x_c) of the choices 00, 01, 10, 11
    num_nodes: int
    graphs: Graphs  # one CUDA graph a chunk shape (`edge_pair_sweep`)

    @staticmethod
    def build(graph: Graph, device=None) -> "EdgeSweepData":
        device = resolve_device(device)
        wdeg = graph.weighted_degrees()
        e0, e1, ew = graph.edge_arrays()
        order = np.argsort(-(wdeg[e0] + wdeg[e1]))
        ends = np.stack([e0[order], e1[order]], axis=1).astype(np.int64)
        ww = ew[order]
        nbrs, nbr_w, _ = graph.padded_neighbors()
        return EdgeSweepData(
            ends=torch.from_numpy(ends).to(device),
            ends_rev=torch.from_numpy(ends[:, ::-1].copy()).to(device),
            nbrs=torch.from_numpy(nbrs[ends].reshape(len(ends), -1)).long().to(device),
            nbr_w=torch.from_numpy(nbr_w[ends][:, :, None, :]).to(device),
            w=torch.from_numpy(ww.astype(np.float32)[:, None, None]).to(device),
            rest=torch.from_numpy((wdeg[ends] - ww[:, None])[:, :, None]).to(device),
            pair_w=torch.from_numpy(ww[:, None, None] * np.array([0, 1, 1, 0], np.float32)[None, :, None]).to(device),
            choice_bits=torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 1.0, 0.0, 1.0]], device=device),
            num_nodes=graph.num_nodes,
            graphs=Graphs(),
        )


def _edge_chunk(xn: torch.Tensor, u: torch.Tensor, first: torch.Tensor, data: EdgeSweepData,
                noise_scale: float) -> torch.Tensor:
    """Edges first .. first + len(u) - 1 (first: int64 [1] on xn's device)
    on the node-major state xn [N + 1, B], written in place, with their
    uniforms u [C, 4, B]."""
    b = xn.shape[1]
    for j in range(u.shape[0]):
        e = first + j

        def row(t):
            return torch.index_select(t, 0, e)[0]

        vals = torch.index_select(xn, 0, row(data.nbrs)).view(2, -1, b)
        h = torch.bmm(row(data.nbr_w), vals)[:, 0]  # [2, B]: neighbours in set 1
        s = h - row(data.w) * torch.index_select(xn, 0, row(data.ends_rev))  # less the partner
        sc = torch.stack([s, row(data.rest) - s], dim=1)  # [node r | c, value 0 | 1, B]
        f = (sc[0][:, None] + sc[1][None, :]).view(4, b) + row(data.pair_w) + u[j] * noise_scale
        xn.index_copy_(0, row(data.ends), torch.index_select(data.choice_bits, 1, torch.argmax(f, dim=0)))
    return xn


def edge_pair_sweep(
    gen: Optional[torch.Generator],
    xs: torch.Tensor,
    data: EdgeSweepData,
    num_sweeps: int = 1,
    noise_scale: float = 0.1,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`num_sweeps` edge-pair sweeps on bits bool [B, N] -> bool [B, N].
    For edge (r, c), with s_r the weight of r's neighbours in set 1 other
    than c (and s_c likewise), the local cut of (x_r, x_c) is
        f(x_r, x_c) = [s_r | t_r - s_r] + [s_c | t_c - s_c] + w_rc [x_r != x_c],
    t = the weighted degree less w_rc, each choice plus noise_scale * U(0, 1);
    the pair takes the first choice of largest f (`jnp.argmax`'s tie-break,
    in the order 00, 01, 10, 11). The JAX package keeps the field h = x A
    up to date with rank-1 updates and reads it through one-hot products;
    this reads s_r from r's neighbour list, the same sums on integer weights.
    The uniforms [num_sweeps * E, 4, B] come from `gen`, a chunk of
    EDGE_CHUNK edges at a time, unless `noise` gives them. On the card each
    chunk replays as a CUDA graph (`data.graphs`)."""
    num_edges = data.ends.shape[0]
    b = xs.shape[0]
    # node-major, with the sentinel row N (always 0) for padded neighbours
    xn = torch.cat([xs.t().to(torch.float32), torch.zeros(1, b, device=xs.device)])
    for sweep in range(num_sweeps):
        for c0 in range(0, num_edges, EDGE_CHUNK):
            c = min(EDGE_CHUNK, num_edges - c0)
            if noise is not None:
                u = noise[sweep * num_edges + c0 : sweep * num_edges + c0 + c].to(xs.device)
            elif noise_scale:
                u = torch.rand(c, 4, b, generator=gen, device=xs.device)
            else:
                u = torch.zeros(c, 4, b, device=xs.device)
            first = torch.tensor([c0], dtype=torch.int64, device=xs.device)
            xn = data.graphs(f"edges {noise_scale}", lambda x, uu, e: _edge_chunk(x, uu, e, data, noise_scale),
                             xn, u, first)
    return xn[:-1].t() > 0.5


def colored_sweep(
    gen: Optional[torch.Generator],
    xs: torch.Tensor,
    adj: torch.Tensor,
    wdeg: torch.Tensor,
    color_masks: torch.Tensor,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Color-parallel anti-majority sweeps on f32 {0, 1} bits [B, N]: per
    class, the neighbour sums of every node from one f32 product xs @ adj
    (TF32 off, `device.resolve_device`), and the class's nodes set to
    nbr_sum + u * noise_scale < (wdeg + noise_scale) / 2. Nodes of a class
    share no edge, so this equals a sequential sweep within the class. The
    uniforms [num_sweeps, num_colors, B, N] come from `gen` unless `noise`
    gives them. Returns f32 {0, 1} [B, N]."""
    thr = (wdeg + noise_scale) / 2.0
    for sweep in range(num_sweeps):
        for c, mask in enumerate(color_masks):
            if noise is not None:
                u = noise[sweep, c]
            else:
                u = torch.rand(xs.shape, generator=gen, device=xs.device)
            new_bits = ((torch.matmul(xs, adj) + u * noise_scale) < thr).to(torch.float32)
            xs = torch.where(mask[None, :], new_bits, xs)
    return xs
