"""MCPG's degree-ordered sequential sweep with neighbour gathers
(counterpart of `rlsolver_tpu/ops/sweeps.py`).

For each node in descending-degree order, x_i = 1 iff the noisy weighted sum
of its neighbours' current values is below half its weighted degree
(`MCPG.py:120-141` in RLSolver). The first sweep mixes two value domains:
unprocessed nodes carry 2x - 0.5 in {-0.5, 1.5}, processed ones {0, 1}.
This is the default (non `--fast`) sweep; with zero noise it equals the
packed kernel of `ops/kernels/mcpg_sweep.py` (tested).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device


class SweepData(NamedTuple):
    """Static per-instance tensors for sweeps, in sweep order."""

    order: List[int]  # node ids, descending degree (host list: loop indices)
    nbrs: torch.Tensor  # [N, max_deg] int64 neighbour table (sentinel N)
    nbr_w: torch.Tensor  # [N, max_deg] f32 weights
    wdeg: torch.Tensor  # [N] f32 weighted degree

    @staticmethod
    def build(graph: Graph, device=None) -> "SweepData":
        device = resolve_device(device)
        order = graph.degree_sorted_nodes(descending=True)
        nbrs, nbr_w, _ = graph.padded_neighbors()
        wdeg = graph.weighted_degrees()
        return SweepData(
            order=order.tolist(),
            nbrs=torch.from_numpy(nbrs[order]).long().to(device),
            nbr_w=torch.from_numpy(nbr_w[order]).to(device),
            wdeg=torch.from_numpy(wdeg[order]).to(device),
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
