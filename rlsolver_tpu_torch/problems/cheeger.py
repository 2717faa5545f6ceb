"""Cheeger cuts (conductance): batched objectives and a sequential sweep
(counterpart of `rlsolver_tpu/problems/cheeger.py`; RLSolver
`MCPG/sampling.py:184-251`, `mcpg_sampling_rcheegercut` and
`mcpg_sampling_ncheegercut`). Minimize
  ratio Cheeger:      cut(S) / min(|S|, n - |S|)
  normalized Cheeger: cut(S) * (1 / |S| + 1 / (n - |S|)),
inf where one side is empty. The sweep visits the nodes in descending
weighted degree, keeps (cut, |S|) up to date and flips a node where the
ratio strictly improves and both sides stay non-empty.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device


class CheegerEnv:
    """The graph's tensors on one device (`cuda` unless `device="cpu"`)."""

    def __init__(self, graph: Graph, normalized: bool = False, device=None):
        self.graph = graph
        self.device = dev = resolve_device(device)
        self.num_nodes = graph.num_nodes
        self.normalized = normalized
        nbrs, nbr_w, _ = graph.padded_neighbors()  # padding points at the sentinel column N
        self.nbrs = torch.from_numpy(nbrs).long().to(dev)
        self.nbr_w = torch.from_numpy(nbr_w).to(dev)
        self.wdeg = torch.from_numpy(graph.weighted_degrees()).to(dev)
        self.order = torch.from_numpy(graph.degree_sorted_nodes()).long().to(dev)
        e0, e1, w = graph.edge_arrays()
        self.e0 = torch.from_numpy(e0).long().to(dev)
        self.e1 = torch.from_numpy(e1).long().to(dev)
        self.ew = torch.from_numpy(w).to(dev)

    def _ratio(self, cut: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
        n = self.num_nodes
        if self.normalized:
            return cut * (1.0 / size + 1.0 / (n - size))
        return cut / torch.minimum(size, n - size)

    def cut_and_size(self, bits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cut f32 [B], |S| f32 [B]) of bits bool [B, N]."""
        bits = bits.bool()
        cut = torch.sum((bits[:, self.e0] ^ bits[:, self.e1]) * self.ew[None], dim=1)
        return cut, bits.sum(dim=1).to(torch.float32)

    def obj(self, bits: torch.Tensor) -> torch.Tensor:
        """The Cheeger ratio, f32 [B] (minimize; inf where a side is empty)."""
        cut, size = self.cut_and_size(bits)
        ok = (size > 0) & (size < self.num_nodes)
        return torch.where(ok, self._ratio(cut, size), torch.inf)

    def seed_bits(self, num_chains: int) -> torch.Tensor:
        """Chain i starts with only the (i mod n)-th highest-degree node in
        S (RLSolver `sampling.py:8-15`). bool [num_chains, N]."""
        idx = self.order[torch.arange(num_chains, device=self.device) % self.num_nodes]
        out = torch.zeros(num_chains, self.num_nodes, dtype=torch.bool, device=self.device)
        out[torch.arange(num_chains, device=self.device), idx] = True
        return out

    def sweep(self, bits: torch.Tensor, num_sweeps: int = 1) -> torch.Tensor:
        """Degree-ordered sequential sweeps (RLSolver `sampling.py:199-214`).
        Flipping v changes the cut by -(2 x_v - 1)(wdeg_v - 2 * (weight of
        v's neighbours in S)). bits [B, N] -> bool [B, N]."""
        cut, size = self.cut_and_size(bits)
        ratio = self._ratio(cut, size)
        b = bits.shape[0]
        # node-major, with the sentinel row N (always 0) for padded neighbours
        xn = torch.cat([bits.t().to(torch.float32), torch.zeros(1, b, device=bits.device)])
        order = self.order.tolist()
        for _ in range(num_sweeps):
            for v in order:
                nbr_in_s = torch.sum(xn[self.nbrs[v]] * self.nbr_w[v][:, None], dim=0)
                sign = 2.0 * xn[v] - 1.0
                new_cut = cut - sign * (self.wdeg[v] - 2.0 * nbr_in_s)
                new_size = size - sign
                valid = (new_size > 0.5) & (new_size < self.num_nodes - 0.5)
                new_ratio = torch.where(valid, self._ratio(new_cut, new_size), torch.inf)
                accept = new_ratio < ratio
                xn[v] = torch.where(accept, 1.0 - xn[v], xn[v])
                cut = torch.where(accept, new_cut, cut)
                size = torch.where(accept, new_size, size)
                ratio = torch.where(accept, new_ratio, ratio)
        return xn[:-1].t() > 0.5
