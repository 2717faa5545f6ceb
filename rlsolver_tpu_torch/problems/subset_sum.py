"""Portfolio subset-sum: batched objective and a greedy sweep (counterpart
of `rlsolver_tpu/problems/subset_sum.py`; RLSolver
`methods_problem_specific/portfolio_allocation/`, `subset_sum_simulator.py`
and `subset_sum_local_search.py`).

Maximize lamb . [count(x), |sum(amount * x)|, |tag_0 sum|, ...]: with the
default lamb [1, -1, -1, ...], as many items as possible whose amounts (and
each tag group's amounts) cancel. The sweep flips an item where the score
strictly improves, keeping the signed sums up to date, for all chains at
once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rlsolver_tpu_torch.algos.mcpg_multi import McpgProblem
from rlsolver_tpu_torch.device import resolve_device


def read_amounts_csv(path: str) -> np.ndarray:
    """A CSV with a header, amounts in column 1, as integer cents."""
    with open(path) as f:
        lines = f.readlines()[1:]
    amounts = np.asarray([float(line.split(",")[1]) for line in lines], np.float64)
    return np.rint(amounts * 100).astype(np.int64)


class SubsetSumEnv:
    """Amounts [N] (and, with `tags`, each item's group) on one device
    (`cuda` unless `device="cpu"`); `lamb` weights the components."""

    def __init__(self, amounts: np.ndarray, tags: Optional[Sequence[int]] = None,
                 lamb: Optional[Sequence[float]] = None, device=None):
        self.device = dev = resolve_device(device)
        amounts32 = np.asarray(amounts, np.float32)
        self.amounts = torch.from_numpy(amounts32).to(dev)
        self.num_items = int(amounts32.shape[0])
        if tags is not None:
            tags = np.asarray(tags)
            self.num_tags = int(tags.max()) + 1
            onehot = np.zeros((self.num_tags, self.num_items), np.float32)
            onehot[tags, np.arange(self.num_items)] = 1.0
            self.tag_amounts = torch.from_numpy(onehot * amounts32).to(dev)  # [T, N]
        else:
            self.num_tags = 0
            self.tag_amounts = torch.zeros(0, self.num_items, device=dev)
        if lamb is None:
            lamb = [1.0, -1.0] + [-1.0] * self.num_tags
        self.lamb = torch.from_numpy(np.asarray(lamb, np.float32)).to(dev)

    def components(self, bits: torch.Tensor) -> torch.Tensor:
        """[B, 2 + num_tags]: count, |total|, each tag's |sum|."""
        x = bits.to(torch.float32)
        cols = [x.sum(dim=1), torch.abs(x @ self.amounts)] + [torch.abs(x @ ta) for ta in self.tag_amounts]
        return torch.stack(cols, dim=1)

    def obj(self, bits: torch.Tensor) -> torch.Tensor:
        """The lamb-weighted objective, f32 [B] (maximize)."""
        return self.components(bits) @ self.lamb

    def random_bits(self, gen: torch.Generator, num_chains: int) -> torch.Tensor:
        return torch.rand(num_chains, self.num_items, generator=gen, device=self.device) < 0.5

    def _score(self, count, total, tag_tot):
        s = self.lamb[0] * count + self.lamb[1] * torch.abs(total)
        if self.num_tags:
            s = s + torch.abs(tag_tot) @ self.lamb[2:]
        return s

    def sweep(self, bits: torch.Tensor, num_sweeps: int = 1) -> torch.Tensor:
        """Greedy 1-flip sweeps over the items in order, strict improvements
        only. bits [B, N] -> bool [B, N]."""
        xn = bits.t().to(torch.float32).contiguous()  # node-major [N, B]
        count = xn.sum(dim=0)
        total = self.amounts @ xn
        tag_tot = (self.tag_amounts @ xn).t()  # [B, T]
        cur = self._score(count, total, tag_tot)
        tag_cols = self.tag_amounts.t().contiguous()  # [N, T]
        for _ in range(num_sweeps):
            for i in range(self.num_items):
                d = 1.0 - 2.0 * xn[i]
                n_count, n_total = count + d, total + d * self.amounts[i]
                n_tag = tag_tot + d[:, None] * tag_cols[i][None, :]
                new = self._score(n_count, n_total, n_tag)
                accept = new > cur
                xn[i] = torch.where(accept, 1.0 - xn[i], xn[i])
                count = torch.where(accept, n_count, count)
                total = torch.where(accept, n_total, total)
                tag_tot = torch.where(accept[:, None], n_tag, tag_tot)
                cur = torch.where(accept, new, cur)
        return xn.t() > 0.5


def subset_sum_problem(env: SubsetSumEnv, num_sweeps: int = 2) -> McpgProblem:
    """The MCPG adapter (`subset_sum_local_search.py`'s REINFORCE path)."""
    return McpgProblem(
        num_vars=env.num_items,
        score=env.obj,
        improve=lambda gen, bits, noise=None: env.sweep(bits, num_sweeps=num_sweeps),
    )
