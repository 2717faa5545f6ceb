"""(Weighted) MaxSAT: instance container, batched evaluation and a noisy
sequential sweep (counterpart of `rlsolver_tpu/problems/maxsat.py`; RLSolver
`MCPG/dataloader.py:169-276`, `maxsat_dataloader`, and
`MCPG/sampling.py:253-286`, `mcpg_sampling_maxsat`).

Clauses live in a padded [C, K] literal table (variable index and sign, sign
0 on padding), so a clause's satisfaction is one gather and a max. A sweep
visits the variables most-occurring first; a step touches only the padded
list of clauses holding that variable (padding points at a sentinel clause,
never satisfied, weight 0), for all chains at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from rlsolver_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MaxSatInstance:
    """num_vars; clause_vars [C, K] int32 and clause_signs [C, K] int8
    (0 pads); weights [C] f32; `hard_weight`, the wcnf hard-clause weight
    (None for plain cnf)."""

    num_vars: int
    clause_vars: np.ndarray
    clause_signs: np.ndarray
    weights: np.ndarray
    hard_weight: Optional[float] = None
    name: str = ""

    @property
    def num_clauses(self) -> int:
        return int(self.clause_vars.shape[0])

    @staticmethod
    def from_clauses(
        num_vars: int,
        clauses: Sequence[Sequence[int]],
        weights: Optional[Sequence[float]] = None,
        hard_weight: Optional[float] = None,
        name: str = "",
    ) -> "MaxSatInstance":
        """Clauses in the DIMACS convention: 1-indexed, negative = negated."""
        k = max(len(c) for c in clauses)
        cv = np.zeros((len(clauses), k), np.int32)
        cs = np.zeros((len(clauses), k), np.int8)
        for ci, clause in enumerate(clauses):
            for j, lit in enumerate(clause):
                if lit == 0:
                    raise ValueError("literal 0 inside a clause")
                cv[ci, j] = abs(lit) - 1
                cs[ci, j] = 1 if lit > 0 else -1
        w = np.ones(len(clauses), np.float32) if weights is None else np.asarray(weights, np.float32)
        return MaxSatInstance(num_vars, cv, cs, w, hard_weight, name)

    @staticmethod
    def from_cnf(path: str, name: str = "") -> "MaxSatInstance":
        """DIMACS .cnf, or weighted .wcnf with lines `<weight> <lits...> 0`
        and the hard weight as the fifth field of the `p` line."""
        weighted = path.endswith(".wcnf")
        clauses: List[List[int]] = []
        weights: List[float] = []
        num_vars = 0
        hard_weight = None
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] == "c":
                    continue
                if parts[0] == "p":
                    num_vars = int(parts[2])
                    if weighted and len(parts) > 4:
                        hard_weight = float(parts[4])
                    continue
                if weighted:
                    weights.append(float(parts[0]))
                    parts = parts[1:]
                else:
                    weights.append(1.0)
                lits = [int(x) for x in parts if x != "0"]
                if lits:
                    clauses.append(lits)
                else:  # a line with no literal adds no clause
                    weights.pop()
        return MaxSatInstance.from_clauses(num_vars, clauses, weights, hard_weight, name or path)


class MaxSatEnv:
    """The instance's tables on one device (`cuda` unless `device="cpu"`)
    and its batched objective and sweep."""

    def __init__(self, inst: MaxSatInstance, device=None):
        self.inst = inst
        self.device = dev = resolve_device(device)
        self.num_vars = inst.num_vars
        self.num_clauses = c = inst.num_clauses
        self.cv = torch.from_numpy(inst.clause_vars).long().to(dev)
        self.cs = torch.from_numpy(inst.clause_signs.astype(np.float32)).to(dev)
        self.w = torch.from_numpy(np.asarray(inst.weights, np.float32)).to(dev)
        # each variable's clauses, padded with the sentinel clause C
        occur: List[List[int]] = [[] for _ in range(inst.num_vars)]
        for ci, j in zip(*np.nonzero(inst.clause_signs)):
            occur[int(inst.clause_vars[ci, j])].append(int(ci))
        max_occ = max([1] + [len(o) for o in occur])
        vc = np.full((inst.num_vars, max_occ), c, np.int64)
        for v, occ in enumerate(occur):
            vc[v, : len(occ)] = occ
        self.var_clauses = torch.from_numpy(vc).to(dev)
        # most-occurring variables first (RLSolver's degree order), stable
        self.sweep_order = np.argsort(-np.asarray([len(o) for o in occur], np.int64), kind="stable").tolist()
        # per variable, its clauses' literals with the sentinel clause
        # appended (variable 0, sign 0, weight 0): vars, signs, weights, and
        # the signs with the variable's own literals negated
        cv = torch.cat([self.cv, torch.zeros(1, self.cv.shape[1], dtype=torch.long, device=dev)])
        cs = torch.cat([self.cs, torch.zeros(1, self.cs.shape[1], device=dev)])
        self._lit_vars = cv[self.var_clauses]  # [N, D, K]
        self._lit_signs = cs[self.var_clauses]
        own = self._lit_vars == torch.arange(inst.num_vars, device=dev)[:, None, None]
        self._lit_signs_flipped = torch.where(own, -self._lit_signs, self._lit_signs)
        self._lit_w = torch.cat([self.w, torch.zeros(1, device=dev)])[self.var_clauses]  # [N, D]

    def clause_sat(self, spins: torch.Tensor) -> torch.Tensor:
        """Per-clause satisfaction, bool [B, C], from spins +-1 [B, N]."""
        lits = spins[:, self.cv] * self.cs[None]  # [B, C, K]
        return torch.amax(lits, dim=2) > 0

    def obj(self, bits: torch.Tensor) -> torch.Tensor:
        """Weighted count of satisfied clauses, f32 [B] (maximize)."""
        spins = bits.to(torch.float32) * 2.0 - 1.0
        return torch.sum(self.clause_sat(spins) * self.w[None], dim=1)

    def random_bits(self, gen: torch.Generator, num_chains: int) -> torch.Tensor:
        return torch.rand(num_chains, self.num_vars, generator=gen, device=self.device) < 0.5

    def sweep(self, gen: Optional[torch.Generator], bits: torch.Tensor, num_sweeps: int = 1,
              noise: float = 0.5, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sequential variable sweeps: variable v flips where the weighted
        count of its satisfied clauses after the flip beats the count
        before plus U(-noise, noise). The uniforms [num_sweeps * N, B],
        already in [-noise, noise), come from `gen` unless `u` gives them.
        bits [B, N] -> bool [B, N]."""
        b = bits.shape[0]
        sn = bits.t().to(torch.float32) * 2.0 - 1.0  # node-major spins [N, B]

        def weighted_sat(lits, signs, w):  # [D, K, B] literals -> [B]
            return torch.sum((torch.amax(lits * signs[..., None], dim=1) > 0) * w[:, None], dim=0)

        for i in range(num_sweeps * self.num_vars):
            v = self.sweep_order[i % self.num_vars]
            lits = sn[self._lit_vars[v]]  # [D, K, B]
            sat_old = weighted_sat(lits, self._lit_signs[v], self._lit_w[v])
            sat_new = weighted_sat(lits, self._lit_signs_flipped[v], self._lit_w[v])
            if u is not None:
                ui = u[i]
            else:
                ui = torch.rand(b, generator=gen, device=sn.device) * (2.0 * noise) - noise
            sn[v] = torch.where(sat_new > sat_old + ui, -sn[v], sn[v])
        return sn.t() > 0
