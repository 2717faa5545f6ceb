"""RUN-CSP: a recurrent message-passing network for binary MaxCSP
(counterpart of `rlsolver_tpu/algos/runcsp.py`; RLSolver's
`methods/RUNCSP/model.py:198-520` and `util.py:8-74`).

A constraint language gives each relation's characteristic 0/1 matrix over
the domain (coloring and maxcut: NEQ; MIS: NAND; max-2-SAT: four ORs of
signed literals). An update sends, per relation, a message along each
clause in both directions from the endpoint's state and soft assignment,
sums each variable's incoming messages, divides by its degree, normalises
(LayerNorm), steps the per-variable LSTM (flax's `OptimizedLSTMCell`
layout) and reads out a softmax assignment. The loss sums -log P(clause
satisfied) over the clauses, weighted over the `iterations` updates by
discount ** (T - 1 - t).

The message sums reduce each variable's incoming messages in a fixed
order (the JAX package's scatter order: per relation, the right ends, then
the left ends), as padded rows summed over one axis: no atomics, so a run
on the card repeats bit for bit. Every random initial state comes from a
generator or is injected (`h0`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from rlsolver_tpu_torch.algos.l2o import LSTMCell
from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense, LayerNorm, lecun_normal
from rlsolver_tpu_torch.optim import ClippedAdam


# ------------------------------------------------------- constraint language
@dataclasses.dataclass(frozen=True)
class ConstraintLanguage:
    """domain_size + relation name -> allowed (u, v) value pairs."""

    domain_size: int
    relations: Dict[str, Tuple[Tuple[int, int], ...]]

    def matrices(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, pairs in self.relations.items():
            m = np.zeros((self.domain_size, self.domain_size), np.float32)
            for a, b in pairs:
                m[a, b] = 1.0
            out[name] = m
        return out

    @staticmethod
    def coloring(d: int) -> "ConstraintLanguage":
        return ConstraintLanguage(d, {"NEQ": tuple((a, b) for a in range(d) for b in range(d) if a != b)})

    @staticmethod
    def maxcut() -> "ConstraintLanguage":
        return ConstraintLanguage(2, {"NEQ": ((0, 1), (1, 0))})

    @staticmethod
    def mis() -> "ConstraintLanguage":
        return ConstraintLanguage(2, {"NAND": ((0, 0), (0, 1), (1, 0))})

    @staticmethod
    def max2sat() -> "ConstraintLanguage":
        """Clause (l1 or l2) with each literal's polarity in the relation:
        OR_pn = (x1 or not x2), and so on."""
        return ConstraintLanguage(2, {
            "OR_pp": ((0, 1), (1, 0), (1, 1)),
            "OR_pn": ((0, 0), (1, 0), (1, 1)),
            "OR_np": ((0, 0), (0, 1), (1, 1)),
            "OR_nn": ((0, 0), (0, 1), (1, 0)),
        })


@dataclasses.dataclass(frozen=True)
class CSPInstance:
    language: ConstraintLanguage
    num_vars: int
    clauses: Dict[str, np.ndarray]  # relation -> [n_r, 2] int32

    @property
    def num_clauses(self) -> int:
        return sum(int(c.shape[0]) for c in self.clauses.values())

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_vars, np.int64)
        for c in self.clauses.values():
            np.add.at(deg, c.reshape(-1), 1)
        return deg

    def count_conflicts(self, assignment: np.ndarray) -> int:
        """The number of violated clauses (`util.py:105`)."""
        mats = self.language.matrices()
        total = 0
        for r, c in self.clauses.items():
            m = mats[r]
            for a, b in c:
                total += int(m[assignment[a], assignment[b]] == 0)
        return total

    @staticmethod
    def generate_random(num_vars: int, num_clauses: int, language: ConstraintLanguage, seed: int = 0) -> "CSPInstance":
        rng = np.random.RandomState(seed)
        names = list(language.relations.keys())
        rel = rng.choice(len(names), num_clauses)
        pairs = np.stack([rng.choice(num_vars, 2, replace=False) for _ in range(num_clauses)]).astype(np.int32)
        clauses = {n: pairs[rel == i] if (rel == i).any() else np.zeros((0, 2), np.int32)
                   for i, n in enumerate(names)}
        return CSPInstance(language, num_vars, clauses)

    @staticmethod
    def from_graph(graph, language: ConstraintLanguage, relation: str) -> "CSPInstance":
        """All of a graph's edges under one relation (`graph_to_csp_instance`)."""
        return CSPInstance(language, graph.num_nodes, {relation: graph.edges.astype(np.int32)})

    @staticmethod
    def generate_xu(num_vars: int, domain: int = 3, density: float = 2.0,
                    seed: int = 0) -> Tuple["CSPInstance", np.ndarray]:
        """A forced-satisfiable hard coloring instance, Model RB style
        (`RUNCSP/generate_xu_instances.py`): a hidden assignment, then
        density * n * ln(n) NEQ constraints between differently assigned
        variables. Returns (instance, hidden assignment)."""
        rng = np.random.RandomState(seed)
        hidden = rng.randint(0, domain, num_vars)
        num_clauses = int(density * num_vars * max(1.0, np.log(num_vars)))
        pairs = set()
        tries = 0
        while len(pairs) < num_clauses and tries < 50 * num_clauses:
            tries += 1
            a, b = rng.randint(0, num_vars, 2)
            if a == b or hidden[a] == hidden[b]:
                continue
            pairs.add((min(a, b), max(a, b)))
        edges = np.asarray(sorted(pairs), np.int32)
        return CSPInstance(ConstraintLanguage.coloring(domain), num_vars, {"NEQ": edges}), hidden


class DeviceInstance:
    """An instance's clauses on the device, and each variable's incoming
    message slots: `slots` [V, max in-degree] indexes the concatenated
    messages (per relation: the messages to the right ends, then to the
    left ends), in that order, with the last index a zero row."""

    def __init__(self, inst: CSPInstance, relation_names: Sequence[str], device):
        self.num_vars = inst.num_vars
        self.clauses = {r: torch.from_numpy(np.asarray(c, np.int64)).to(device) for r, c in inst.clauses.items()}
        self.degrees = torch.from_numpy(inst.degrees().astype(np.float32)).to(device)[:, None]
        targets = []
        for r in relation_names:
            c = np.asarray(inst.clauses.get(r, np.zeros((0, 2))), np.int64).reshape(-1, 2)
            if c.shape[0]:
                targets += [c[:, 1], c[:, 0]]
        tgt = np.concatenate(targets) if targets else np.zeros(0, np.int64)
        order = np.argsort(tgt, kind="stable")
        counts = np.bincount(tgt, minlength=inst.num_vars)
        width = max(1, int(counts.max()) if counts.size else 1)
        slots = np.full((inst.num_vars, width), tgt.size, np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(tgt.size) - np.repeat(starts, counts)
        slots[tgt[order], rank] = order
        self.slots = torch.from_numpy(slots).to(device)


# ---------------------------------------------------------------------- model
class RunCspNetwork(nn.Module):
    """One message-passing update and the readout (applied T times). Names
    as flax's: `{r}_lr`, `{r}_rl` per relation, `norm`, `lstm`, `out`."""

    def __init__(self, domain_size: int, state_size: int = 64, relation_names: Sequence[str] = (), seed: int = 0,
                 device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.domain_size, self.state_size, self.relation_names = domain_size, state_size, tuple(relation_names)
        for r in self.relation_names:
            self.add_module(f"{r}_lr", Dense(state_size + domain_size, state_size, gen))
            self.add_module(f"{r}_rl", Dense(state_size + domain_size, state_size, gen))
        self.norm = LayerNorm(state_size)
        self.lstm = LSTMCell(state_size, state_size, gen)
        self.out = nn.Module()
        self.out.kernel = nn.Parameter(lecun_normal((state_size, domain_size), state_size, gen))
        self.to(resolve_device(device))

    def forward(self, h, c, phi, inst: DeviceInstance):
        """h/c: LSTM states [V, S]; phi: soft assignments [V, D] -> (h, c,
        phi, logits)."""
        msgs = []
        for r in self.relation_names:
            idx = inst.clauses.get(r)
            if idx is None or idx.shape[0] == 0:
                continue
            left, right = idx[:, 0], idx[:, 1]
            msgs.append(getattr(self, f"{r}_lr")(torch.cat([h[left], phi[left]], dim=1)))  # to the right ends
            msgs.append(getattr(self, f"{r}_rl")(torch.cat([h[right], phi[right]], dim=1)))  # to the left ends
        msgs.append(torch.zeros(1, self.state_size, device=h.device))
        msg = torch.cat(msgs)[inst.slots].sum(dim=1)
        msg = self.norm(msg / torch.clamp(inst.degrees, min=1.0))
        # the JAX package hands the cell (h, c) as its carry (c, h) and reads
        # the pair back the same way: h holds the cell state, c its output
        (h, c), _ = self.lstm((h, c), msg)
        logits = h @ self.out.kernel
        return h, c, torch.softmax(logits, dim=-1), logits


@dataclasses.dataclass
class RunCspConfig:
    state_size: int = 64
    iterations: int = 16
    lr: float = 1e-3
    epochs: int = 50
    discount: float = 0.95  # later iterations weigh more
    seed: int = 0


class RunCspSolver:
    """Train / predict harness for one constraint language. The parameters
    are the network's state dict (`params`); `train` returns the trained
    ones, `predict` runs any."""

    def __init__(self, language: ConstraintLanguage, cfg: RunCspConfig = RunCspConfig(), device=None):
        self.language, self.cfg = language, cfg
        self.device = resolve_device(device)
        self.mats = {r: torch.from_numpy(m).to(self.device) for r, m in language.matrices().items()}
        self.model = RunCspNetwork(language.domain_size, cfg.state_size, tuple(language.relations.keys()),
                                   seed=cfg.seed, device=self.device)

    def device_instance(self, inst: CSPInstance) -> DeviceInstance:
        return DeviceInstance(inst, self.model.relation_names, self.device)

    def init_params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def initial_state(self, num_vars: int, gen: Optional[torch.Generator]) -> torch.Tensor:
        """h0 = 0.1 N(0, 1) [V, S]."""
        return torch.randn(num_vars, self.cfg.state_size, generator=gen, device=self.device) * 0.1

    def _unroll(self, params, inst_dev: DeviceInstance, h0: torch.Tensor) -> List[torch.Tensor]:
        h, c = h0, torch.zeros_like(h0)
        d = self.language.domain_size
        phi = torch.full((inst_dev.num_vars, d), 1.0 / d, device=self.device)
        phis = []
        for _ in range(self.cfg.iterations):
            h, c, phi, _ = functional_call(self.model, params, (h, c, phi, inst_dev))
            phis.append(phi)
        return phis

    def loss(self, params, inst_dev: DeviceInstance, h0: torch.Tensor) -> torch.Tensor:
        """The discounted mean over the updates of the clauses' summed
        -log P(satisfied)."""
        phis = self._unroll(params, inst_dev, h0)
        total, weight_sum = 0.0, 0.0
        for t, phi in enumerate(phis):
            w = self.cfg.discount ** (len(phis) - 1 - t)
            viol = 0.0
            for r, idx in inst_dev.clauses.items():
                if idx.shape[0] == 0:
                    continue
                sat_p = torch.einsum("ed,df,ef->e", phi[idx[:, 0]], self.mats[r], phi[idx[:, 1]])
                viol = viol + torch.sum(-torch.log(torch.clamp(sat_p, min=1e-8)))
            total = total + w * viol
            weight_sum += w
        return total / weight_sum

    def train(self, instances: List[CSPInstance], params=None, gen: Optional[torch.Generator] = None,
              h0s: Optional[List[torch.Tensor]] = None,
              cuda_graph: bool = True) -> Tuple[Dict[str, torch.Tensor], List[float]]:
        """Adam on the instances round-robin for `epochs` epochs; each step's
        initial state from `gen` (seeded seed + 1 when None) or, in order,
        from `h0s`. On the card (unless `cuda_graph=False`) each instance's
        step (16 unrolled updates, the loss, its backward and Adam: about
        2,500 small launches) is one CUDA graph replay
        (`capture.CapturedCall`).
        Returns (params, each epoch's last loss)."""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in (params if params is not None else self.init_params()).items()}
        names = list(params)
        opt = ClippedAdam([params[k] for k in names], self.cfg.lr, max_norm=None)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed + 1)
        devs = [self.device_instance(inst) for inst in instances]

        def update(inst_dev, h0, corr):
            opt.zero_grad()
            loss = self.loss(params, inst_dev, h0)
            loss.backward()
            opt.step(corr=corr)
            return loss.detach()

        calls = [CapturedCall(functools.partial(update, d), cuda_graph, restore=opt.state_tensors()) for d in devs]
        history, step = [], 0
        for _ in range(self.cfg.epochs):
            for i, inst_dev in enumerate(devs):
                h0 = h0s[step].to(self.device) if h0s is not None else self.initial_state(inst_dev.num_vars, gen)
                loss = calls[i](h0, opt.corrections())
                step += 1
            history.append(float(loss))
        return {k: v.detach() for k, v in params.items()}, history

    @torch.no_grad()
    def predict(self, params, inst: CSPInstance, gen: Optional[torch.Generator] = None,
                h0: Optional[torch.Tensor] = None) -> np.ndarray:
        """The argmax assignment after the last update, from h0 (drawn from
        `gen`, seeded 0 when None, unless given)."""
        if h0 is None:
            if gen is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(0)
            h0 = self.initial_state(inst.num_vars, gen)
        phis = self._unroll(params, self.device_instance(inst), h0.to(self.device))
        return phis[-1].argmax(dim=-1).cpu().numpy()

    def boosted_predict(self, params, inst: CSPInstance, num_boosts: int = 8) -> Tuple[np.ndarray, int]:
        """`num_boosts` random initial states (generators seeded 100 + i),
        keeping the assignment with the fewest conflicts
        (`RUN_CSP.boosted_predict`)."""
        best, best_conf = None, None
        for i in range(num_boosts):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(100 + i)
            a = self.predict(params, inst, gen)
            conf = inst.count_conflicts(a)
            if best_conf is None or conf < best_conf:
                best, best_conf = a, conf
        return best, best_conf
