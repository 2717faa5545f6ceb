"""Learning-to-optimize maxcut solvers: seq2seq REINFORCE and the k_spin
L2O-LSTM (counterpart of `rlsolver_tpu/algos/l2o.py`).

  * seq2seq (RLSolver's `methods/seq2seq/main.py:34-90`): an LSTM re-reads
    its own sampled solution each step and emits per-node Bernoulli probs,
    trained by REINFORCE with the batch-centred cut as advantage;
  * L2O (`methods/k_spin/k_spin_Ising.py:37-90`, `net.py:21-32`): an LSTM
    iterates a relaxed solution, trained by backpropagation through the
    whole `episode_length`-step trajectory of the expected cut plus a
    coupling to the previous solution, discounted by gamma.

The LSTM is flax's `OptimizedLSTMCell` with its parameter layout: gates i,
f, g, o, input-side kernels `ii`..`io` without bias, hidden-side kernels
and biases `hi`..`ho`, the carry (c, h) starting at zero. The randomness
(seq2seq's first sample and each step's Bernoulli uniforms, L2O's start
points) comes from a generator or injected (`Seq2SeqDraws`, `L2ODraws`).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense, lecun_normal
from rlsolver_tpu_torch.ops import cut as cut_ops
from rlsolver_tpu_torch.optim import ClippedAdam


def expected_cut(probs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """E[cut] [B] for independent Bernoulli(probs [B, N]) nodes on the
    symmetric dense adj: sum_i p_i wdeg_i - sum_ij p_i A_ij p_j."""
    lin = probs @ adj.sum(dim=1)
    quad = torch.einsum("bi,ij,bj->b", probs, adj, probs)
    return lin - quad


def _orthogonal(n_in: int, n_out: int, gen: torch.Generator) -> torch.Tensor:
    """flax's orthogonal initializer for an [in, out] kernel (a QR of a
    normal draw, signs fixed by R's diagonal)."""
    a = torch.randn(max(n_in, n_out), min(n_in, n_out), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if n_in >= n_out else q.T).to(torch.float32)


class LSTMCell(nn.Module):
    """flax `OptimizedLSTMCell(features)`: (c, h), x -> (c', h')."""

    def __init__(self, in_features: int, features: int, gen: torch.Generator):
        super().__init__()
        for g in "ifgo":
            self.add_module(f"i{g}", _NoBias(lecun_normal((in_features, features), in_features, gen)))
            self.add_module(f"h{g}", Dense(features, features, gen))
            getattr(self, f"h{g}").kernel.data = _orthogonal(features, features, gen)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        c, h = carry
        i = torch.sigmoid(self.hi(h) + self.ii(x))
        f = torch.sigmoid(self.hf(h) + self.if_(x))
        g = torch.tanh(self.hg(h) + self.ig(x))
        o = torch.sigmoid(self.ho(h) + self.io(x))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h

    @property
    def if_(self) -> nn.Module:  # `if` is a keyword
        return getattr(self, "if")


class _NoBias(nn.Module):
    """flax `Dense(use_bias=False)`'s kernel [in, out]."""

    def __init__(self, kernel: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel


class SolverLSTM(nn.Module):
    """The LSTM over the whole solution vector -> per-node probabilities,
    squashed away from {0, 1} (`seq2seq/main.py:34-52`, `k_spin/net.py`)."""

    def __init__(self, num_nodes: int, hidden: int = 256, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.num_nodes, self.hidden = num_nodes, hidden
        self.lstm = LSTMCell(num_nodes, hidden, gen)
        self.out = Dense(hidden, num_nodes, gen)
        self.to(resolve_device(device))

    def init_carry(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.out.kernel.device
        return torch.zeros(batch, self.hidden, device=dev), torch.zeros(batch, self.hidden, device=dev)

    def forward(self, carry, x: torch.Tensor):
        carry, h = self.lstm(carry, x)
        probs = torch.sigmoid(self.out(h))
        return carry, (probs - 0.5) * 0.999999 + 0.5  # `main.py:50`


# ----------------------------------------------------------------- seq2seq
@dataclasses.dataclass
class Seq2SeqConfig:
    num_envs: int = 64
    num_steps: int = 200
    hidden: int = 256
    lr: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0


class Seq2SeqDraws(NamedTuple):
    """The first sample bool [E, N] and each step's Bernoulli uniforms
    [T, E, N] (a step samples u < probs)."""

    sample0: torch.Tensor
    u: torch.Tensor


def solve_maxcut_seq2seq(graph: Graph, cfg: Seq2SeqConfig = Seq2SeqConfig(), device=None,
                         model: Optional[SolverLSTM] = None,
                         draws: Optional[Seq2SeqDraws] = None) -> Tuple[np.ndarray, float, List[dict]]:
    """REINFORCE training loop; returns (best bits, best cut, history of
    each step's loss and largest cut). `model` (e.g. carrying the JAX
    package's weights) replaces the one initialised from `cfg.seed`."""
    dev = resolve_device(device)
    model = model if model is not None else SolverLSTM(graph.num_nodes, cfg.hidden, seed=cfg.seed, device=dev)
    opt = ClippedAdam(model.parameters(), cfg.lr, max_norm=cfg.grad_clip)
    cg = cut_ops.CutGraph.build(graph, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    e, n = cfg.num_envs, graph.num_nodes
    sample = draws.sample0.to(dev) if draws is not None else torch.rand(e, n, generator=gen, device=dev) < 0.5
    carry = model.init_carry(e)
    best_cut, best_bits, history = -np.inf, None, []
    for t in range(cfg.num_steps):
        new_carry, probs = model(carry, sample.float())
        u = draws.u[t].to(dev) if draws is not None else torch.rand(e, n, generator=gen, device=dev)
        new_sample = u < probs.detach()
        cuts = cut_ops.cut_value(new_sample, cg)
        adv = cuts - cuts.mean()
        s = new_sample.float()
        logp = torch.log(s * probs + (1.0 - s) * (1.0 - probs)).sum(dim=1)
        loss = -torch.mean(adv.detach() * logp)  # maximise E[adv logp] (`get_return`, `main.py:65-69`)
        opt.zero_grad()
        loss.backward()
        opt.step()
        carry = (new_carry[0].detach(), new_carry[1].detach())
        sample = new_sample
        k = int(torch.argmax(cuts))
        c = float(cuts[k])
        if c > best_cut:
            best_cut, best_bits = c, sample[k].cpu().numpy()
        history.append({"loss": float(loss.detach()), "max_cut": c})
    return best_bits, best_cut, history


# --------------------------------------------------------------------- L2O
@dataclasses.dataclass
class L2OConfig:
    num_envs: int = 64
    episode_length: int = 16
    num_epochs: int = 100
    hidden: int = 256
    lr: float = 1e-4
    coupling: float = 0.2  # the consecutive-solution coupling's weight
    gamma: float = 0.98
    seed: int = 0


class L2ODraws(NamedTuple):
    """Each epoch's start points, uniform [num_epochs, E, N]."""

    start: torch.Tensor


def solve_maxcut_l2o(graph: Graph, cfg: L2OConfig = L2OConfig(), device=None, model: Optional[SolverLSTM] = None,
                     draws: Optional[L2ODraws] = None, cuda_graph: bool = True) -> Tuple[np.ndarray, float, List[dict]]:
    """Train an LSTM optimizer by backpropagation through the relaxed
    objective along its trajectory (`k_spin_Ising.py:51-80`). Returns (best
    bits, best cut, history of each epoch's loss and largest cut). On the
    card (unless `cuda_graph=False`) an epoch's trajectory, backward and
    Adam step is one CUDA graph replay (`capture.CapturedCall`)."""
    dev = resolve_device(device)
    adj = torch.from_numpy(graph.adjacency_dense()).to(dev)
    deg = adj.sum(dim=1)
    model = model if model is not None else SolverLSTM(graph.num_nodes, cfg.hidden, seed=cfg.seed, device=dev)
    opt = ClippedAdam(model.parameters(), cfg.lr, max_norm=1.0)
    cg = cut_ops.CutGraph.build(graph, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    e, n, length = cfg.num_envs, graph.num_nodes, cfg.episode_length
    # gamma ** (L-1 .. 0), each a float32 `powf` as XLA computes the power
    discounts = torch.from_numpy(np.array([np.float32(cfg.gamma) ** np.float32(k)
                                           for k in range(length - 1, -1, -1)], np.float32)).to(dev)

    def cross_cut(p_prev, p_cur):
        """Expected cut between two relaxed solutions (RLSolver's
        `calc_obj_for_two_graphs_vmap`)."""
        return (p_prev + p_cur) @ deg / 2.0 - torch.einsum("bi,ij,bj->b", p_prev, adj, p_cur)

    def update(x_prev, corr):
        opt.zero_grad()
        carry, objs = model.init_carry(e), []
        for _ in range(length):
            carry, x = model(carry, x_prev)
            objs.append(expected_cut(x, adj) + cfg.coupling * cross_cut(x_prev.detach(), x))
            x_prev = x
        loss = -torch.mean(torch.stack(objs) * discounts[:, None])
        loss.backward()
        opt.step(corr=corr)
        return loss.detach(), x_prev.detach()

    update_call = CapturedCall(update, cuda_graph, restore=opt.state_tensors())
    best_cut, best_bits, history = -np.inf, None, []
    for ep in range(cfg.num_epochs):
        start = draws.start[ep].to(dev) if draws is not None else torch.rand(e, n, generator=gen, device=dev)
        loss, x_last = update_call(start, opt.corrections())
        bits = x_last > 0.5
        cuts = cut_ops.cut_value(bits, cg)
        k = int(torch.argmax(cuts))
        c = float(cuts[k])
        if c > best_cut:
            best_cut, best_bits = c, bits[k].cpu().numpy()
        history.append({"loss": float(loss), "max_cut": c})
    return best_bits, best_cut, history
