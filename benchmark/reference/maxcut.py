"""Plain PyTorch reference of MCPG's round on max-cut (Chen et al., "Monte
Carlo Policy Gradient Method for Binary Optimization"; RLSolver's
`MCPG.py`), at a precision given by `dtype`: float32 is the reference, a
lower one is the control that the comparison has to fail.

Each function is one stage of a round, written from the algorithm's
definition with no tables, kernels or packing:
  * `mh_fused`: Metropolis bit-flip proposals toward Bernoulli(probs), a
    proposal from one Philox draw (node = (hi16 * N) >> 16, a u16 uniform
    from the low 16 bits) accepted when u16 < threshold[current bit];
  * `noisy_sweep`: degree-ordered sweeps, x_i = [nbr + u16 * 0.25 / 65536 <
    thr + 0.125], where in the first sweep unvisited neighbours count 2x - 0.5;
  * `flip_sweep`: the greedy 1-flip sweep, ascending nodes, strict gains;
  * `reduce`: best of repeats, the elitist update, the worst chain <- the best;
  * `adam_update`: REINFORCE with the centred energy as the value, clipped
    Adam as optax chains `clip_by_global_norm(1.0)` and `adam`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference import philox

NOISE_SCALE = 0.25


class Graph:
    """A unit-weight graph's dense adjacency and degree order on a device."""

    def __init__(self, edges: np.ndarray, n: int, device):
        self.n = n
        self.edges = torch.as_tensor(edges, dtype=torch.int64, device=device)
        adj = np.zeros((n, n), np.float32)
        adj[edges[:, 0], edges[:, 1]] = 1.0
        adj[edges[:, 1], edges[:, 0]] = 1.0
        self.adj_np = adj
        self.adj = torch.from_numpy(adj).to(device)
        self.wdeg = adj.sum(axis=1)  # exact integers
        self.order = np.argsort(-self.wdeg, kind="stable")  # the sweep order; ties by node id
        self.total = float(edges.shape[0])


def thresholds(probs: torch.Tensor, dtype) -> torch.Tensor:
    """[.., 2, N] accept thresholds scaled to u16: row c given current bit c."""
    p = probs.to(dtype)
    t0 = torch.clamp(p / torch.clamp(1.0 - p, min=1e-9) * 65536.0, 0.0, 65536.0)
    t1 = torch.clamp((1.0 - p) / torch.clamp(p, min=1e-9) * 65536.0, 0.0, 65536.0)
    return torch.stack([t0, t1], dim=-2)


def mh_fused(bits: torch.Tensor, thr: torch.Tensor, seeds: torch.Tensor, chains: torch.Tensor, rounds: int,
             dtype=torch.float32) -> torch.Tensor:
    """`rounds` proposals on each row of bits bool [K, N]; row i is chain
    `chains[i]` drawing under `seeds[i]`, thresholds thr [K, 2, N]."""
    k, n = bits.shape
    if n >= 1 << 15:
        raise ValueError("the one-draw proposal rule holds below 2^15 nodes")
    d = philox.draws(seeds, chains, philox.TAG_MH, rounds)
    node = ((d >> 16) * n) >> 16
    u = (d & 0xFFFF).to(dtype)
    x = bits.clone()
    rows = torch.arange(k, device=bits.device)
    for r in range(rounds):
        nd = node[r]
        cur = x[rows, nd]
        acc = u[r] < thr[rows, cur.long(), nd]
        x[rows, nd] = cur ^ acc
    return x


def noisy_sweep(bits: torch.Tensor, g: Graph, seeds: torch.Tensor, chains: torch.Tensor, num_sweeps: int,
                dtype=torch.float32) -> torch.Tensor:
    """`num_sweeps` noisy degree-ordered sweeps of bits bool [K, N], step t =
    s N + k drawing word t of its row's Philox stream."""
    n = g.n
    dev = bits.device
    pos = np.empty(n, np.int64)
    pos[g.order] = np.arange(n)
    rows = g.adj_np[g.order]  # [step, node]
    earlier = pos[None, :] < np.arange(n)[:, None]
    c1 = torch.from_numpy(rows * np.where(earlier, 1.0, 2.0)).to(dev, dtype)
    c2 = torch.from_numpy(rows).to(dev, dtype)
    unvisited = (rows * ~earlier).sum(axis=1)
    base = g.wdeg[g.order].astype(np.float64) / 2.0
    half = torch.tensor(NOISE_SCALE / 2.0, dtype=dtype, device=dev)
    thr1 = torch.from_numpy((base + 0.5 * unvisited).astype(np.float32)).to(dev, dtype) + half
    thr2 = torch.from_numpy(base.astype(np.float32)).to(dev, dtype) + half
    scale = torch.tensor(NOISE_SCALE / 65536.0, dtype=dtype, device=dev)
    d = philox.draws(seeds, chains, philox.TAG_SWEEP, num_sweeps * n)
    u = (d & 0xFFFF).to(dtype)
    del d
    x = bits.to(dtype)
    nodes = torch.from_numpy(g.order.astype(np.int64)).to(dev)
    for t in range(num_sweeps * n):
        k = t % n
        first = t < n
        nbr = x @ (c1[k] if first else c2[k])
        new = (nbr + u[t] * scale) < (thr1 if first else thr2)[k]
        x[:, nodes[k]] = new.to(dtype)
    return x > 0.5


def flip_sweep(bits: torch.Tensor, g: Graph, dtype=torch.float32) -> torch.Tensor:
    """One greedy 1-flip sweep of bits bool [K, N]: node i flips when
    s_i (A s)_i > 0, nodes in ascending order."""
    s = bits.to(dtype) * 2.0 - 1.0
    adj = g.adj.to(dtype)
    for i in range(g.n):
        gain = s[:, i] * (s @ adj[i])
        s[:, i] = torch.where(gain > 0, -s[:, i], s[:, i])
    return s > 0


def cuts(bits: torch.Tensor, g: Graph, dtype=torch.float32, block: int = 1 << 14) -> torch.Tensor:
    """Cut values of bits bool [B, N]: exact edge counts (int64) for float32,
    and at a lower precision the dense form (W - s A s / 2) / 2 in it."""
    out = []
    for i in range(0, bits.shape[0], block):
        b = bits[i : i + block]
        if dtype == torch.float32:
            out.append((b[:, g.edges[:, 0]] != b[:, g.edges[:, 1]]).sum(dim=1))
        else:
            s = b.to(dtype) * 2.0 - 1.0
            quad = torch.sum((s @ g.adj.to(dtype)) * s, dim=1)
            out.append(((g.total - quad / 2.0) / 2.0).to(torch.float64))
    return torch.cat(out).to(torch.float64)


def reduce(ls_bits: torch.Tensor, cut: torch.Tensor, best_xs: torch.Tensor, best_vs: torch.Tensor,
           repeats: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_xs [C, N], best_vs [C], chain_xs [C, N]) after one round:
    the best of each chain's repeats (row r C + c; ties to the first), the
    strictly better of that and the incumbent, then the worst incumbent
    takes a copy of the best (first of ties each)."""
    c = best_xs.shape[0]
    v = cut.reshape(repeats, c)
    best_r = torch.argmax(v, dim=0)
    rows = best_r * c + torch.arange(c, device=v.device)
    chain_xs, chain_vs = ls_bits[rows], cut[rows]
    better = chain_vs > best_vs
    xs = torch.where(better[:, None], chain_xs, best_xs)
    vs = torch.where(better, chain_vs, best_vs)
    top, worst = int(torch.argmax(vs)), int(torch.argmin(vs))
    xs[worst] = xs[top]
    vs[worst] = vs[top]
    return xs, vs, chain_xs


def policy_probs(logits: torch.Tensor) -> torch.Tensor:
    """The policy's probabilities: the squashed sigmoid 0.6 sigma(l) + 0.2."""
    return torch.sigmoid(logits) * 0.6 + 0.2


def value_statistics(mh: torch.Tensor, cut: torch.Tensor, total: float, dtype=torch.float32,
                     block: int = 1 << 18) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = value @ bits [N] and V = sum(value), value the centred energy
    total - 2 cut (shape [B]), accumulated a block of rows at a time."""
    energy = total - 2.0 * cut.to(dtype)
    value = energy - energy.mean()
    a = torch.zeros(mh.shape[-1], dtype=dtype, device=mh.device)
    for i in range(0, mh.shape[-2], block):
        a += value[..., i : i + block] @ mh[..., i : i + block, :].to(dtype)
    return a, value.sum(dim=-1)


def adam_update(logits: torch.Tensor, state: Dict, a: torch.Tensor, v: torch.Tensor, batch: int, steps: int,
                lr: float, dtype=torch.float32) -> torch.Tensor:
    """`steps` steps of clip-by-global-norm(1.0) then Adam(lr, 0.9, 0.999,
    1e-8) on sum_n A log p + (V - A) log(1 - p) over `batch`, p the squashed
    sigmoid 0.6 sigma(l) + 0.2, from logits and the Adam state
    {"count", "mu", "nu"}. Returns the logits after and the first step's
    gradient as the clip leaves it."""
    lg = logits.detach().to(dtype).clone()
    mu, nu = (state[k].detach().to(dtype).clone() for k in ("mu", "nu"))
    count = int(state["count"])
    a, v = a.to(dtype), v.to(dtype)
    first = None
    for _ in range(steps):
        lv = lg.clone().requires_grad_(True)
        p = torch.sigmoid(lv) * 0.6 + 0.2
        loss = torch.sum(a * torch.log(p) + (v - a) * torch.log(1.0 - p)) / batch
        (grad,) = torch.autograd.grad(loss, lv)
        norm = torch.sqrt(torch.sum(grad * grad))
        if float(norm) >= 1.0:
            grad = grad / norm
        if first is None:
            first = grad
        count += 1
        c1, c2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
        mu = 0.9 * mu + 0.1 * grad
        nu = 0.999 * nu + 0.001 * grad * grad
        lg = lg - lr * (mu / c1) / (torch.sqrt(nu / c2) + 1e-8)
    return lg.to(torch.float32), first.to(torch.float32)
