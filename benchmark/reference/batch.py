"""Plain PyTorch reference of batched MCPG's round: G graphs of one node
count at once, each with its own policy row, incumbents and budget, as
RLSolver's `MCPG.py` runs one instance (its `metro_sampling`, sequential
sweeps and REINFORCE step), at a precision given by `dtype`.

The round's randomness is torch's generator, drawn in the solver's order:
the MH proposals' nodes [T, G, B] and uniforms [T, G, B], then each
sweep's uniforms [N, G, B]; `draws` reproduces them from the generator's
state at the round's start.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

NOISE_SCALE = 0.25


class Graphs:
    """G unit-weight graphs of n nodes: each graph's descending-degree order
    (stable, ties by id), neighbour lists padded with the sentinel node n,
    and edges for the exact cut."""

    def __init__(self, edge_sets: Sequence[np.ndarray], n: int, device):
        self.n, self.num = n, len(edge_sets)
        deg = np.zeros((self.num, n), np.int64)
        lists = []
        for g, e in enumerate(edge_sets):
            np.add.at(deg[g], e[:, 0], 1)
            np.add.at(deg[g], e[:, 1], 1)
            nb = [[] for _ in range(n)]
            for a, b in e:
                nb[a].append(b)
                nb[b].append(a)
            lists.append(nb)
        width = int(deg.max())
        pad = np.full((self.num, n, width), n, np.int64)
        for g, nb in enumerate(lists):
            for i, row in enumerate(nb):
                pad[g, i, : len(row)] = row
        self.nbrs = torch.from_numpy(pad).to(device)
        self.wdeg = torch.from_numpy(deg.astype(np.float32)).to(device)
        self.order = torch.from_numpy(np.stack([np.argsort(-d, kind="stable") for d in deg])).to(device)
        self.edges = [torch.from_numpy(e).to(device) for e in edge_sets]
        self.total = torch.tensor([float(e.shape[0]) for e in edge_sets], device=device)


def draws(state: torch.Tensor, shape: Tuple[int, int, int], rounds: int, sweeps: int, device):
    """(nodes int64 [T, G, B], u [T, G, B], sweep uniforms [S, N, G, B])
    from a generator at `state`, in the solver's order."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    g, b, n = shape
    nodes = torch.randint(0, n, (rounds, g, b), generator=gen, device=device)
    u = torch.rand(rounds, g, b, generator=gen, device=device)
    su = torch.stack([torch.rand(n, g, b, generator=gen, device=device) for _ in range(sweeps)])
    return nodes, u, su


def probs_of(logits: torch.Tensor, dtype) -> torch.Tensor:
    return torch.sigmoid(logits.to(dtype)) * 0.6 + 0.2


def mh(bits: torch.Tensor, probs: torch.Tensor, nodes: torch.Tensor, u: torch.Tensor, change_times: int,
       dtype=torch.float32) -> torch.Tensor:
    """MH rounds on bits bool [G, B, N] toward probs [G, N]: propose node,
    accept when u < (1 - q) / q, q = P(current bit); a graph stops
    accepting once it has accepted B * change_times flips (checked before
    each round)."""
    x = bits.clone()
    g, b, _ = x.shape
    budget = b * change_times
    cnt = torch.zeros(g, dtype=torch.int64, device=x.device)
    p_all = probs.to(dtype)
    u = u.to(dtype)
    for t in range(nodes.shape[0]):
        node = nodes[t]
        p = torch.gather(p_all, 1, node)
        cur = torch.gather(x, 2, node[:, :, None])[:, :, 0]
        q = torch.where(cur, p, 1.0 - p)
        accept = (u[t] < (1.0 - q) / q) & (cnt < budget)[:, None]
        x.scatter_(2, node[:, :, None], (cur ^ accept)[:, :, None])
        cnt += accept.sum(dim=1)
    return x


def sweeps(bits: torch.Tensor, gs: Graphs, su: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Degree-ordered sweeps of bits bool [G, B, N], one a row of su [S, N,
    G, B]: step k sets each graph's k-th node to [sum of its neighbours +
    0.25 u < (deg + 0.25) / 2], an unvisited neighbour counting 2x - 0.5
    until the first sweep sets it."""
    g, b, n = bits.shape
    g_ax = torch.arange(g, device=bits.device)
    xn = torch.zeros(g, n + 1, b, dtype=dtype, device=bits.device)  # node-major, row n the sentinel 0
    xn[:, :n] = bits.transpose(1, 2).to(dtype) * 2.0 - 0.5
    thr = ((gs.wdeg + NOISE_SCALE) / 2.0).to(dtype)
    for s in range(su.shape[0]):
        u = su[s].to(dtype)
        for k in range(n):
            node = gs.order[:, k]
            vals = xn[g_ax[:, None], gs.nbrs[g_ax, node]]  # [G, D, B]
            nbr = vals.sum(dim=1)
            new = (nbr + u[k] * NOISE_SCALE) < thr[g_ax, node][:, None]
            xn[g_ax, node] = new.to(dtype)
    return xn[:, :n].transpose(1, 2) > 0.5


def cuts(bits: torch.Tensor, gs: Graphs) -> torch.Tensor:
    """Exact cuts of bits bool [G, B, N], float64 [G, B]."""
    return torch.stack([(bits[i][:, e[:, 0]] != bits[i][:, e[:, 1]]).sum(dim=1) for i, e in enumerate(gs.edges)]
                       ).to(torch.float64)


def cuts_at(bits: torch.Tensor, gs: Graphs, dtype) -> torch.Tensor:
    """Cuts at a lower precision: (W - s A s / 2) / 2 with the products in it."""
    s = bits.to(dtype) * 2.0 - 1.0
    out = []
    for i, e in enumerate(gs.edges):
        a = torch.zeros(gs.n, gs.n, dtype=dtype, device=bits.device)
        a[e[:, 0], e[:, 1]] = 1.0
        a[e[:, 1], e[:, 0]] = 1.0
        quad = torch.sum((s[i] @ a) * s[i], dim=1)
        out.append(((gs.total[i].to(dtype) - quad / 2.0) / 2.0).to(torch.float64))
    return torch.stack(out)


def reduce(ls_bits: torch.Tensor, cut: torch.Tensor, best_xs: torch.Tensor, best_vs: torch.Tensor, repeats: int):
    """Per graph: best of repeats (row r C + c, ties to the first), the
    strictly better of it and the incumbent, the worst incumbent <- the best.
    Returns (best_xs [G, C, N], best_vs [G, C], chain_xs [G, C, N])."""
    g, _, n = ls_bits.shape
    c = best_xs.shape[1]
    g_ax = torch.arange(g, device=ls_bits.device)
    best_r = torch.argmax(cut.reshape(g, repeats, c), dim=1)
    rows = best_r * c + torch.arange(c, device=ls_bits.device)
    chain_xs, chain_vs = ls_bits[g_ax[:, None], rows], cut[g_ax[:, None], rows]
    better = chain_vs > best_vs
    xs = torch.where(better[:, :, None], chain_xs, best_xs)
    vs = torch.where(better, chain_vs, best_vs)
    top, worst = torch.argmax(vs, dim=1), torch.argmin(vs, dim=1)
    xs[g_ax, worst] = xs[g_ax, top]
    vs[g_ax, worst] = vs[g_ax, top]
    return xs, vs, chain_xs


def adam_update(logits: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int, mh_bits: torch.Tensor,
                cut: torch.Tensor, total: torch.Tensor, steps: int, lr: float, dtype=torch.float32) -> torch.Tensor:
    """`steps` steps of clip-by-global-norm(1.0) and Adam(lr) on
    sum_g sum_n A log p + (V - A) log(1 - p) over B, A = value @ bits and V
    = sum(value) per graph, value = total - 2 cut centred per graph.
    Returns the logits [G, N] after and the first step's gradient as the
    clip leaves it."""
    energy = total[:, None].to(dtype) - 2.0 * cut.to(dtype)
    value = energy - energy.mean(dim=1, keepdim=True)
    a = torch.bmm(value[:, None, :], mh_bits.to(dtype))[:, 0]
    v = value.sum(dim=1, keepdim=True)
    batch = mh_bits.shape[1]
    lg, mu, nu = logits.to(dtype).clone(), mu.to(dtype).clone(), nu.to(dtype).clone()
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
