"""Knapsack solvers (counterpart of `rlsolver_tpu/classical/knapsack.py`;
RLSolver's `methods_problem_specific/knapsack/`): greedy, FPTAS and
branch and bound on the host (sequential, as in the JAX package); dynamic
programming, brute force and batched simulated annealing on the device.

The DP keeps one f32 row over the capacities and takes one shift-max of it
per item (the JAX package's `lax.scan`; a Python loop here), then
backtracks on the host through the stacked rows. On integer weights and
profits whose sums stay below 2^24 every entry is exact in f32.

Every solver returns a feasible (bits [n] bool, total profit).
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.classical.simulated_annealing import AnnealDraws
from rlsolver_tpu_torch.core.io import KnapsackInstance
from rlsolver_tpu_torch.device import resolve_device


def _as_arrays(inst: KnapsackInstance):
    w = np.asarray(inst.weights, np.float64)
    p = np.asarray(inst.profits, np.float64)
    return w, p, float(inst.capacity)


def greedy_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Profit-density greedy (`knapsack/greedy.py`)."""
    w, p, cap = _as_arrays(inst)
    order = np.argsort(-p / np.maximum(w, 1e-12))
    bits = np.zeros(len(w), bool)
    total = 0.0
    for i in order:
        if total + w[i] <= cap:
            bits[i] = True
            total += w[i]
    return bits, float(p[bits].sum())


def dp_knapsack(inst: KnapsackInstance, device=None) -> Tuple[np.ndarray, float]:
    """Exact DP over the integer capacities 0..cap (`knapsack/dynamic_programming.py`):
    row_i[c] = max(row_{i-1}[c], row_{i-1}[c - w_i] + p_i), one vector
    shift-max per item on the device, then the host backtrack."""
    dev = resolve_device(device)
    w, p, cap = _as_arrays(inst)
    cap = int(cap)
    wi = np.rint(w).astype(np.int64)
    c = torch.arange(cap + 1, device=dev)
    table = torch.zeros(cap + 1, dtype=torch.float32, device=dev)
    rows = [table]
    for iw, ip in zip(wi.tolist(), np.float32(p).tolist()):
        # taking the item: the row rolled by its weight, wrapped entries masked
        shifted = torch.where(c >= iw, torch.roll(table, iw) + ip, -torch.inf)
        table = torch.maximum(table, shifted)
        rows.append(table)
    tables = torch.stack(rows).cpu().numpy()  # [n + 1, cap + 1]

    n = len(w)
    bits = np.zeros(n, bool)
    ccur = cap
    for i in range(n - 1, -1, -1):
        if tables[i + 1, ccur] > tables[i, ccur] + 1e-9:
            bits[i] = True
            ccur -= int(wi[i])
    return bits, float(p[bits].sum())


def fptas_knapsack(inst: KnapsackInstance, eps: float = 0.1) -> Tuple[np.ndarray, float]:
    """FPTAS (`knapsack/fptas.py`): profits scaled down by eps * pmax / n,
    a DP of the least weight for each scaled profit, the best feasible
    level; at least (1 - eps) of the optimum."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    pmax = p.max(initial=0.0)
    if pmax <= 0:
        return np.zeros(n, bool), 0.0
    k = eps * pmax / n
    ps = np.floor(p / k).astype(np.int64)
    psum = int(ps.sum())
    dp = np.full(psum + 1, np.inf)  # dp[v] = least weight of scaled profit v
    dp[0] = 0.0
    choice = np.zeros((n, psum + 1), bool)
    reach = np.cumsum(ps)  # the levels items 0..i can reach; dp is inf above
    for i in range(n):
        # taking item i moves level v - ps[i] to v, for ps[i] <= v <= reach[i]
        # (every other level keeps its entry); in place, with `take` read from
        # the old row before any entry changes
        s, hi = ps[i], reach[i] + 1
        take = dp[: hi - s] + w[i]
        better = take < dp[s:hi]
        choice[i, s:hi] = better
        np.copyto(dp[s:hi], take, where=better)
    v = int(np.where(dp <= cap)[0].max())
    bits = np.zeros(n, bool)
    for i in range(n - 1, -1, -1):
        if choice[i, v]:
            bits[i] = True
            v -= ps[i]
    return bits, float(p[bits].sum())


def brute_force_knapsack(inst: KnapsackInstance, device=None) -> Tuple[np.ndarray, float]:
    """Every one of the 2^n subsets at once on the device
    (`knapsack/brute_force.py`); n <= 24. Ties go to the lowest code."""
    dev = resolve_device(device)
    w, p, cap = _as_arrays(inst)
    n = len(w)
    if n > 24:
        raise ValueError("brute force limited to n <= 24")
    codes = torch.arange(2**n, device=dev)
    bits = ((codes[:, None] >> torch.arange(n, device=dev)) & 1).to(torch.float32)
    tw = bits @ torch.from_numpy(np.float32(w)).to(dev)
    tp = bits @ torch.from_numpy(np.float32(p)).to(dev)
    tp = torch.where(tw <= torch.tensor(np.float32(cap + 1e-9), device=dev), tp, -torch.inf)
    best = int(torch.argmax(tp))
    sel = np.asarray((best >> np.arange(n)) & 1, bool)
    return sel, float(p[sel].sum())


def branch_and_bound_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Best-first branch and bound with the fractional relaxation as the
    bound (`knapsack/branch_and_bound.py`)."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    order = np.argsort(-p / np.maximum(w, 1e-12))
    ws, ps = w[order], p[order]

    def bound(i, profit, room):
        b = profit
        while i < n and ws[i] <= room:
            room -= ws[i]
            b += ps[i]
            i += 1
        if i < n and room > 0:
            b += ps[i] * room / ws[i]
        return b

    best_profit = 0.0
    best_sel = np.zeros(n, bool)
    heap = [(-bound(0, 0.0, cap), 0, 0.0, cap, ())]  # (-bound, i, profit, room, chosen)
    while heap:
        nb, i, profit, room, chosen = heapq.heappop(heap)
        if -nb <= best_profit + 1e-12 or i == n:
            continue
        if ws[i] <= room:  # take item i
            np_, nr = profit + ps[i], room - ws[i]
            nc = chosen + (i,)
            if np_ > best_profit:
                best_profit = np_
                best_sel = np.zeros(n, bool)
                best_sel[list(nc)] = True
            heapq.heappush(heap, (-bound(i + 1, np_, nr), i + 1, np_, nr, nc))
        b = bound(i + 1, profit, room)  # skip item i
        if b > best_profit + 1e-12:
            heapq.heappush(heap, (-b, i + 1, profit, room, chosen))

    bits = np.zeros(n, bool)
    bits[order[best_sel]] = True
    return bits, float(best_profit)


def sa_knapsack(inst: KnapsackInstance, seed: int = 0, num_chains: int = 256, num_steps: int = 2000,
                t0: float = 1.0, t1: float = 0.01, device=None,
                draws: Optional[AnnealDraws] = None) -> Tuple[np.ndarray, float]:
    """Batched simulated annealing (`knapsack/simulated_annealing.py`): the
    chains start empty; each step proposes one uniform item flip, rejects
    it over the capacity, else accepts by the Metropolis rule under the
    geometric schedule t0 (t1 / t0)^(k / (T - 1)) times the largest profit
    (numpy's float64 values cast to f32, as the JAX package's). `draws`
    (its `nodes` [T, B] and `u` [T, B]; `xs0` is not read) replaces the
    generator's."""
    dev = resolve_device(device)
    w, p, cap = _as_arrays(inst)
    n = len(w)
    wj = torch.from_numpy(np.float32(w)).to(dev)
    pj = torch.from_numpy(np.float32(p)).to(dev)
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        idx_all = torch.randint(0, n, (num_steps, num_chains), generator=gen, device=dev)
        u_all = torch.rand(num_steps, num_chains, generator=gen, device=dev)
    else:
        idx_all = torch.as_tensor(draws.nodes, device=dev).long()
        u_all = torch.as_tensor(draws.u, device=dev).float()
    temps = np.asarray(t0 * (t1 / t0) ** (np.arange(num_steps) / max(1, num_steps - 1)), np.float32)
    temps = torch.from_numpy(temps * np.float32(p.max(initial=1.0))).to(dev)
    limit = torch.tensor(np.float32(cap + 1e-9), device=dev)
    bits = torch.zeros(num_chains, n, dtype=torch.bool, device=dev)
    weight = torch.zeros(num_chains, dtype=torch.float32, device=dev)
    value = torch.zeros(num_chains, dtype=torch.float32, device=dev)
    best_bits, best_value = bits, value
    rows = torch.arange(num_chains, device=dev)
    for t in range(num_steps):
        idx = idx_all[t]
        cur = bits[rows, idx]
        dw = torch.where(cur, -wj[idx], wj[idx])
        dv = torch.where(cur, -pj[idx], pj[idx])
        accept_prob = torch.exp(torch.clamp(dv / torch.clamp(temps[t], min=1e-9), max=0.0))
        accept = (weight + dw <= limit) & (u_all[t] < accept_prob)
        bits = bits.clone()
        bits[rows, idx] = cur ^ accept
        weight = torch.where(accept, weight + dw, weight)
        value = torch.where(accept, value + dv, value)
        improved = value > best_value
        best_bits = torch.where(improved[:, None], bits, best_bits)
        best_value = torch.where(improved, value, best_value)
    sel = best_bits[int(torch.argmax(best_value))].cpu().numpy()
    return sel, float(p[sel].sum())
