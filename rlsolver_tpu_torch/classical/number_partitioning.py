"""Number partitioning (counterpart of
`rlsolver_tpu/classical/number_partitioning.py`; a problem of RLSolver's
`Problem` axis, `methods/config.py:18-32`, objective
`obj_number_partitioning`): Karmarkar-Karp on the host, exact brute force
and batched annealing on the device."""

from __future__ import annotations

import heapq
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.classical.simulated_annealing import AnnealDraws
from rlsolver_tpu_torch.device import resolve_device


def partition_difference(numbers: np.ndarray, bits: np.ndarray) -> float:
    s = np.asarray(numbers, np.float64)
    return abs(float(s[bits].sum() - s[~bits].sum()))


def karmarkar_karp(numbers: Sequence[float]) -> Tuple[np.ndarray, float]:
    """Largest differencing: replace the two largest by their difference
    until one is left, then read the two sets off the merge tree. Returns
    (bits, |difference|)."""
    nums = np.asarray(numbers, np.float64)
    n = len(nums)
    heap = [(-v, i) for i, v in enumerate(nums)]  # (-value, id)
    heapq.heapify(heap)
    next_id = n
    children = {}
    while len(heap) > 1:
        va, a = heapq.heappop(heap)
        vb, b = heapq.heappop(heap)
        children[next_id] = (a, b)  # a keeps the merged node's side, b the other
        heapq.heappush(heap, (-(-va - (-vb)), next_id))
        next_id += 1
    side = np.zeros(next_id, np.int8)
    if heap:
        side[heap[0][1]] = 1
        for node in range(next_id - 1, n - 1, -1):
            a, b = children[node]
            side[a] = side[node]
            side[b] = -side[node]
    bits = side[:n] > 0
    return bits, partition_difference(nums, bits)


def brute_force_partition(numbers: Sequence[float], device=None) -> Tuple[np.ndarray, float]:
    """Every one of the 2^n splits at once on the device (n <= 24); ties
    go to the lowest code."""
    dev = resolve_device(device)
    nums = np.asarray(numbers, np.float64)
    n = len(nums)
    if n > 24:
        raise ValueError("brute force limited to n <= 24")
    codes = torch.arange(2**n, device=dev)
    bits = ((codes[:, None] >> torch.arange(n, device=dev)) & 1).to(torch.float32)
    diff = torch.abs((bits * 2.0 - 1.0) @ torch.from_numpy(np.float32(nums)).to(dev))
    best = int(torch.argmin(diff))
    sel = np.asarray((best >> np.arange(n)) & 1, bool)
    return sel, partition_difference(nums, sel)


def anneal_partition(numbers: Sequence[float], seed: int = 0, num_chains: int = 256, num_steps: int = 2000,
                     device=None, draws: Optional[AnnealDraws] = None) -> Tuple[np.ndarray, float]:
    """Batched single-flip annealing of the signed sums sum(S) - sum(~S),
    from uniform bits, under t0 * 0.001^(k / (T - 1)) with t0 the largest
    |number| (numpy's float64 values cast to f32). `draws` replaces the
    generator's. Returns (best bits, its |difference|)."""
    dev = resolve_device(device)
    nums = torch.from_numpy(np.asarray(numbers, np.float32)).to(dev)
    n = nums.shape[0]
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = AnnealDraws(torch.rand(num_chains, n, generator=gen, device=dev) < 0.5,
                            torch.randint(0, n, (num_steps, num_chains), generator=gen, device=dev),
                            torch.rand(num_steps, num_chains, generator=gen, device=dev))
    bits = torch.as_tensor(draws.xs0, device=dev).bool()
    idx_all = torch.as_tensor(draws.nodes, device=dev).long()
    u_all = torch.as_tensor(draws.u, device=dev).float()
    t0 = float(np.abs(numbers).max()) + 1e-6
    temps = torch.from_numpy(np.asarray(t0 * 0.001 ** (np.arange(num_steps) / max(1, num_steps - 1)),
                                        np.float32)).to(dev)
    signed = torch.where(bits, 1.0, -1.0) @ nums  # [C]
    best_bits, best_diff = bits, torch.abs(signed)
    rows = torch.arange(num_chains, device=dev)
    for t in range(num_steps):
        idx = idx_all[t]
        cur = bits[rows, idx]
        new_signed = signed + torch.where(cur, -2.0, 2.0) * nums[idx]
        accept_p = torch.exp(torch.clamp((torch.abs(signed) - torch.abs(new_signed))
                                         / torch.clamp(temps[t], min=1e-9), max=0.0))
        accept = u_all[t] < accept_p
        bits = bits.clone()
        bits[rows, idx] = cur ^ accept
        signed = torch.where(accept, new_signed, signed)
        improved = torch.abs(signed) < best_diff
        best_bits = torch.where(improved[:, None], bits, best_bits)
        best_diff = torch.where(improved, torch.abs(signed), best_diff)
    sel = best_bits[int(torch.argmin(best_diff))].cpu().numpy()
    return sel, partition_difference(np.asarray(numbers, np.float64), sel)
