"""Philox4x32-10 in plain PyTorch (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011), the counter-based generator that defines the
draws of MCPG's fused sampler and noisy sweep: draw t of chain c under key
(seed, tag) is word t & 3 of Philox4x32-10 at counter (t >> 2, c, 0, 0).

Values are int64 tensors holding unsigned 32-bit numbers; the 32 x 32 ->
64-bit products are formed from 16-bit limbs so that nothing overflows.
The key may be a tensor (one seed a row), so that rows of several rounds,
each round with its own seed, draw in one call.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
TAG_MH = 0x4D48  # the MH sampler's stream
TAG_SWEEP = 0x5357  # the noisy sweep's stream


def _mulhilo(m: int, x: torch.Tensor):
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Ten rounds on a counter of four int64 tensors under key (k0, k1),
    each an int or an int64 tensor that broadcasts with the counter."""
    k0 = k0 & MASK32
    k1 = k1 & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draws(seeds: torch.Tensor, chains: torch.Tensor, tag: int, count: int) -> torch.Tensor:
    """Draws 0 .. count - 1 of each row, int64 [count, K]: row i is chain
    `chains[i]` under seed `seeds[i]` (both int64 [K])."""
    blocks = -(-count // 4)
    blk = torch.arange(blocks, device=chains.device, dtype=torch.int64)[:, None].expand(blocks, chains.shape[0])
    c1 = chains[None, :].expand_as(blk)
    zero = torch.zeros_like(blk)
    words = philox4x32(blk, c1, zero, zero, seeds[None, :], tag)
    return torch.stack(words, dim=1).reshape(blocks * 4, -1)[:count]
