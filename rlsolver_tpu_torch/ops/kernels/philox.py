"""Plain PyTorch Philox4x32-10, draw for draw equal to the one in
`csrc/common.cuh`.

The fused kernels draw their randomness from a counter-based generator:
draw `t` of chain `c` under key (seed, tag) is word `t & 3` of
Philox4x32-10 at counter (t >> 2, c, 0, 0). A draw depends only on
(seed, tag, c, t), not on how the kernel cuts the chains into blocks, so
this module reproduces every draw and the kernels are checked bit for bit.

Values are carried in int64 tensors holding unsigned 32-bit numbers. The
32 x 32 -> 64-bit products of a Philox round would overflow a signed int64,
so they are formed from 16-bit limbs.
"""

from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF

# generator tags: one independent stream per kernel family
TAG_MH = 0x4D48  # the fused MH sampler
TAG_SWEEP = 0x5357  # the fused degree-ordered sweep


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x, m a constant < 2^32, x int64 < 2^32."""
    p0 = x * (m & 0xFFFF)  # < 2^48
    p1 = x * (m >> 16)  # < 2^48; the product is p0 + p1 * 2^16
    mid = p0 + ((p1 & 0xFFFF) << 16)  # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & MASK32


def philox4x32(counter, seed: int, tag: int):
    """Philox4x32-10 of a counter (four int64 tensors) under key (seed, tag).
    Returns four int64 tensors of unsigned 32-bit words."""
    c0, c1, c2, c3 = counter
    k0, k1 = seed & MASK32, tag & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_block(seed: int, tag: int, block: int, chains: torch.Tensor):
    """The four draws 4*block .. 4*block + 3 of every chain in `chains`
    (int64 tensor of chain indices)."""
    zero = torch.zeros_like(chains)
    return philox4x32((zero + block, chains, zero, zero), seed, tag)
