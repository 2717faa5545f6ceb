"""Bit codec shared by the packed kernels (counterpart of
`rlsolver_tpu/ops/pallas/mh_sampler.py:pack_bits/unpack_bits`).

Chains are packed little-endian, 32 nodes to an int32 word: node i lives in
word i >> 5 at bit i & 31. Words are exactly ceil(N / 32) wide (the JAX
package's 128-lane padding is TPU tiling and is not carried over), and the
padding bits of the last word are 0.

Both directions build a [rows, W, 32] int32 temporary, so they work CHUNK
rows at a time: at 10^6 chains x 2000 nodes one piece would be 8 GB.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 16


def num_words(n: int) -> int:
    return (n + 31) // 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, N] -> int32 words [B, ceil(N/32)]."""
    b, n = bits.shape
    w = num_words(n)
    out = torch.empty(b, w, dtype=torch.int32, device=bits.device)
    shifts = _shifts(bits.device)
    for i in range(0, b, CHUNK):
        x = bits[i : i + CHUNK].to(torch.int32)
        x = torch.nn.functional.pad(x, (0, w * 32 - n)).reshape(-1, w, 32)
        # disjoint powers of two (bit 31 is -2^31): the int32 sum is the
        # bitwise OR and cannot overflow
        torch.sum(x << shifts, dim=-1, dtype=torch.int32, out=out[i : i + CHUNK])
    return out


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words [B, W] -> bool [B, n] (inverse of `pack_bits`)."""
    b, w = words.shape
    out = torch.empty(b, n, dtype=torch.bool, device=words.device)
    shifts = _shifts(words.device)
    for i in range(0, b, CHUNK):
        x = (words[i : i + CHUNK, :, None] >> shifts) & 1
        out[i : i + CHUNK] = x.reshape(-1, w * 32)[:, :n].bool()
    return out
