"""Metropolis-Hastings bit-flip samplers on packed chains (counterpart of
`rlsolver_tpu/ops/pallas/mh_sampler.py`).

Per round every chain proposes flipping one node and accepts with
probability min(1, (1-q)/q), q = P(current value), exactly MCPG's
`metro_sampling` rule; the stationary law is Bernoulli(probs) per node.
A proposal comes from one unsigned 32-bit draw: node = (hi16 * N) >> 16 and
a u16 uniform from the low 16 bits, accepted when u16 < threshold[cur].

  * `mh_sample_stream` (K2): proposals packed one int32 each into a stream
    [R, B] made by `make_proposal_stream` from given random bits; bit-exact
    with the JAX package's `mh_reference_stream` fed the same bits.
  * `mh_sample_fused` (K3): the draws come from Philox4x32-10 inside the
    kernel (`philox.py` lays out the counters); the plain version draws the
    same numbers, so kernel and plain version agree bit for bit. For
    N >= 2^15 a round takes two draws: node = umulhi(draw0, N), u16 = low
    16 bits of draw1 (the narrow rule's 16-bit node resolution would leave
    nodes unreachable there).

On a CUDA tensor each wrapper launches its kernel (`csrc/mh_sampler.cu`);
on a CPU tensor it runs the plain PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlsolver_tpu_torch.ops.kernels import philox
from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register
from rlsolver_tpu_torch.ops.kernels.codec import num_words, pack_bits, unpack_bits

MH_STREAM = register(Kernel(
    "mh_sample_stream", "mh_sampler.cu", "mh_stream", "ppiii",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:327 _mh_stream_kernel",
))
MH_FUSED = register(Kernel(
    "mh_sample_fused", "mh_sampler.cu", "mh_fused", "ppiiiiu",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:403 _mh_fused_kernel",
))

WIDE_NODES = 1 << 15
MASK32 = 0xFFFFFFFF


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding unsigned 32-bit words -> the same bits as int32."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def proposal_from_bits(rnd: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node, u16) from unsigned 32-bit draws (int64 tensor), N < 2^15."""
    return ((rnd >> 16) * n) >> 16, rnd & 0xFFFF


def make_proposal_stream(rnd: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One packed int32 per proposal, `word << 7 | bitpos << 2 | acc2`, from
    draws `rnd` [R, B] (unsigned 32-bit values in any integer dtype). acc2
    bit c = accept given current bit == c."""
    n = probs.shape[0]
    node, u16 = proposal_from_bits(rnd.long() & MASK32, n)
    u = u16.to(torch.float32)
    p = probs.to(torch.float32)[node]
    a0 = (u * (1.0 - p) < p * 65536.0).long()  # accept | cur == 0
    a1 = (u * p < (1.0 - p) * 65536.0).long()  # accept | cur == 1
    return (((node >> 5) << 7) | ((node & 31) << 2) | a0 | (a1 << 1)).to(torch.int32)


def _flip_words(w: torch.Tensor, word: torch.Tensor, bit: torch.Tensor, acc_of_cur) -> None:
    """One round on int64 words [B, W] in place: read the proposed bit, ask
    acc_of_cur(cur) for the accept decision (0/1), flip."""
    rows = torch.arange(w.shape[0], device=w.device)
    cur_w = w[rows, word]
    acc = acc_of_cur((cur_w >> bit) & 1)
    w[rows, word] = cur_w ^ (acc << bit)


def mh_stream_plain(stream: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Plain version of the K2 kernel: words int32 [B, W] -> new words."""
    w = words.long() & MASK32
    for s in stream.long() & MASK32:
        word = s >> 7
        valid = (word < w.shape[1]).long()
        _flip_words(w, word.clamp(max=w.shape[1] - 1), (s >> 2) & 31,
                    lambda cur: (s >> cur) & 1 & valid)
    return _to_int32(w)


def mh_sample_stream(stream: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Run the R rounds of `stream` [R, B] on chains bits bool [B, N]."""
    b, n = bits.shape
    words = pack_bits(bits)
    if words.is_cuda:
        check_cuda_tensor(stream, "stream", torch.int32, (stream.shape[0], b))
        MH_STREAM.launch(stream, words, b, num_words(n), stream.shape[0])
    else:
        words = mh_stream_plain(stream, words)
    return unpack_bits(words, n)


def fused_thresholds(probs: torch.Tensor) -> torch.Tensor:
    """[2, N] f32 u16-scaled accept thresholds; row c = given current bit c.
    Same f32 expression as the JAX package's `mh_sample_fused`."""
    p = probs.to(torch.float32)
    t0 = torch.clamp(p / torch.clamp(1.0 - p, min=1e-9) * 65536.0, 0.0, 65536.0)
    t1 = torch.clamp((1.0 - p) / torch.clamp(p, min=1e-9) * 65536.0, 0.0, 65536.0)
    return torch.stack([t0, t1]).contiguous()


def fused_proposal(seed: int, r: int, chains: torch.Tensor, n: int, block=None):
    """(node, u16) of round r for `chains` under the K3 draw layout. `block`
    may pass the Philox block already computed for this round."""
    if n < WIDE_NODES:
        d = block if block is not None else philox.philox_block(seed, philox.TAG_MH, r >> 2, chains)
        return proposal_from_bits(d[r & 3], n)
    d = block if block is not None else philox.philox_block(seed, philox.TAG_MH, r >> 1, chains)
    q = 2 * (r & 1)
    return philox._mulhilo(n, d[q])[0], d[q + 1] & 0xFFFF


def mh_fused_plain(seed: int, thr: torch.Tensor, words: torch.Tensor, n: int, num_rounds: int):
    """Plain version of the K3 kernel: words int32 [B, W] -> new words."""
    w = words.long() & MASK32
    chains = torch.arange(w.shape[0], device=w.device)
    per_call = 4 if n < WIDE_NODES else 2
    block = None
    for r in range(num_rounds):
        if r % per_call == 0:
            t = r if n < WIDE_NODES else 2 * r
            block = philox.philox_block(seed, philox.TAG_MH, t >> 2, chains)
        node, u16 = fused_proposal(seed, r, chains, n, block)
        u = u16.to(torch.float32)
        _flip_words(w, node >> 5, node & 31, lambda cur: (u < thr[cur, node]).long())
    return _to_int32(w)


def mh_sample_fused(seed: int, probs: torch.Tensor, bits: torch.Tensor, num_rounds: int) -> torch.Tensor:
    """`num_rounds` MH rounds on bits bool [B, N] with in-kernel random draws
    keyed by `seed` (0 <= seed < 2^32)."""
    b, n = bits.shape
    thr = fused_thresholds(probs)
    words = pack_bits(bits)
    if words.is_cuda:
        check_cuda_tensor(thr, "thresholds", torch.float32, (2, n))
        MH_FUSED.launch(thr, words, b, num_words(n), n, num_rounds, seed & MASK32)
    else:
        words = mh_fused_plain(seed, thr, words, n, num_rounds)
    return unpack_bits(words, n)
