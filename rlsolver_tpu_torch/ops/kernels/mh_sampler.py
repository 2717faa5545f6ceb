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
  * `mh_sample_onehot` (K11) and `mh_sample_packed` (K12): the randomness is
    injected as a node int32 [R, B] and a uniform f32 [R, B] per proposal
    (`make_round_randoms`), as the JAX package's `mh_sample_pallas` and
    `mh_sample_packed` draw it. K11 accepts when u * q < 1 - q in f32, as
    the JAX twin `mh_reference` does; K12 takes both conditional accepts
    precomputed by `make_round_accepts` (accept | bit 1: u p < 1 - p;
    accept | bit 0: u (1 - p) < p). The two agree wherever 1 - (1 - p) == p
    in f32 (any p on the 2^-24 grid); off it, K11's bound for a 0 bit is
    one rounding away from K12's, and a proposal can land between them.
    Both are bit-exact with their JAX kernels fed the same draws.

On a CUDA tensor each wrapper launches its kernel (`csrc/mh_sampler.cu`);
on a CPU tensor it runs the plain PyTorch version. K3 has two forms, picked
by `fused_form` from the shape: the chain form (a thread a chain) for many
narrow chains, the split form (`split_lanes` lanes of a warp a chain, each
lane applying the proposals on the words it owns) for few or wide ones.
K2, K11 and K12 run one ring kernel, which stages the streams through a
ring in shared memory, one bulk copy per round row of its chain tile, so
the rows must be 16-byte aligned and a multiple of 16 bytes apart
(`bulk_rows` pads them). K11's and K12's ring of 4 stages fits beside a
tile of 64 chains up to W = 651 words (N = 20,832); beyond, the tile halves
to 32 chains, then the stages halve (4 up to W = 1559, 2 up to 1687, 1 up
to 1751), and up to W = 1815 (N = 58,080), where the 32 chains' words alone
fill a block's shared memory, the kernel reads the streams from device
memory. K2's smaller ring (one stream, stages of 8 rounds) keeps 64 chains
up to W = 875. None of K2, K11 and K12 is on a solver path, in this package
or the JAX one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlsolver_tpu_torch.ops.kernels import philox
from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register
from rlsolver_tpu_torch.ops.kernels.codec import num_words, pack_bits, unpack_bits

MH_STREAM = register(Kernel(
    "mh_sample_stream", "mh_sampler.cu", "mh_stream", "ppiiii",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:327 _mh_stream_kernel",
))
MH_FUSED = register(Kernel(
    "mh_sample_fused", "mh_sampler.cu", "mh_fused", "ppiiiiu",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:403 _mh_fused_kernel",
))
MH_FUSED_SPLIT = register(Kernel(
    "mh_sample_fused_split", "mh_sampler.cu", "mh_fused_split", "ppiiiiui",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:403 _mh_fused_kernel",
))
MH_ONEHOT = register(Kernel(
    "mh_sample_onehot", "mh_sampler.cu", "mh_onehot", "ppppiiiii",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:72 _mh_kernel",
))
MH_PACKED = register(Kernel(
    "mh_sample_packed", "mh_sampler.cu", "mh_packed", "pppiiiii",
    replaces="rlsolver_tpu/ops/pallas/mh_sampler.py:201 _mh_packed_kernel",
))

WIDE_NODES = 1 << 15
MASK32 = 0xFFFFFFFF
# K3's forms by shape (scripts/torch_mh_tile.py --k3; PERF.md). The chain
# form runs where its 128-chain blocks leave room for six an SM (at most
# CHAIN_FORM_WORDS words a chain) and the chains are at least CHAIN_PER_SM
# an SM; the split form elsewhere, with SPLIT_LANES[i][1] lanes a chain up
# to SPLIT_LANES[i][0] words, 32 beyond.
CHAIN_FORM_WORDS = 75
CHAIN_PER_SM = 128
SPLIT_LANES = ((16, 8), (128, 16))


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
    """Run the R rounds of `stream` [R, B] on chains bits bool [B, N]. On
    the card the stream's rows are padded by `bulk_rows` as K12's are."""
    b, n = bits.shape
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(mh_stream_plain(stream, words), n)
    check_cuda_tensor(stream, "stream", torch.int32, (stream.shape[0], b))
    rows = bulk_rows(stream)
    MH_STREAM.launch(rows, words, b, rows.shape[1], num_words(n), stream.shape[0])
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


def fused_form(b: int, w: int, sm_count: int) -> str:
    """K3's form for b chains of w words on a card of sm_count SMs: "chain"
    (a thread a chain) or "split" (lanes of a warp a chain). The chain form
    holds 128 chains a block: it loses where few chains leave its blocks'
    serial rounds uncovered (a round's latency times R), and where wide
    chains leave few blocks an SM."""
    return "chain" if w <= CHAIN_FORM_WORDS and b >= CHAIN_PER_SM * sm_count else "split"


def split_lanes(w: int) -> int:
    """Lanes a chain of w words in K3's split form."""
    return next((lanes for most, lanes in SPLIT_LANES if w <= most), 32)


def fused_kernel(b: int, w: int, device: torch.device) -> Kernel:
    """The kernel that `mh_sample_fused` launches for b chains of w words."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return MH_FUSED_SPLIT if fused_form(b, w, sms) == "split" else MH_FUSED


def launch_fused(kernel: Kernel, thr: torch.Tensor, words: torch.Tensor, n: int, num_rounds: int, seed: int) -> None:
    """K3 in the form of `kernel` (MH_FUSED or MH_FUSED_SPLIT, the latter with
    `split_lanes` lanes a chain) on words int32 [B, W] on the card, in place."""
    lanes = (split_lanes(words.shape[1]),) if kernel is MH_FUSED_SPLIT else ()
    kernel.launch(thr, words, words.shape[0], words.shape[1], n, num_rounds, seed & MASK32, *lanes)


def mh_sample_fused(seed: int, probs: torch.Tensor, bits: torch.Tensor, num_rounds: int) -> torch.Tensor:
    """`num_rounds` MH rounds on bits bool [B, N] with in-kernel random draws
    keyed by `seed` (0 <= seed < 2^32). On the card, in the form that
    `fused_form` picks for the shape."""
    b, n = bits.shape
    thr = fused_thresholds(probs)
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(mh_fused_plain(seed, thr, words, n, num_rounds), n)
    check_cuda_tensor(thr, "thresholds", torch.float32, (2, n))
    launch_fused(fused_kernel(b, words.shape[1], words.device), thr, words, n, num_rounds, seed)
    return unpack_bits(words, n)


def make_round_randoms(gen: torch.Generator, num_rounds: int, num_chains: int,
                       num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nodes int32 [R, B] uniform in [0, N), uniforms f32 [R, B] in [0, 1))
    for R proposal rounds, drawn from `gen` on its device."""
    nodes = torch.randint(0, num_nodes, (num_rounds, num_chains), generator=gen, device=gen.device,
                          dtype=torch.int32)
    u = torch.rand(num_rounds, num_chains, generator=gen, device=gen.device)
    return nodes, u


def make_round_accepts(nodes: torch.Tensor, u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """K12's acc2 int32 [R, B]: bit c = accept given the current bit == c,
    the same f32 expressions as the JAX package's `mh_sample_packed`."""
    p = probs.to(torch.float32)[nodes.long()]
    a1 = (u * p < 1.0 - p).to(torch.int32)  # q = p
    a0 = (u * (1.0 - p) < p).to(torch.int32)  # q = 1 - p
    return a0 | (a1 << 1)


def _injected_rounds(nodes: torch.Tensor, words: torch.Tensor, n: int, accept):
    """The round loop of the K11/K12 plain versions on int32 words [B, W]:
    accept(r, node, cur) gives round r's 0/1 decisions. A node outside
    [0, N) is a no-op."""
    w = words.long() & MASK32
    for r, node in enumerate(nodes.long()):
        valid = ((node >= 0) & (node < n)).long()
        node = node * valid
        _flip_words(w, node >> 5, node & 31, lambda cur: accept(r, node, cur) & valid)
    return _to_int32(w)


def mh_onehot_plain(nodes, u, probs, words, n):
    """Plain version of the K11 kernel: words int32 [B, W] -> new words."""
    p_all = probs.to(torch.float32)

    def accept(r, node, cur):
        p = p_all[node]
        q = torch.where(cur > 0, p, 1.0 - p)
        return (u[r] * q < 1.0 - q).long()

    return _injected_rounds(nodes, words, n, accept)


def mh_packed_plain(nodes, acc2, words, n):
    """Plain version of the K12 kernel: words int32 [B, W] -> new words."""
    return _injected_rounds(nodes, words, n, lambda r, node, cur: (acc2[r].long() >> cur) & 1)


def _check_rounds(nodes, other, name, dtype, b):
    check_cuda_tensor(nodes, "nodes", torch.int32, (nodes.shape[0], b))
    check_cuda_tensor(other, name, dtype, tuple(nodes.shape))


def bulk_rows(t: torch.Tensor) -> torch.Tensor:
    """t [R, B] as rows that K2, K11 and K12 copy in bulk, 16-byte aligned and a
    multiple of 16 bytes apart: t itself where B % 4 == 0 and t is aligned,
    else a copy into a `torch.empty` buffer [R, B_pad], B_pad the next
    multiple of 4, whose extra columns no chain reads."""
    r, b = t.shape
    if b % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(r, -(-b // 4) * 4, dtype=t.dtype, device=t.device)
    out[:, :b] = t
    return out


def mh_sample_onehot(nodes: torch.Tensor, u: torch.Tensor, probs: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """K11: the R rounds of (nodes, u) [R, B] on chains bits bool [B, N].
    On the card, where B is not a multiple of 4 (or a tensor is not 16-byte
    aligned), nodes and u are first padded by `bulk_rows`."""
    b, n = bits.shape
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(mh_onehot_plain(nodes, u, probs, words, n), n)
    _check_rounds(nodes, u, "u", torch.float32, b)
    check_cuda_tensor(probs, "probs", torch.float32, (n,))
    nodes_p, u_p = bulk_rows(nodes), bulk_rows(u)
    MH_ONEHOT.launch(nodes_p, u_p, probs, words, b, nodes_p.shape[1], num_words(n), n, nodes.shape[0])
    return unpack_bits(words, n)


def mh_sample_packed(nodes: torch.Tensor, acc2: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """K12: the R rounds of (nodes, acc2) [R, B] on chains bits bool [B, N].
    On the card, nodes and acc2 are padded by `bulk_rows` as for K11."""
    b, n = bits.shape
    words = pack_bits(bits)
    if not words.is_cuda:
        return unpack_bits(mh_packed_plain(nodes, acc2, words, n), n)
    _check_rounds(nodes, acc2, "acc2", torch.int32, b)
    nodes_p, acc2_p = bulk_rows(nodes), bulk_rows(acc2)
    MH_PACKED.launch(nodes_p, acc2_p, words, b, nodes_p.shape[1], num_words(n), n, nodes.shape[0])
    return unpack_bits(words, n)
