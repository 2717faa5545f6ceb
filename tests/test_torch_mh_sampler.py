"""Port parity: the bit codec and the MH samplers. The plain version of K2
is bit-exact with the JAX twin and the Pallas kernel (interpret mode) fed
the stream JAX made; K3's node/u16 derivation matches JAX's on JAX's raw
bits, and K3's plain version (plain Philox) and the budgeted sampler reach
the Bernoulli(probs) marginals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.ops.pallas import mh_sampler as jmh
from rlsolver_tpu_torch.ops import sampling as t_sampling
from rlsolver_tpu_torch.ops.kernels import codec
from rlsolver_tpu_torch.ops.kernels import mh_sampler as tmh
from rlsolver_tpu_torch.ops.kernels import philox

torch.set_num_threads(1)

PROBS8 = np.array([0.3, 0.5, 0.7, 0.4, 0.6, 0.5, 0.2, 0.8], np.float32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70, 300])
def test_pack_unpack_bit_exact_vs_jax(n):
    bits = np.random.default_rng(n).random((16, n)) < 0.5
    jw = np.asarray(jmh.pack_bits(jnp.asarray(bits)))
    tw = codec.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(codec.unpack_bits(tw, n).numpy(), bits)
    np.testing.assert_array_equal(codec.unpack_bits(tw, n).numpy(),
                                  np.asarray(jmh.unpack_bits(jnp.asarray(jw), n)))


def test_codec_chunks_rows(monkeypatch):
    monkeypatch.setattr(codec, "CHUNK", 8)
    for b in (11, 13, 17):
        bits = np.random.default_rng(b).random((b, 70)) < 0.5
        words = codec.pack_bits(torch.from_numpy(bits))
        np.testing.assert_array_equal(words.numpy(), np.asarray(jmh.pack_bits(jnp.asarray(bits))))
        np.testing.assert_array_equal(codec.unpack_bits(words, 70).numpy(), bits)


def _stream_case(n=97, b=512, rounds=128, seed=21):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.05, 0.95, n).astype(np.float32)
    bits = rng.random((b, n)) < 0.5
    return key, probs, bits, rounds


def test_proposal_stream_and_k3_derivation_match_jax():
    key, probs, _, rounds = _stream_case()
    raw = np.asarray(jax.random.bits(key, (rounds, 512), jnp.uint32)).astype(np.int64)
    j_stream = np.asarray(jmh.make_proposal_stream(key, rounds, 512, jnp.asarray(probs)))
    t_stream = tmh.make_proposal_stream(torch.from_numpy(raw), torch.from_numpy(probs))
    np.testing.assert_array_equal(t_stream.numpy(), j_stream)
    node, u16 = tmh.proposal_from_bits(torch.from_numpy(raw), len(probs))
    j_node = ((j_stream.astype(np.int64) >> 7) << 5) | ((j_stream >> 2) & 31)
    np.testing.assert_array_equal(node.numpy(), j_node)
    np.testing.assert_array_equal(u16.numpy(), raw & 0xFFFF)


# Known-answer vectors of Philox4x32-10 from Random123's kat_vectors file
# (Salmon et al., SC'11): counter (4 words), key (2 words) -> output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", PHILOX_KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, expected):
    out = philox.philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(o) for o in out) == expected


def test_k2_plain_bit_exact_vs_jax_twin_and_kernel():
    key, probs, bits, rounds = _stream_case()
    stream = np.array(jmh.make_proposal_stream(key, rounds, bits.shape[0], jnp.asarray(probs)))
    ref = np.asarray(jmh.mh_reference_stream(key, jnp.asarray(probs), jnp.asarray(bits), rounds))
    pallas = np.asarray(jmh.mh_sample_stream(key, jnp.asarray(probs), jnp.asarray(bits),
                                             num_rounds=rounds, interpret=True))
    out = tmh.mh_sample_stream(torch.from_numpy(stream), torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)


def test_k3_plain_stationary_marginal():
    # 2048 chains: the standard error of each marginal is <= 0.011, and the
    # tolerance is 4.5 of them
    bits = torch.from_numpy(np.random.default_rng(3).random((2048, 8)) < 0.5)
    out = tmh.mh_sample_fused(123, torch.from_numpy(PROBS8), bits, 512)
    np.testing.assert_allclose(out.float().mean(0).numpy(), PROBS8, atol=0.05)


def test_k3_plain_deterministic_and_seeded():
    probs = torch.full((70,), 0.5)
    bits = torch.from_numpy(np.random.default_rng(4).random((64, 70)) < 0.5)
    a = tmh.mh_sample_fused(5, probs, bits, 33)
    assert torch.equal(a, tmh.mh_sample_fused(5, probs, bits, 33))
    assert not torch.equal(a, tmh.mh_sample_fused(6, probs, bits, 33))
    # each round flips at most one bit per chain
    assert int((a ^ bits).sum(1).max()) <= 33


def test_k3_wide_path_reaches_every_node_range():
    n = (1 << 15) + 40000  # node indices above 2^16 need the two-draw rule
    chains = torch.arange(4096)
    node, u16 = tmh.fused_proposal(9, 3, chains, n)
    assert int(node.min()) >= 0 and int(node.max()) < n and int(node.max()) > 65536
    assert int(u16.max()) < 65536
    bits = torch.zeros(4, n, dtype=torch.bool)
    out = tmh.mh_sample_fused(9, torch.full((n,), 0.5), bits, 6)
    assert 0 < int(out.sum()) <= 24


def test_budgeted_chain_stationary_marginal():
    gen = torch.Generator().manual_seed(0)
    bits = torch.from_numpy(np.random.default_rng(7).random((2048, 8)) < 0.5)
    res = t_sampling.metropolis_bitflip_chain(gen, torch.from_numpy(PROBS8), bits, 100)
    assert res.num_accepted >= 2048 * 100 or res.num_rounds == 500
    np.testing.assert_allclose(res.samples.float().mean(0).numpy(), PROBS8, atol=0.05)


def _word_owned(words, n, word, bit, accept, lanes):
    """The split form's schedule on int32 words [B, W]: lane l applies, in
    round order, the proposals (word, bit) [R, B] whose word it owns (word %
    lanes == l; a word outside [0, W) is a no-op), the lanes one after
    another, the last first. accept(r, cur) gives round r's 0/1 decisions."""
    w = words.long() & tmh.MASK32
    rows = torch.arange(w.shape[0])
    for lane in reversed(range(lanes)):
        for r in range(word.shape[0]):
            own = ((word[r] % lanes == lane) & (word[r] < w.shape[1])).long()
            wr = word[r].clamp(max=w.shape[1] - 1)
            cur_w = w[rows, wr]
            w[rows, wr] = cur_w ^ ((accept(r, (cur_w >> bit[r]) & 1) & own) << bit[r])
    return tmh._to_int32(w)


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("n", [250, 2000, tmh.WIDE_NODES + 3])
@pytest.mark.parametrize("kind", ["fused", "stream"])
def test_word_owned_split_is_the_sequential_chain(kind, n, b, lanes):
    rounds, rng = 37, np.random.default_rng(n + b)
    words = codec.pack_bits(torch.from_numpy(rng.random((b, n)) < 0.5))
    if kind == "fused":
        thr = tmh.fused_thresholds(torch.from_numpy(rng.uniform(0.05, 0.95, n).astype(np.float32)))
        props = [tmh.fused_proposal(77, r, torch.arange(b), n) for r in range(rounds)]
        node = torch.stack([p[0] for p in props])
        u = torch.stack([p[1] for p in props]).float()
        out = _word_owned(words, n, node >> 5, node & 31, lambda r, cur: (u[r] < thr[cur, node[r]]).long(), lanes)
        np.testing.assert_array_equal(out.numpy(), tmh.mh_fused_plain(77, thr, words, n, rounds).numpy())
    else:  # K2's stream, words past W among the proposals
        s = torch.from_numpy(rng.integers(0, (codec.num_words(n) + 2) << 7, (rounds, b)).astype(np.int32)).long()
        out = _word_owned(words, n, s >> 7, (s >> 2) & 31, lambda r, cur: (s[r] >> cur) & 1, lanes)
        np.testing.assert_array_equal(out.numpy(), tmh.mh_stream_plain(s.int(), words).numpy())


@pytest.mark.parametrize("b,n,form,lanes", [
    (128, 6770, "split", 32),  # TNCO's MCPG (32 x 4 chains, Sycamore N53's 12-layer shape)
    (8192, 2000, "split", 16), (8192, 800, "split", 16), (8192, 250, "split", 8),  # mcpg_multi's 256 x 32
    (24576, 10000, "split", 32),  # gset_70's 768 x 32 (W70-like)
    (458752, 2000, "chain", 0), (1 << 20, 2000, "chain", 0),  # the MCPG runner's 2048 x 224, gset_22's 2048 x 512
])
def test_fused_form_by_shape(b, n, form, lanes):
    w = codec.num_words(n)
    assert tmh.fused_form(b, w, 132) == form
    assert form == "chain" or tmh.split_lanes(w) == lanes
