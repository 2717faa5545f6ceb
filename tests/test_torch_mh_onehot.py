"""Port parity: K11 (`mh_sample_onehot`) and K12 (`mh_sample_packed`), the
MH samplers that take their randomness as (node, uniform) pairs. Fed the
draws of JAX's `make_round_randoms`, their plain versions are bit-exact with
the Pallas kernels in interpret mode and with the XLA twin `mh_reference`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.ops.pallas import mh_sampler as jmh
from rlsolver_tpu_torch.ops.kernels import mh_sampler as tmh

torch.set_num_threads(1)

PROBS8 = np.array([0.3, 0.5, 0.7, 0.4, 0.6, 0.5, 0.2, 0.8], np.float32)


def _case(n, seed, b=256, rounds=128):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.1, 0.9, n).astype(np.float32)
    bits = rng.random((b, n)) < 0.5
    nodes, u = (np.array(a) for a in jmh.make_round_randoms(key, rounds, b, n))
    return key, probs, bits, rounds, torch.from_numpy(nodes), torch.from_numpy(u)


# N = 71 spans three words and proposes nodes at bit position 31
@pytest.mark.parametrize("n,seed", [(24, 0), (71, 11)])
def test_k11_k12_plain_bit_exact_vs_jax(n, seed):
    key, probs, bits, rounds, nodes, u = _case(n, seed)
    jp, jb = jnp.asarray(probs), jnp.asarray(bits)
    ref = np.asarray(jmh.mh_reference(key, jp, jb, num_rounds=rounds))
    onehot = np.asarray(jmh.mh_sample_pallas(key, jp, jb, num_rounds=rounds, block_chains=128, interpret=True))
    packed = np.asarray(jmh.mh_sample_packed(key, jp, jb, num_rounds=rounds, block_chains=128, interpret=True))
    tp, tb = torch.from_numpy(probs), torch.from_numpy(bits)
    k11 = tmh.mh_sample_onehot(nodes, u, tp, tb).numpy()
    k12 = tmh.mh_sample_packed(nodes, tmh.make_round_accepts(nodes, u, tp), tb).numpy()
    np.testing.assert_array_equal(k11, onehot)
    np.testing.assert_array_equal(k11, ref)
    np.testing.assert_array_equal(k12, packed)
    np.testing.assert_array_equal(k12, ref)
    assert (k11 != bits).any()


def test_round_accepts_match_jax_expressions():
    _, probs, _, _, nodes, u = _case(71, 5)
    p = jnp.asarray(probs)[jnp.asarray(nodes.numpy())]
    uu = jnp.asarray(u.numpy())
    a1 = (uu * p < (1.0 - p)).astype(jnp.int32)
    a0 = (uu * (1.0 - p) < p).astype(jnp.int32)
    acc2 = tmh.make_round_accepts(nodes, u, torch.from_numpy(probs))
    assert acc2.dtype == torch.int32
    np.testing.assert_array_equal(acc2.numpy(), np.asarray(a0 | (a1 << 1)))


def test_k11_equals_k12_on_probs_of_the_grid():
    # on probs that are multiples of 2^-16, 1 - (1 - p) == p in f32, so the
    # in-kernel accept test of K11 and K12's precomputed accepts agree
    rng = np.random.default_rng(2)
    n, b = 70, 512
    probs = torch.from_numpy((rng.integers(13107, 52429, n) / 65536.0).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    nodes, u = tmh.make_round_randoms(gen, 300, b, n)
    bits = torch.from_numpy(rng.random((b, n)) < 0.5)
    k11 = tmh.mh_sample_onehot(nodes, u, probs, bits)
    k12 = tmh.mh_sample_packed(nodes, tmh.make_round_accepts(nodes, u, probs), bits)
    assert torch.equal(k11, k12)


def test_make_round_randoms_ranges_and_seeding():
    gen = torch.Generator().manual_seed(5)
    nodes, u = tmh.make_round_randoms(gen, 10, 32, 7)
    assert nodes.shape == u.shape == (10, 32) and nodes.dtype == torch.int32 and u.dtype == torch.float32
    assert int(nodes.min()) >= 0 and int(nodes.max()) < 7
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    again = tmh.make_round_randoms(torch.Generator().manual_seed(5), 10, 32, 7)
    assert torch.equal(nodes, again[0]) and torch.equal(u, again[1])


def test_out_of_range_nodes_are_no_ops():
    bits = torch.from_numpy(np.random.default_rng(6).random((4, 40)) < 0.5)
    nodes = torch.tensor([[40, -1, 63, 1000]], dtype=torch.int32)
    u = torch.zeros(1, 4)  # would accept every valid proposal
    probs = torch.full((40,), 0.5)
    assert torch.equal(tmh.mh_sample_onehot(nodes, u, probs, bits), bits)
    assert torch.equal(tmh.mh_sample_packed(nodes, torch.full((1, 4), 3, dtype=torch.int32), bits), bits)


@pytest.mark.parametrize("sampler", ["onehot", "packed"])
def test_plain_stationary_marginals(sampler):
    # 2048 chains: the standard error of each marginal is <= 0.011, and the
    # tolerance is 4.5 of them
    gen = torch.Generator().manual_seed(8)
    probs = torch.from_numpy(PROBS8)
    nodes, u = tmh.make_round_randoms(gen, 512, 2048, 8)
    bits = torch.from_numpy(np.random.default_rng(3).random((2048, 8)) < 0.5)
    if sampler == "onehot":
        out = tmh.mh_sample_onehot(nodes, u, probs, bits)
    else:
        out = tmh.mh_sample_packed(nodes, tmh.make_round_accepts(nodes, u, probs), bits)
    np.testing.assert_allclose(out.float().mean(0).numpy(), PROBS8, atol=0.05)


def test_k12_plain_bit_exact_vs_jax_at_b_not_a_multiple_of_4():
    # 250 chains (B % 4 == 2) in two Pallas blocks of 125: the rows K12's
    # kernel copies in bulk are padded on the card, never on the CPU
    n, b = 71, 250
    key, probs, bits, rounds, nodes, u = _case(n, 13, b=b)
    packed = np.asarray(jmh.mh_sample_packed(key, jnp.asarray(probs), jnp.asarray(bits), num_rounds=rounds,
                                             block_chains=125, interpret=True))
    acc2 = tmh.make_round_accepts(nodes, u, torch.from_numpy(probs))
    k12 = tmh.mh_sample_packed(nodes, acc2, torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(k12, packed)
    assert (k12 != bits).any()


@pytest.mark.parametrize("b", [9, 10, 11])  # B % 4 in {1, 2, 3}
def test_k12_padded_rows_never_change_a_chain(b):
    rng = np.random.default_rng(b)
    n, rounds = 40, 64
    probs = torch.from_numpy(rng.uniform(0.1, 0.9, n).astype(np.float32))
    gen = torch.Generator().manual_seed(b)
    nodes, u = tmh.make_round_randoms(gen, rounds, b, n)
    acc2 = tmh.make_round_accepts(nodes, u, probs)
    nodes_p, acc2_p = tmh.bulk_rows(nodes), tmh.bulk_rows(acc2)
    bp = -(-b // 4) * 4
    assert nodes_p.shape == acc2_p.shape == (rounds, bp) and acc2_p.dtype == torch.int32
    assert nodes_p.data_ptr() % 16 == 0 and acc2_p.data_ptr() % 16 == 0
    assert torch.equal(nodes_p[:, :b], nodes) and torch.equal(acc2_p[:, :b], acc2)
    # whatever the extra columns hold (here proposals that always flip), the
    # chains of the padded rows, run by the plain version, are unchanged
    nodes_p[:, b:] = torch.randint(0, n, (rounds, bp - b), generator=gen, dtype=torch.int32)
    acc2_p[:, b:] = 3
    bits = torch.from_numpy(rng.random((b, n)) < 0.5)
    extra = torch.from_numpy(rng.random((bp - b, n)) < 0.5)
    padded = tmh.mh_sample_packed(nodes_p, acc2_p, torch.cat([bits, extra]))
    assert torch.equal(padded[:b], tmh.mh_sample_packed(nodes, acc2, bits))
    assert not torch.equal(padded[b:], extra)


def test_k12_rows_not_16_byte_aligned_are_copied():
    base = torch.arange(4 + 3 * 8, dtype=torch.int32)
    acc2 = base[1 : 1 + 3 * 8].view(3, 8)  # B % 4 == 0, but 4 bytes past an aligned start
    assert acc2.data_ptr() % 16 == 4
    rows = tmh.bulk_rows(acc2)
    assert rows is not acc2 and rows.data_ptr() % 16 == 0 and torch.equal(rows, acc2)
