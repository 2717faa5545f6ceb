"""The yardstick's counts against hand-worked values, and the reference's
Philox against the generator's published known-answer vectors."""

import pytest
import torch

from benchmark import counts
from benchmark.reference import philox


def test_mh_sampler_work_by_hand():
    # 8 chains of 10 nodes, 4 rounds: a proposal is one draw (40 ops for 4
    # draws: 10) and one compare: 8 * 4 * 11 ops; 8 * 10 bytes in and out
    assert counts.mh_sampler_work(8, 10, 4) == (352, 160)
    # from 2^15 nodes a proposal takes two draws: 8 * 4 * 21
    assert counts.mh_sampler_work(8, 1 << 15, 4) == (672, 2 * 8 * (1 << 15))


def test_noisy_sweep_work_by_hand():
    # 4 chains, 5 nodes, 6 edges, 2 sweeps: 40 steps of 11 ops, plus the
    # neighbour adds 2 sweeps * 12 entries * 4 chains / 32 = 3
    assert counts.noisy_sweep_work(4, 5, 6, 2) == (443, 40)


def test_least_seconds_takes_the_larger_bound():
    rate = 132 * 64 * 1.98e9
    assert counts.least_seconds(rate, 0, 132) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12, 132) == pytest.approx(1.0)
    assert counts.least_seconds(rate, 2 * 3.35e12, 132) == pytest.approx(2.0)


def test_l2a_flops_by_hand():
    # 1 sim, 2 nodes, width 4 (one head's worth of arithmetic): per node the
    # dense layers 2*1 + 5*4 + 4*4 + 4*2 = 46 MACs and the value head
    # 4*4 + 4 = 20; each attention 4 projections of 2*4*4 MACs and 2*2*4
    # MACs twice (scores, weighted sum)
    dense = 2 * 2 * 46
    value = 2 * 2 * 20
    attention = 2 * (4 * 2 * 4 * 4 + 2 * 2 * 2 * 4) * 2
    assert counts.l2a_policy_forward_flops(1, 2, 4) == dense + value + attention
    assert counts.l2a_policy_forward_flops(1, 2, 4, value_head=False) == dense + attention
    fwd, bwd = dense + value + attention, 2 * (dense + attention)
    assert counts.l2a_iteration_flops(1, 2, 4, 3) == counts.l2a_encoder_forward_flops(2, 4) + 3 * (fwd + bwd)


def test_shares_stay_under_100_at_the_cells_shapes():
    # the least times at g22's shapes: far under what any call could take
    sweep = counts.least_seconds(*counts.noisy_sweep_work(1 << 20, 2000, 19990, 8), 132)
    mh = counts.least_seconds(*counts.mh_sampler_work(1 << 20, 2000, 400), 132)
    assert 0.005 < sweep < 0.02 and 0.001 < mh < 0.002


@pytest.mark.parametrize("ctr,key,out", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, out):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = philox.philox4x32(*c, key[0], key[1])
    assert tuple(int(x) for x in got) == out


def test_philox_draw_layout():
    # draw t of a chain is word t & 3 of the block at counter (t >> 2, chain)
    seeds, chains = torch.tensor([7, 9]), torch.tensor([3, 5])
    d = philox.draws(seeds, chains, philox.TAG_MH, 6)
    for i in range(2):
        z = torch.zeros(1, dtype=torch.int64)
        for t in range(6):
            words = philox.philox4x32(z + (t >> 2), z + int(chains[i]), z, z, int(seeds[i]), philox.TAG_MH)
            assert int(d[t, i]) == int(words[t & 3])
