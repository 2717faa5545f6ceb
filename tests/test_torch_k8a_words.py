"""Port parity: the word entries that K8a reads. `WeightedAdjPlanes.word_entries`
lists each row's non-zero (plane, word) pairs of the signed bit-planes,
ordered by (word, plane); expanded back they are the JAX package's
`WeightedAdjPlanes` planes word for word. The kernel's arithmetic, emulated
here per node (each entry's signed plane weight times the popcount of the
chain's word under its mask, summed over the row, then the flip rule), equals the
Pallas kernel in interpret mode and the port's sequential plain sweep, on
signed and unsigned weights of 1 to 4 planes, sparse and dense graphs and
rows with no entry. All sums are integers: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.ops.pallas import weighted_sweep as jwsw
from rlsolver_tpu_torch.core.generate import build_weighted_gnm
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import codec, engine
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw

torch.set_num_threads(1)


def _random_edges(n, seed, w_max, signed, density, nodes=None):
    """Each pair among the first `nodes` nodes (all when None) is an edge
    with probability `density`; weights in [1, w_max], 40% negative if
    signed."""
    rng = np.random.default_rng(seed)
    m = n if nodes is None else nodes
    a, b = np.triu_indices(m, k=1)
    keep = rng.random(a.size) < density
    w = rng.integers(1, w_max + 1, size=int(keep.sum()))
    if signed:
        w = np.where(rng.random(w.size) < 0.4, -w, w)
    return [(int(x), int(y), float(z)) for x, y, z in zip(a[keep], b[keep], w)]


# name: (N, edges); k = bit_length(w_max): 1 to 4 planes
GRAPHS = {
    "k1u_sparse": (70, _random_edges(70, 1, 1, False, 0.06)),
    "k1s_dense": (45, _random_edges(45, 2, 1, True, 0.6)),
    "k2u_dense": (96, _random_edges(96, 3, 3, False, 0.5)),
    "k2s_sparse": (100, _random_edges(100, 4, 3, True, 0.04)),
    "k3s_dense": (64, _random_edges(64, 5, 7, True, 0.3)),
    "k3u_complete": (33, _random_edges(33, 6, 7, False, 1.0)),
    "k4s_isolated": (90, _random_edges(90, 7, 15, True, 0.1, nodes=61)),  # rows 61..89 are empty
    "k4u_sparse": (128, _random_edges(128, 8, 15, False, 0.05)),
}


def _graphs(name):
    n, e = GRAPHS[name]
    return JGraph.from_edge_list(n, e, name=name), Graph.from_edge_list(n, e, name=name)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    jg, tg = _graphs(request.param)
    return request.param, jg, tg, twsw.WeightedAdjPlanes.build(tg, "cpu")


def _plane_of(adj, coef):
    """The plane index of each entry's signed weight: +2^p -> p, -2^p -> k + p."""
    mag = np.abs(coef)
    return np.log2(mag).astype(np.int64) + np.where(coef < 0, adj.k, 0)


def _expand(adj):
    """The word entries (not the empty one after them) expanded back to
    planes [P, N, W] int32."""
    n, w = adj.num_nodes, codec.num_words(adj.num_nodes)
    off = adj.word_offsets.numpy().astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(off))
    head, mask = adj.word_entries[:-1, 0].numpy(), adj.word_entries[:-1, 1].numpy()
    planes = np.zeros((adj.k * (2 if adj.signed else 1), n, w), np.int32)
    planes[_plane_of(adj, head >> 16), rows, head & 0xFFFF] = mask
    return planes


def _by_words(x, adj):
    """K8a's arithmetic in its order: for node i, the sum over row i's word
    entries of plane weight x popcount(chain word & mask), then the flip
    when wdeg - 2 cut > 0."""
    words = codec.pack_bits(x).numpy().view(np.uint32).copy()
    off = adj.word_offsets.tolist()
    head = adj.word_entries[:, 0].numpy()
    mask = adj.word_entries[:, 1].numpy().view(np.uint32)
    wdeg = adj.wdeg.numpy().astype(np.int64)
    for i in range(adj.num_nodes):
        s, e = off[i], off[i + 1]
        pc = np.bitwise_count(words[:, head[s:e] & 0xFFFF] & mask[s:e]).astype(np.int64)
        p = pc @ (head[s:e] >> 16).astype(np.int64)
        cur = (words[:, i >> 5] >> np.uint32(i & 31)) & np.uint32(1) == 1
        cut = np.where(cur, wdeg[i] - p, p)
        words[:, i >> 5] ^= np.where(wdeg[i] - 2 * cut > 0, np.uint32(1 << (i & 31)), np.uint32(0))
    return codec.unpack_bits(torch.from_numpy(words.view(np.int32)), adj.num_nodes)


def test_word_entries_expand_to_the_jax_planes(case):
    name, jg, tg, adj = case
    w = codec.num_words(tg.num_nodes)
    ja = jwsw.WeightedAdjPlanes.build(jg)
    jplanes = np.stack([np.asarray(p)[:, :w] for p in (*ja.planes_pos, *ja.planes_neg)])
    assert adj.k == len(ja.planes_pos) == int(np.abs(tg.weights).max()).bit_length()
    assert adj.signed == bool(ja.planes_neg)
    np.testing.assert_array_equal(_expand(adj), jplanes)
    np.testing.assert_array_equal(adj.planes.numpy(), jplanes)


def test_word_entries_are_the_nonzero_words_in_order(case):
    name, _, tg, adj = case
    off = adj.word_offsets.numpy().astype(np.int64)
    assert off[0] == 0 and np.all(np.diff(off) >= 0) and off[-1] == adj.word_entries.shape[0] - 1
    assert adj.word_entries[-1].tolist() == [0, 0]  # the empty entry after the last row's
    head, mask = adj.word_entries[:-1, 0].numpy(), adj.word_entries[:-1, 1].numpy()
    assert np.all(mask != 0)
    assert int(np.count_nonzero(adj.planes.numpy())) == off[-1]
    plane = _plane_of(adj, head >> 16)
    assert np.all(np.abs(head >> 16) == 1 << np.where(plane < adj.k, plane, plane - adj.k))
    for i in range(tg.num_nodes):
        key = (head[off[i] : off[i + 1]] & 0xFFFF) * 64 + plane[off[i] : off[i + 1]]
        assert np.all(np.diff(key) > 0)  # by (word, plane), each pair once
    # the engine's count of the entries, from the edge list alone
    assert twsw.word_entry_bytes(tg) == adj.word_entries.numel() * 4 + adj.word_offsets.numel() * 4
    if name == "k4s_isolated":
        assert np.all(np.diff(off)[61:] == 0)


def test_word_sweep_equals_the_sequential_sweep_and_jax(case):
    name, jg, tg, adj = case
    n, b = tg.num_nodes, 16
    bits = np.random.default_rng(len(name)).random((b, n)) < 0.5
    x = torch.from_numpy(bits)
    seq = twsw._sweep_1flip_plain(x, adj)
    assert torch.equal(_by_words(x, adj), seq)
    assert not torch.equal(seq, x)  # the sweep flipped something
    assert torch.equal(twsw.sweep_1flip_weighted(x, adj), seq)
    pallas = jwsw.sweep_1flip_weighted(jnp.asarray(bits), jwsw.WeightedAdjPlanes.build(jg), block_chains=b,
                                       interpret=True)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(pallas))


def test_an_empty_graph_row_keeps_its_bits():
    """Rows with no entry read no word and never flip a node with no weight."""
    g = Graph.from_edge_list(40, [(3, 7, 5.0), (7, 9, -2.0)], "pair")
    adj = twsw.WeightedAdjPlanes.build(g, "cpu")
    assert adj.word_offsets.tolist()[:4] == [0, 0, 0, 0] and adj.word_entries.shape[0] == 2 + 3 + 1 + 1
    x = torch.from_numpy(np.random.default_rng(1).random((8, 40)) < 0.5)
    out = _by_words(x, adj)
    assert torch.equal(out, twsw._sweep_1flip_plain(x, adj))
    untouched = [i for i in range(40) if i not in (3, 7, 9)]
    assert torch.equal(out[:, untouched], x[:, untouched])


# neighbours a node on average -> K8b (levels) below 80, K8a from 80: where
# scripts/torch_engine_share.py measured K8a the faster at 768 and at 2048
# chains on the H100
@pytest.mark.parametrize("neighbours, levels", [(2, True), (20, True), (60, True), (78, True), (80, False),
                                                (100, False), (180, False)])
def test_plan_1flip_takes_k8a_on_dense_rows(neighbours, levels):
    g = build_weighted_gnm(200, neighbours * 100, neighbours, f"W200x{neighbours}")
    assert 2 * g.num_edges / g.num_nodes == neighbours
    assert engine.plan_1flip(g, engine.H100_L2_BYTES) == engine.FlipPlan(weighted=True, levels=levels)
    eng = engine.FlipSweepEngine.build(g, "cpu")
    x = torch.from_numpy(np.random.default_rng(neighbours).random((4, 200)) < 0.5)
    assert eng.levels == levels and torch.equal(eng.sweep(x), twsw._sweep_1flip_plain(x, eng.tables))


def test_plan_1flip_keeps_k5_on_unit_weights_and_refuses_fractions():
    # K5 on sparse unit rows (a ring of 80 nodes); the complete unit graph on
    # 80 nodes (79 neighbours a node, from K5_MAX_NEIGHBOURS = 60) takes K8a
    ring = Graph(80, np.stack([np.arange(79), np.arange(1, 80)], 1).astype(np.int32), np.ones(79, np.float32), "P80")
    assert engine.plan_1flip(ring, engine.H100_L2_BYTES) == (False, False)
    a, b = np.triu_indices(80, k=1)
    unit = Graph(80, np.stack([a, b], 1).astype(np.int32), np.ones(a.size, np.float32), "K80")
    assert engine.plan_1flip(unit, engine.H100_L2_BYTES) == (True, False)
    half = Graph(80, np.stack([a, b], 1).astype(np.int32), np.full(a.size, 0.5, np.float32), "K80half")
    with pytest.raises(ValueError, match="integer"):
        engine.plan_1flip(half, engine.H100_L2_BYTES)
