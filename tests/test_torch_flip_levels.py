"""Port parity: the neighbour lists and the level schedule that K8b reads.
The natural-order lists of `WeightedAdjPlanes` hold every edge of the graph
once in each direction and expand back to exactly the JAX package's signed
bit-planes (and the port's, which K8a reads); the schedule holds every node
once, puts every earlier neighbour of a node in a lower level (so no level
holds an edge) and gives each node the least such level. Visiting the nodes
level by level (emulated here, vectorised per level) equals the sequential
plain sweep, which equals the Pallas kernels in interpret mode, in place
and node-chunked, on the graphs of a few hundred nodes. W70-like (10,000
nodes) runs a few chains through the CPU plain versions only. All sums are
integers: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.ops.pallas import weighted_sweep as jwsw
from rlsolver_tpu_torch.core.generate import build_w22_like, build_w70_like
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import codec, engine
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw

torch.set_num_threads(1)
W15 = (1 << 15) - 1  # the largest weight the kernels take: 15 planes


def _edges(n, seed, w_max, signed, nodes=None, per_node=4):
    """Random edges among the first `nodes` nodes (all when None): each
    draws `per_node` partners; weights in [1, w_max], 40% negative if signed."""
    rng = np.random.default_rng(seed)
    m = n if nodes is None else nodes
    edges = {}
    for i in range(m):
        for j in rng.choice(m, size=per_node, replace=False):
            if i < j:
                w = int(rng.integers(1, w_max + 1))
                edges[(i, int(j))] = -w if signed and rng.random() < 0.4 else w
    return [(a, b, float(w)) for (a, b), w in sorted(edges.items())]


def _path_edges(n, seed):
    """0 - 1 - ... - (n-1), weights in +-{1..7}: node i's level is i."""
    rng = np.random.default_rng(seed)
    return [(i, i + 1, float(rng.integers(1, 8) * rng.choice((-1, 1)))) for i in range(n - 1)]


def _star_edges(n, seed):
    """Node 0 joined to every other node, plus a sparse ring of weights."""
    rng = np.random.default_rng(seed)
    edges = [(0, j, float(rng.integers(1, 4))) for j in range(1, n)]
    return edges + [(j, j + 1, -float(rng.integers(1, 4))) for j in range(1, n - 1, 3)]


# name: (N, edges, depth or None); the JAX package's test shapes first
SMALL = {
    "N72w5s": (72, _edges(72, 3, 5, True), None),
    "N40w6u": (40, _edges(40, 7, 6, False), None),
    "N96w4s": (96, _edges(96, 21, 4, True), None),
    "N64w3u": (64, _edges(64, 23, 3, False), None),
    "N45": (45, _edges(45, 32, 6, True), None),
    "isolated": (70, _edges(70, 31, 5, True, nodes=52), None),  # nodes 52..69 have no edge
    "k15s": (48, _edges(48, 33, W15, True), None),
    "k15u": (33, _edges(33, 34, W15, False, per_node=3), None),
    "star": (64, _star_edges(64, 35), None),
    "path200": (200, _path_edges(200, 36), 200),
}


def _small(name):
    n, e, _ = SMALL[name]
    return JGraph.from_edge_list(n, e, name=name), Graph.from_edge_list(n, e, name=name)


@pytest.fixture(scope="module", params=sorted(SMALL))
def small(request):
    jg, tg = _small(request.param)
    return request.param, jg, tg, twsw.WeightedAdjPlanes.build(tg, "cpu")


@pytest.fixture(scope="module")
def w70():
    g = build_w70_like()
    return g, twsw.WeightedAdjPlanes.build(g, "cpu")


def _lists(adj):
    """(rows, cols, weights) of the lists, int64."""
    off = adj.offsets.numpy().astype(np.int64)
    rows = np.repeat(np.arange(off.shape[0] - 1), np.diff(off))
    return rows, adj.entries[:, 0].numpy().astype(np.int64), adj.entries[:, 1].numpy().astype(np.int64)


def _check_lists_hold_the_edges(g, adj):
    off = adj.offsets.numpy().astype(np.int64)
    assert off[0] == 0 and np.all(np.diff(off) >= 0) and off[-1] == adj.entries.shape[0]
    rows, cols, w = _lists(adj)
    a, b = g.edges[:, 0].astype(np.int64), g.edges[:, 1].astype(np.int64)
    ew = np.rint(g.weights).astype(np.int64)
    key = np.concatenate([a * g.num_nodes + b, b * g.num_nodes + a])
    order = np.argsort(key)  # by node, then ascending neighbour
    np.testing.assert_array_equal(rows * g.num_nodes + cols, key[order])
    np.testing.assert_array_equal(w, np.concatenate([ew, ew])[order])
    wdeg = np.zeros(g.num_nodes, np.int64)
    np.add.at(wdeg, rows, w)
    np.testing.assert_array_equal(adj.wdeg.numpy(), wdeg)


def _check_schedule(g, adj, depth=None):
    n = g.num_nodes
    ln, lo = adj.level_nodes.numpy().astype(np.int64), adj.level_offsets.numpy().astype(np.int64)
    assert adj.depth == lo.shape[0] - 1 and (depth is None or adj.depth == depth)
    # every node appears once; levels are non-empty runs, ascending ids in each
    np.testing.assert_array_equal(np.sort(ln), np.arange(n))
    assert lo[0] == 0 and lo[-1] == n and np.all(np.diff(lo) > 0)
    level = np.empty(n, np.int64)
    for d in range(adj.depth):
        assert np.all(np.diff(ln[lo[d] : lo[d + 1]]) > 0)
        level[ln[lo[d] : lo[d + 1]]] = d
    # every earlier neighbour is in a lower level, so no level holds an edge
    a, b = g.edges[:, 0].astype(np.int64), g.edges[:, 1].astype(np.int64)
    assert np.all(level[a] < level[b])
    # and each node's level is the least: 1 + its earlier neighbours' highest
    least = np.zeros(n, np.int64)
    np.maximum.at(least, b, level[a] + 1)
    np.testing.assert_array_equal(level, least)


def _by_levels(x, adj):
    """The level-by-level sweep, each level's nodes at once: P = sum_j w_ij x_j
    over their lists, a flip where wdeg - 2 cut > 0."""
    x = x.clone()
    off = adj.offsets.long()
    j, w, wdeg = adj.entries[:, 0].long(), adj.entries[:, 1].long(), adj.wdeg.long()
    lo = adj.level_offsets.tolist()
    for d in range(adj.depth):
        nodes = adj.level_nodes[lo[d] : lo[d + 1]].long()
        cnt = off[nodes + 1] - off[nodes]
        slot = torch.repeat_interleave(torch.arange(nodes.numel()), cnt)  # entry -> node of the level
        first = torch.cumsum(cnt, 0) - cnt
        e = off[nodes][slot] + torch.arange(int(cnt.sum())) - first[slot]
        p = torch.zeros(x.shape[0], nodes.numel(), dtype=torch.int64).index_add_(1, slot, x[:, j[e]].long() * w[e])
        cur = x[:, nodes]
        cut = torch.where(cur, wdeg[nodes] - p, p)
        x[:, nodes] = cur ^ (wdeg[nodes] - 2 * cut > 0)
    return x


def test_lists_expand_to_the_jax_planes(small):
    name, jg, tg, adj = small
    n, w = tg.num_nodes, codec.num_words(tg.num_nodes)
    _check_lists_hold_the_edges(tg, adj)
    rows, cols, wts = _lists(adj)
    a = np.zeros((n, n), np.int64)
    a[rows, cols] = wts
    ja = jwsw.WeightedAdjPlanes.build(jg)
    k = int(np.abs(a).max()).bit_length()
    assert k == adj.k == len(ja.planes_pos) and adj.signed == bool(ja.planes_neg) == bool((a < 0).any())
    for sign, jplanes, planes in ((1, ja.planes_pos, adj.planes_pos), (-1, ja.planes_neg, adj.planes_neg)):
        assert len(jplanes) == len(planes)
        for b, q, p in zip(range(k), jplanes, planes):
            bits = (np.sign(a) == sign) & (((np.abs(a) >> b) & 1) == 1)
            np.testing.assert_array_equal(codec.pack_bits(torch.from_numpy(bits)).numpy(), np.asarray(q)[:, :w])
            np.testing.assert_array_equal(p.numpy(), np.asarray(q)[:, :w])  # the planes K8a reads
    np.testing.assert_array_equal(a, np.rint(jg.adjacency_dense()).astype(np.int64))


def test_schedule_is_valid(small):
    name, _, tg, adj = small
    _check_schedule(tg, adj, SMALL[name][2])


def test_level_sweep_equals_the_sequential_sweep_and_jax(small):
    name, jg, tg, adj = small
    n, b = tg.num_nodes, 16
    bits = np.random.default_rng(7).random((b, n)) < 0.5
    x = torch.from_numpy(bits)
    seq = twsw._sweep_1flip_plain(x, adj)
    assert torch.equal(_by_levels(x, adj), seq)
    assert torch.equal(twsw.sweep_1flip_weighted(x, adj, levels=True), seq)
    ja = jwsw.WeightedAdjPlanes.build(jg)
    for chunk in (None, 8) if n % 8 == 0 else (None,):
        pallas = jwsw.sweep_1flip_weighted(jnp.asarray(bits), ja, block_chains=b, node_chunk=chunk, interpret=True)
        np.testing.assert_array_equal(seq.numpy(), np.asarray(pallas))


def test_w22_like_schedule_and_level_sweep():
    g = build_w22_like()
    adj = twsw.WeightedAdjPlanes.build(g, "cpu")
    _check_lists_hold_the_edges(g, adj)
    _check_schedule(g, adj, 47)  # the G22-like topology: 47 levels over 2000 nodes
    x = torch.from_numpy(np.random.default_rng(8).random((4, g.num_nodes)) < 0.5)
    assert torch.equal(_by_levels(x, adj), twsw._sweep_1flip_plain(x, adj))


def test_w70_like_lists_and_schedule(w70):
    g, adj = w70
    _check_lists_hold_the_edges(g, adj)
    _check_schedule(g, adj, 8)  # 10,000 dependent steps become 8 levels
    assert adj.planes.shape == (6, 10000, 313) and adj.k == 3 and adj.signed


def test_w70_like_level_sweep_equals_the_sequential_sweep(w70):
    g, adj = w70
    x = torch.from_numpy(np.random.default_rng(9).random((3, g.num_nodes)) < 0.5)
    seq = twsw._sweep_1flip_plain(x, adj)
    assert torch.equal(_by_levels(x, adj), seq)
    assert not torch.equal(seq, x)  # the sweep flipped something
    # the engine takes K8b there; on the CPU its wrapper runs the plain sweep
    eng = engine.FlipSweepEngine(adj, True, engine.plan_1flip(g, engine.H100_L2_BYTES).levels)
    assert eng.levels and torch.equal(eng.sweep(x), seq)


def test_a_graph_of_isolated_nodes_has_one_level():
    g = Graph.from_edge_list(40, [(3, 7, 2.0)], "pair")
    adj = twsw.WeightedAdjPlanes.build(g, "cpu")
    _check_schedule(g, adj, 2)
    assert adj.level_offsets.tolist() == [0, 39, 40] and int(adj.level_nodes[-1]) == 7
