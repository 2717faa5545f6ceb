"""Port parity: the signed level lists that K5 reads (`LevelLists`). Their
2-byte entries decode back to the graph's {0, +-1} adjacency, and so do
JAX's packed rows, which the plain version reads from the lists; the
schedule holds every node with a neighbour once, none without, and puts
every earlier neighbour of a node in a lower level, so no level holds an
edge. Visiting the table level by level (emulated here in plain torch, each
level's nodes at once) equals the sequential plain sweep
`_sweep_1flip_plain` and the Pallas kernel in interpret mode, bit for bit.
K5 takes at most 2^15 nodes. `plan_1flip` sends sparse unit graphs whose
table fits a block's shared memory to K5, dense ones to K8a and the rest to
K8b, from sizes alone; K11's
wrapper pads streams whose rows K11 cannot copy in bulk. All sums are
integers: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu_torch.core.generate import build_d2000_like, build_g22_like, gnm_edges
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import build, engine
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as tsw
from rlsolver_tpu_torch.ops.kernels import mh_sampler as tmh

torch.set_num_threads(1)


def _random_edges(n, seed, signed, per_node=4, nodes=None):
    """Each of the first `nodes` nodes (all when None) draws `per_node`
    partners among them; weight -1 with probability 0.4 when signed."""
    rng = np.random.default_rng(seed)
    m = n if nodes is None else nodes
    edges = {}
    for i in range(m):
        for j in rng.choice(m, size=per_node, replace=False):
            if i != j:
                edges[(min(i, int(j)), max(i, int(j)))] = -1.0 if signed and rng.random() < 0.4 else 1.0
    return [(a, b, w) for (a, b), w in sorted(edges.items())]


def _hub_edges(n, seed):
    """Node 0 joined to 50 others, random +-1 edges among nodes 1..64, and
    nodes 65..n-1 isolated."""
    rng = np.random.default_rng(seed)
    hub = [(0, int(j), 1.0 if rng.random() < 0.5 else -1.0) for j in rng.choice(np.arange(1, 65), 50, replace=False)]
    rest = [(a, b, w) for a, b, w in _random_edges(64, seed + 1, True, per_node=2) if a > 0]
    return sorted({(a, b): w for a, b, w in hub + rest}.items())


GRAPHS = {
    "unit72": (72, _random_edges(72, 3, False)),
    "pm1x96": (96, _random_edges(96, 4, True)),
    "dense_pm1x40": (40, _random_edges(40, 5, True, per_node=30)),
    "hub80": (80, [(a, b, w) for (a, b), w in _hub_edges(80, 6)]),
    "path150": (150, [(i, i + 1, 1.0) for i in range(149)]),
    "path_pm1x70": (70, [(i, i + 1, -1.0 if i % 3 == 0 else 1.0) for i in range(69)]),
    "no_edges": (40, []),
}


def _graphs(name):
    n, e = GRAPHS[name]
    return JGraph.from_edge_list(n, e, name=name), Graph.from_edge_list(n, e, name=name)


def _decode(lv):
    """(level of each position [V], node [V], wdeg [V], rows, cols, signs):
    the table read back, one (row, col, sign) per list entry."""
    lo = lv.level_offsets.long()
    rec = lv.records
    node, wdeg, starts = (rec[:-1, 1] & 0xFFFF).long(), (rec[:-1, 1] >> 16).long(), rec[:, 0].long()
    ent = lv.entries.long()
    cols, signs = ent & 0x7FFF, 1 - 2 * ((ent >> 15) & 1)
    lens = starts[1:] - starts[:-1]
    level = torch.repeat_interleave(torch.arange(lv.depth), lo[1:] - lo[:-1])
    return level, node, wdeg, torch.repeat_interleave(node, lens), cols, signs


def _walk(x, lv):
    """The level-by-level sweep over the table, each level's nodes at once:
    P = sum_j +-x_j over their lists, a flip where wdeg - 2 cut > 0."""
    x = x.clone()
    _, node, wdeg, _, cols, signs = _decode(lv)
    starts = lv.records[:, 0].long()
    lo = lv.level_offsets.tolist()
    for d in range(lv.depth):
        pos = torch.arange(lo[d], lo[d + 1])
        cnt = starts[pos + 1] - starts[pos]
        slot = torch.repeat_interleave(torch.arange(pos.numel()), cnt)
        e = starts[pos][slot] + torch.arange(int(cnt.sum())) - (torch.cumsum(cnt, 0) - cnt)[slot]
        p = torch.zeros(x.shape[0], pos.numel(), dtype=torch.int64).index_add_(1, slot, x[:, cols[e]].long() * signs[e])
        nodes = node[pos]
        cur = x[:, nodes]
        cut = torch.where(cur, wdeg[pos] - p, p)
        x[:, nodes] = cur ^ (wdeg[pos] - 2 * cut > 0)
    return x


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_entries_decode_to_the_adjacency(name):
    _, g = _graphs(name)
    lv = tsw.LevelLists.build(g, "cpu")
    assert lv.entries.element_size() == 2 and lv.num_nodes == g.num_nodes
    assert lv.table_bytes % 16 == 0 and lv.table.numel() * 4 == lv.table_bytes
    _, node, wdeg, rows, cols, signs = _decode(lv)
    adj = torch.from_numpy(g.adjacency_dense()).long()
    got = torch.zeros_like(adj)
    got[rows, cols] = signs
    assert torch.equal(got, adj)
    assert rows.numel() == 2 * g.num_edges == lv.num_entries
    # each list ascends, and every list is where its record says
    starts = lv.records[:, 0].long()
    assert starts[0] == 0 and starts[-1] == lv.num_entries and bool((starts[1:] >= starts[:-1]).all())
    for v in range(lv.positions):
        assert bool((cols[starts[v] + 1 : starts[v + 1]] > cols[starts[v] : starts[v + 1] - 1]).all())
    assert torch.equal(wdeg, adj[node].sum(dim=1))
    assert int(lv.records[-1, 1]) == 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_schedule_holds_no_edge_in_a_level(name):
    _, g = _graphs(name)
    lv = tsw.LevelLists.build(g, "cpu")
    level, node, _, _, _, _ = _decode(lv)
    has_nbr = np.zeros(g.num_nodes, bool)
    has_nbr[g.edges.reshape(-1)] = True
    # the nodes with a neighbour, once each, by (level, id); no other node
    np.testing.assert_array_equal(np.sort(node.numpy()), np.flatnonzero(has_nbr))
    assert lv.positions == int(has_nbr.sum()) and lv.depth == (0 if lv.positions == 0 else int(level.max()) + 1)
    key = level * g.num_nodes + node
    assert bool((key[1:] > key[:-1]).all())
    lo = lv.level_offsets.long()
    assert lo[0] == 0 and lo[-1] == lv.positions and bool((lo[1:] > lo[:-1]).all())
    # every earlier neighbour is in a lower level, and each level is the least
    lvl = np.full(g.num_nodes, -1)
    lvl[node.numpy()] = level.numpy()
    a, b = g.edges[:, 0], g.edges[:, 1]
    assert np.all(lvl[a] < lvl[b])
    least = np.zeros(g.num_nodes, np.int64)
    np.maximum.at(least, b, lvl[a] + 1)
    np.testing.assert_array_equal(lvl[has_nbr], least[has_nbr])
    if name.startswith("path"):
        assert lv.depth == g.num_nodes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_level_walk_equals_the_sequential_sweep_and_jax(name, seed):
    jg, g = _graphs(name)
    adj = tsw.pack_adjacency(g, "cpu")
    bits = np.random.default_rng(seed).random((32, g.num_nodes)) < 0.5
    x = torch.from_numpy(bits)
    walk = _walk(x, adj.levels)
    assert torch.equal(walk, tsw._sweep_1flip_plain(x, adj))
    assert torch.equal(walk, tsw.sweep_1flip_packed(x, adj))
    pallas = jsw.sweep_1flip_packed(jnp.asarray(bits), jsw.pack_adjacency(jg), block_chains=32, interpret=True)
    np.testing.assert_array_equal(walk.numpy(), np.asarray(pallas))
    if g.num_edges:
        assert (walk != x).any()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_planes_decode_from_the_lists(name):
    """K5's tables hold only the lists; the packed rows and per-row counts
    that the plain version reads, decoded from them, are JAX's."""
    jg, g = _graphs(name)
    adj = tsw.pack_adjacency(g, "cpu")
    assert tsw.PackedAdjacency._fields == ("levels",)
    w = (g.num_nodes + 31) // 32
    j_pos, j_neg = jsw.pack_adjacency(jg)
    np.testing.assert_array_equal(adj.pos.numpy(), np.asarray(j_pos)[:, :w])
    assert adj.signed == (j_neg is not None) == (adj.neg is not None) == (adj.deg_neg is not None)
    dense = g.adjacency_dense()
    np.testing.assert_array_equal(adj.deg_pos.numpy(), (dense > 0).sum(axis=1))
    if j_neg is not None:
        np.testing.assert_array_equal(adj.neg.numpy(), np.asarray(j_neg)[:, :w])
        np.testing.assert_array_equal(adj.deg_neg.numpy(), (dense < 0).sum(axis=1))


@pytest.mark.parametrize("n", [1 << 15, (1 << 15) + 1])
def test_k5_takes_at_most_2_to_the_15_nodes(n):
    """Up to 2^15 nodes every id and sign fits a 2-byte entry; beyond, the
    table is refused and the rule sends the graph to the weighted kernels."""
    rng = np.random.default_rng(9)
    ends = rng.choice(n, size=(200, 2))
    ends = ends[ends[:, 0] != ends[:, 1]]
    pairs = sorted({(int(min(a, b)), int(max(a, b))) for a, b in ends})
    e = [(a, b, -1.0 if (a + b) % 2 else 1.0) for a, b in pairs] + [(n - 3, n - 1, -1.0), (n - 2, n - 1, 1.0)]
    g = Graph.from_edge_list(n, e, f"U{n}")
    plan = engine.plan_1flip(g, engine.H100_L2_BYTES)
    if n > tsw.K5_MAX_NODES:
        with pytest.raises(ValueError, match="below"):
            tsw.LevelLists.build(g, "cpu")
        assert not engine.k5_fits(g) and plan == engine.FlipPlan(weighted=True, levels=True)
        return
    lv = tsw.LevelLists.build(g, "cpu")
    _, node, wdeg, rows, cols, signs = _decode(lv)
    got = {(int(r), int(c)): int(s) for r, c, s in zip(rows, cols, signs)}
    want = {}
    for a, b, w in e:
        want[(a, b)] = want[(b, a)] = int(w)
    assert got == want
    assert int(node.max()) == n - 1 == int(cols.max()) and bool((wdeg.abs() <= 3).all())
    assert engine.k5_fits(g) and plan == engine.FlipPlan(weighted=False, levels=False)


def test_level_table_bytes_bound_the_table():
    for name in sorted(GRAPHS):
        _, g = _graphs(name)
        assert tsw.LevelLists.build(g, "cpu").table_bytes <= tsw.level_table_bytes(g)
    g22 = build_g22_like()
    lv = tsw.LevelLists.build(g22, "cpu")
    # 47 levels, 2000 records of 8 bytes, 39,980 entries of 2 bytes
    assert (lv.depth, lv.positions, lv.num_entries) == (47, 2000, 39980)
    assert lv.table_bytes == 96_160 and tsw.level_table_bytes(g22) == 103_984
    # a block of eight chains and the table leave two blocks an SM
    assert 2 * (tsw.level_smem_bytes(lv.table_bytes, 2000) + 7 * 64 * 4 + engine.H100_SMEM_RESERVED_PER_BLOCK) \
        <= engine.H100_SMEM_PER_SM


def _unit(n, m, seed, name):
    e = np.sort(np.asarray(gnm_edges(n, m, seed=seed), np.int32).reshape(-1, 2), axis=1)
    return Graph(n, e, np.ones(e.shape[0], np.float32), name)


def test_plan_1flip_on_unit_graphs():
    """From sizes alone: G22-like (and its +-1 form) K5; the D2000-like
    topology with unit weights K8a (200 neighbours a node; its table of
    about 800 KB does not fit either); 20,000 nodes of 4 neighbours K8b (a
    sparse graph whose table does not fit)."""
    l2 = engine.H100_L2_BYTES
    g22 = build_g22_like()
    assert engine.k5_fits(g22) and engine.plan_1flip(g22, l2) == engine.FlipPlan(weighted=False, levels=False)
    pm = Graph(g22.num_nodes, g22.edges, np.where(np.arange(g22.num_edges) % 3, 1.0, -1.0).astype(np.float32), "pm")
    assert engine.plan_1flip(pm, l2) == (False, False)
    d = build_d2000_like()
    d_unit = Graph(d.num_nodes, d.edges, np.ones(d.num_edges, np.float32), "D2000unit")
    assert not engine.k5_fits(d_unit)
    assert engine.plan_1flip(d_unit, l2) == engine.FlipPlan(weighted=True, levels=False)
    sparse = _unit(20000, 40000, 3, "U20000")
    assert not engine.k5_fits(sparse) and sw_bytes(sparse) > build.header_constant("kMaxSmem")
    assert engine.plan_1flip(sparse, l2) == engine.FlipPlan(weighted=True, levels=True)


def sw_bytes(g):
    return tsw.level_smem_bytes(tsw.level_table_bytes(g), g.num_nodes)


# (N, neighbours a node, kernel): K5 below K5_MAX_NEIGHBOURS while its table
# fits; K8a from K5_MAX_NEIGHBOURS up to K8A_SMALL_NODES nodes, from
# K8A_MIN_NEIGHBOURS beyond, K8b below
@pytest.mark.parametrize("n, neighbours, kernel", [(300, 10, "K5"), (300, 40, "K5"), (300, 100, "K8a"),
                                                   (600, 58, "K5"), (600, 60, "K8a"), (1000, 70, "K8a"),
                                                   (2000, 20, "K5"), (2000, 60, "K8b"), (2000, 70, "K8b"),
                                                   (2000, 80, "K8a"), (4000, 60, "K8b")])
def test_plan_1flip_takes_k5_on_sparse_rows_whose_table_fits(n, neighbours, kernel):
    g = _unit(n, n * neighbours // 2, n + neighbours, f"U{n}x{neighbours}")
    assert 2 * g.num_edges == n * neighbours
    fits = sw_bytes(g) <= build.header_constant("kMaxSmem")
    assert engine.k5_fits(g) == fits == (n < 2000 or neighbours < 52)
    plans = {"K5": (False, False), "K8a": (True, False), "K8b": (True, True)}
    assert engine.plan_1flip(g, engine.H100_L2_BYTES) == plans[kernel]
    eng = engine.FlipSweepEngine.build(g, "cpu")
    x = torch.from_numpy(np.random.default_rng(n).random((4, n)) < 0.5)
    assert (eng.weighted, eng.levels) == plans[kernel]
    ref = tsw._sweep_1flip_plain(x, tsw.pack_adjacency(g, "cpu"))
    assert torch.equal(eng.sweep(x), ref)


@pytest.mark.parametrize("b", [8, 10, 13])
def test_k11_rows_are_padded_to_a_multiple_of_4(b):
    t = torch.arange(3 * b, dtype=torch.int32).view(3, b)
    rows = tmh.bulk_rows(t)
    assert rows.shape == (3, -(-b // 4) * 4) and torch.equal(rows[:, :b], t)
    assert (rows is t) == (b % 4 == 0)
